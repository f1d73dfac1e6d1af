// Fused three-block EADMM for MPCT on NVIDIA Hopper (sm_90a), written by
// hand, on the product stage csrc/tile_product.cuh.
//
// Replaces the Pallas TPU kernel
// spcies_tpu/kernels/fused_eadmm.py::_fused_eadmm_kernel. It computes what
// that kernel computes, mode for mode (checked, free-run, exact-k with
// window replay): for every lane of the batch, in the padded lane layout of
// Z columns, the whole EADMM loop
//
//     s_ht = rht (mt z2b - x0b) + lht
//     q1   = -(rm (z2b + z3) + lm) + (mh - mt) s_ht
//     z1   = clip(-q1 h1i, lb, ub)
//     v2m  = rm (z3 - z1) + lm ;  v2t = mt (rht (-z1) + lht)
//     z2bn = z2acc + (v2m - v2m_p) @ C2m + (v2t - v2t_p) @ C2t
//     q3   = rm (z2bn - z1) + lm
//     z3n  = z3acc + (q3 - q3_p) @ M3p
//     midR = z2bn + z3n - z1 ;  htR = mh z1 - x0b + mt (z2bn - z1)
//     lm  += rm midR ;  lht += rht htR
//     r_pf = max(|midR mr|, |htR|), r_z2 = max|(z2bn - z2b) mr|,
//     r_z3 = max|(z3n - z3) mr|
//
// until all three residuals meet tol or k_max. The wrapper and the plain
// PyTorch version of every mode are in kernels/fused_eadmm.py. The
// one-column-per-thread kernel this design replaced is
// csrc/variants/fused_eadmm_parent.cu (tools/ab_kernels.py holds every build
// to it, bit for bit).
//
// The z2 product over distinct columns. Many columns of C2m and C2t are
// copies of each other: C2m = A2mid W2BC and the tail rows of C2t are W2BC,
// W2BC = W2' tile(I_nm, (1, N+1)), so column j of both is column j % nm of
// z2's block (a product with a unit vector is exact) and the pad columns are
// zero. The wrapper finds the classes of columns that are equal in both
// matrices, byte for byte (kernels/fused_eadmm.py distinct_columns), and
// passes C2d = C2m[:, reps] and C2td = C2t[:, reps] ([Z][nd], nd classes: 9
// at the N=30 family) and col_of[j], the class of column j. The chain of a
// (lane, column) sum is the chain of its class's representative, so each is
// computed once and read by every copy: the parent's bits with nd / Z of its
// work. Arbitrary matrices give nd up to Z and the same result, slowly.
//
// Layout. A block of Z threads (one per column; a multiple of 32, at most
// 512) holds L = 8 or 16 lanes (kernels/fused_eadmm.py launch_plan; 32 do
// not fit shared memory). In shared memory: the nine state vectors z2b, z3,
// lm, lht, v2m_p, v2t_p, q3_p, z1 and x0b as [Z][L] (the swizzled layout of
// csrc/tile_product.cuh), the product input dv2m and then dq3 as [Z][L + 4],
// dv2t as [Z][L], the chains' results as [nd][L + 4] each, C2d's copy
// ([Z][nd], 16 lanes), the row maxima, and the ring of M3p's slabs. An
// iteration is
//   1. P1: thread j forms z1, v2m, v2t and the deltas of column j for the
//      L lanes, 8 at a time;                                 __syncthreads
//   2. the z2 chains: thread t < nd L takes class d = t / L, lane b = t % L:
//      a2 = dv2t[:, b] . C2td[:, d] over rows [t0, t1) and, apart,
//      a1 = dv2m[:, b] . C2d[:, d] over rows [0, nr), each one fmaf chain
//      in ascending row order. C2td's few rows are read by __ldg; the
//      16-lane build reads C2d from a copy in shared memory it makes once
//      (faster than by __ldg: PERF.md), the 8-lane build, whose two blocks
//      an SM have no room for the copy, by __ldg;
//                                                             __syncthreads
//   3. P2: thread j forms z2bn = (z2acc + a1[col_of[j]]) + a2[col_of[j]], q3
//      and dq3, and at a checked iteration the row maxima of |dz2|;
//   4. P3: z3n = z3acc + dq3 @ M3p on the product stage: a thread owns 8
//      lanes x TC columns (TC = 2 at 16 lanes, 1 at 8), M3p's rows [0, nr)
//      come through the ring of slabs filled by TMA (its first barrier
//      publishes dq3); each tile's owner then forms the residual rows and
//      the dual ascent of its cells and their maxima;        __syncthreads
//   5. at a checked iteration thread t < L (lane t's keeper: its k and
//      residuals) takes lane t's maxima and warp 0 publishes the lanes that
//      meet tol.                                              __syncthreads
// Groups of 8 lanes that are done are skipped, and in exact-k's windows the
// lanes still running are compacted into the first groups and the product's
// tiles narrow (tile_product.cuh). In plain free-run each group of 8 lanes
// freezes once its 8 lanes are done, as a tile of tile_b = 8 drains.
//
// Fresh lanes. A lane's first iteration takes z2refb and 0 as its
// accumulators; after it they equal z2b and z3 on every lane (the JAX kernel
// sets both from the same values), so the engine carries seven leaves and a
// mask of the slots whose next iteration is their lane's first: all slots at
// the start, and in the replay the lanes whose window starts at 0. The mask
// is 0 whenever lanes are compacted; a fresh lane reads z2refb at its own
// lane.
//
// Rows. v2t is exactly 0 outside the tail block (it is masked by mt), and
// the rows of C2m and M3p beyond the last real lane are 0 (the padding
// contract), so the chains read the rows t0..t1 of C2t where mt is nonzero
// and the rows below nr, one past the last lane where mr is nonzero, of C2m
// and M3p: adding zero terms changes no sum. Each block finds the three
// bounds from mt and mr before its loop.
//
// Exact-k snapshots. At each window start the seven leaves z2b, z3, lm, lht,
// v2m_p, v2t_p and q3_p of every lane not yet done go to global scratch
// (each thread writes, and later reads back, only its own column), and the
// window start to shared memory (tp::run_modes). The replay runs each lane's
// last window with the checked semantics and the budget min(C, k_max - kws).
//
// Arithmetic. fp32 on the CUDA cores, no TF32. The library is built with
// -fmad=false, so the element-wise steps round as PyTorch's separate
// operations do; every (lane, column) sum of a product is one explicit fmaf
// chain over the rows in ascending order, as in the parent, so every build
// gives the parent's bits. The row maxima are exact in any order.
//
// Padding. Pad columns carry zero rows and columns of C2m, C2t and M3p,
// zero rm, rht, mh, mt, mr and h1i and [0, 0] bounds, so they stay exactly
// 0 and add nothing to the row maxima.

#if !WIDE_PART
#include <cuda_runtime.h>

#include "tile_product.cuh"

// rows a slab of M3p's ring and blocks an SM (up to NARROW columns; one
// above) of each build (kernels/fused_eadmm.py BUILDS); a timing script may
// set others
#ifndef EA_SLAB_8
#define EA_SLAB_8 8
#endif
#ifndef EA_BLOCKS_8
#define EA_BLOCKS_8 2
#endif
#ifndef EA_SLAB_16
#define EA_SLAB_16 16
#endif
#ifndef EA_BLOCKS_16
#define EA_BLOCKS_16 1
#endif
// 1: a build copies C2d's rows [0, nr) to shared memory once a block, and
// the z2 chains read them there; 0: the chains read C2d by __ldg (the 8-lane
// build, whose two blocks an SM have no room for the copy)
#ifndef EA_STAGE_C2D_8
#define EA_STAGE_C2D_8 0
#endif
#ifndef EA_STAGE_C2D_16
#define EA_STAGE_C2D_16 1
#endif

namespace {

constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr int NARROW = 256;    // up to this width the builds of Build<L>
constexpr int NSNAP = 7;       // snapshot leaves (SNAP_LEAVES in the wrapper)
constexpr int NLEAF = 9;       // state leaves in shared memory
constexpr float RBIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

template <int L>
struct Build;
template <>
struct Build<8> {
  static constexpr int SR = EA_SLAB_8, MINB = EA_BLOCKS_8, TC = 1;
  static constexpr bool STAGE = EA_STAGE_C2D_8;
};
template <>
struct Build<16> {
  static constexpr int SR = EA_SLAB_16, MINB = EA_BLOCKS_16, TC = 2;
  static constexpr bool STAGE = EA_STAGE_C2D_16;
};

struct Params {
  const float* __restrict__ x0b;
  const float* __restrict__ z2refb;
  const float* __restrict__ z2b0;
  const float* __restrict__ z30;
  const float* __restrict__ lm0;
  const float* __restrict__ lht0;
  const float* __restrict__ c2d;   // [Z][nd]: C2m's class representatives
  const float* __restrict__ c2td;  // [Z][nd]: C2t's
  const int* __restrict__ col_of;  // [Z]: the class of each column
  const float* __restrict__ m3p;   // [Z][Z], dq3 @ m3p
  const float* __restrict__ rows[8];  // rm, rht, mh, mt, mr, h1i, lb, ub
  float* out[5];                      // z1, z2b, z3, lm, lht
  int* k;
  int* done;
  float* res[3];  // r_pf, r_z2, r_z3
  float* snap;    // exact-k: per lane [z2b | z3 | lm | lht | v2m | v2t | q3]
  int* ext;       // TP_CLOCKS: [4 b, 4 b + 4) block b's kilo-clocks of P1,
                  // of the chains, of P2, and of P3 and the keepers
  int Z, nd;
  float tol;
  int k_max, check_every, exact_k;
};

// the leaves; the first NSNAP are the snapshot leaves
enum { Z2B, Z3, LM, LHT, V2M, V2T, Q3, Z1, X0 };

using tp::bit;

// What lane t's keeper (thread t < L) holds of its lane: k and the three
// residuals it recorded last.
struct Keeper {
  int k = 0;
  float r[3] = {RBIG, RBIG, RBIG};
};

template <int L, int TC, int SR>
struct Engine {
  static constexpr int G = L / 8;
  static constexpr int DS = L + tp::DQ_PAD;  // row stride of dqm, a1, a2
  static constexpr unsigned ALL = (1u << L) - 1u;
  static constexpr bool STAGE = Build<L>::STAGE;  // C2d in shared memory
  const Params& p;
  float* leaf[NLEAF];  // [Z][L], swizzled
  float* dqm;          // [Z][DS]: dv2m, then dq3
  float* d2t;          // [Z][L]: dv2t
  float *a1, *a2;      // [nd][DS]: the chains' results
  float* c2s;          // STAGE: [Z][nd], C2d's rows [0, nr)
  float* red2;         // [Z / 32][L]: the warps' maxima of |dz2|
  float* red3;         // [Z / 16][2][8]: the half warps' maxima of r_pf,
                       // r_z3 over their lane group's 8 lanes
  unsigned* ctrl;      // [4]
  int *sn_k, *orig;    // [L] each: window starts, the lane a slot holds
  tp::Ring ring;
  Keeper kp;
  int tid, Z, nd, lane0, nr, t0, t1, cls;
  float rm, rht, mh, mt, mr, sg, h1i, lb, ub;  // column tid's constants
  unsigned fresh = ALL;  // slots whose next iteration is their lane's first
  long long clk[4] = {0, 0, 0, 0};  // TP_CLOCKS: thread 0's clocks of P1,
                                    // of the chains, of P2, and of P3 and
                                    // the keepers

  __device__ __forceinline__ Engine(const Params& p_, float* smem)
      : p(p_) {
    tid = threadIdx.x;
    Z = p.Z;
    nd = p.nd;
    lane0 = blockIdx.x * L;
    float* a = smem + tp::ring_bytes(Z, SR) / 4;
    for (int l = 0; l < NLEAF; ++l, a += Z * L) leaf[l] = a;
    dqm = a;
    d2t = dqm + Z * DS;
    a1 = d2t + Z * L;
    a2 = a1 + nd * DS;
    c2s = a2 + nd * DS;
    red2 = c2s + (STAGE ? Z * nd : 0);
    red3 = red2 + (Z >> 5) * L;
    ctrl = reinterpret_cast<unsigned*>(red3 + Z);
    sn_k = reinterpret_cast<int*>(ctrl + 4);
    orig = sn_k + L;
    int* bnd = orig + L;  // nr, t0, t1
    const int j = tid;
    rm = p.rows[0][j];
    rht = p.rows[1][j];
    mh = p.rows[2][j];
    mt = p.rows[3][j];
    mr = p.rows[4][j];
    sg = mh - mt;
    h1i = p.rows[5][j];
    lb = p.rows[6][j];
    ub = p.rows[7][j];
    cls = p.col_of[j];
    if (j == 0) {
      bnd[0] = 0;
      bnd[1] = Z;
      bnd[2] = 0;
    }
    __syncthreads();
    if (mr != 0.0f) atomicMax(&bnd[0], j + 1);
    if (mt != 0.0f) {
      atomicMin(&bnd[1], j);
      atomicMax(&bnd[2], j + 1);
    }
    __syncthreads();
    nr = bnd[0];
    t0 = bnd[1];
    t1 = bnd[2];
    // C2d's rows [0, nr), read by the first iteration's chains after its
    // first barrier
    if (STAGE) {
      for (int i = j; i < nr * nd; i += Z) c2s[i] = p.c2d[i];
    }
    // a ring of at least one row: with no real row M3p is zero
    tp::ring_init<SR>(ring, smem, p.m3p, Z, max(1, nr), 0, 0, tid, Z);
  }

  __device__ __forceinline__ void tic(long long& t, int i) {
    if (TP_CLOCKS && tid == 0) {
      const long long now = clock64();
      clk[i] += now - t;
      t = now;
    }
  }

  // One iteration (tp::run_modes). Lanes in `frozen` keep all their state;
  // what `idle` lanes hold is never read again, and a group of 8 lanes that
  // are all frozen or idle is skipped. With CHECK, the keepers of the lanes
  // in rmask record their residuals and count kinc iterations, and the
  // lanes whose three residuals meet tol are returned (identical in every
  // thread of the block). `last` and `stop` do not matter here: K3's
  // outputs are the state after a lane's last iteration.
  template <bool CHECK>
  TP_ITERATE unsigned iterate(unsigned frozen, unsigned idle, unsigned last,
                              bool stop, unsigned rmask, int kinc) {
    long long t = TP_CLOCKS && tid == 0 ? clock64() : 0;
    const unsigned dead = tp::whole_groups<L>(frozen | idle);
    p1(dead, frozen);
    __syncthreads();
    tic(t, 0);
    chains(dead);
    __syncthreads();
    tic(t, 1);
    p2<CHECK>(dead, frozen);
    tic(t, 2);
    // the widest tiles the live groups allow, as tp::TileEngine narrows them
    const int nl = max(1, G - __popc(dead) / 8);
    const bool packed = dead == (ALL & ~((1u << (8 * nl - 1) << 1) - 1u));
    unsigned conv;
    if constexpr (TC >= 2 && G >= 2) {
      if (packed && 2 * nl <= G)
        conv = finish<TC / 2, CHECK>(dead, frozen, rmask, kinc);
      else
        conv = finish<TC, CHECK>(dead, frozen, rmask, kinc);
    } else {
      conv = finish<TC, CHECK>(dead, frozen, rmask, kinc);
    }
    tic(t, 3);
    fresh &= frozen;
    return conv;
  }

  // P1: z1 = clip(-q1 h1i); the deltas of the z2 product's inputs.
  __device__ __forceinline__ void p1(unsigned dead, unsigned frozen) {
    const int j = tid;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float z2b[8], z3[8], lm[8], lht[8], x0[8], vm[8], vt[8], z1s[8];
      float dm[8], dt[8];
      tp::ld8<L>(z2b, leaf[Z2B], j, g);
      tp::ld8<L>(z3, leaf[Z3], j, g);
      tp::ld8<L>(lm, leaf[LM], j, g);
      tp::ld8<L>(lht, leaf[LHT], j, g);
      tp::ld8<L>(x0, leaf[X0], j, g);
      tp::ld8<L>(vm, leaf[V2M], j, g);
      tp::ld8<L>(vt, leaf[V2T], j, g);
      tp::ld8<L>(z1s, leaf[Z1], j, g);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const float s_ht = rht * (mt * z2b[b] - x0[b]) + lht[b];
        const float q1 = -(rm * (z2b[b] + z3[b]) + lm[b]) + sg * s_ht;
        const float z1 = fminf(fmaxf(-q1 * h1i, lb), ub);
        const float v2m = rm * (z3[b] - z1) + lm[b];
        const float v2t = mt * (rht * (-z1) + lht[b]);
        dm[b] = v2m - vm[b];
        dt[b] = v2t - vt[b];
        if (!bit(frozen, 8 * g + b)) {
          vm[b] = v2m;
          vt[b] = v2t;
          z1s[b] = z1;
        }
      }
      tp::st8_dq<L>(dqm, j, g, dm);
      float4* d4 = reinterpret_cast<float4*>(d2t + j * L + 8 * g);
      d4[0] = make_float4(dt[0], dt[1], dt[2], dt[3]);
      d4[1] = make_float4(dt[4], dt[5], dt[6], dt[7]);
      tp::st8<L>(leaf[V2M], j, g, vm);
      tp::st8<L>(leaf[V2T], j, g, vt);
      tp::st8<L>(leaf[Z1], j, g, z1s);
    }
  }

  // The z2 chains of every (class, lane) of a live group: a1 over rows
  // [0, nr) of C2d, a2 over rows [t0, t1) of C2td, each in ascending order.
  __device__ __forceinline__ void chains(unsigned dead) {
    const int n = nd * L;
    for (int ch = tid; ch < n; ch += Z) {
      const int d = ch / L, b = ch % L;
      if (bit(dead, b)) continue;
      // a2 first: its few rows of C2td come from L2 while nothing waits
      const float* ct = p.c2td + d;
      float s2 = 0.0f;
#pragma unroll 8
      for (int i = t0; i < t1; ++i)
        s2 = fmaf(d2t[i * L + b], __ldg(ct + static_cast<size_t>(i) * nd),
                  s2);
      const float* cm = (STAGE ? c2s : p.c2d) + d;
      const float* dv = dqm + b;
      float s1 = 0.0f;
#pragma unroll 8
      for (int i = 0; i < nr; ++i)
        s1 = fmaf(dv[i * DS], STAGE ? cm[i * nd] : __ldg(cm + i * nd), s1);
      a1[d * DS + b] = s1;
      a2[d * DS + b] = s2;
    }
  }

  // P2: z2bn = (z2acc + a1) + a2 at column tid's class; q3 and its delta
  // (into dqm); with CHECK the warps' maxima of |dz2|.
  template <bool CHECK>
  __device__ __forceinline__ void p2(unsigned dead, unsigned frozen) {
    const int j = tid;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float z2b[8], lm[8], q3p[8], z1[8], c1[8], c2[8], dq[8], az[8];
      tp::ld8<L>(z2b, leaf[Z2B], j, g);
      tp::ld8<L>(lm, leaf[LM], j, g);
      tp::ld8<L>(q3p, leaf[Q3], j, g);
      tp::ld8<L>(z1, leaf[Z1], j, g);
      tp::ld8_dq<L>(c1, a1, cls, g);
      tp::ld8_dq<L>(c2, a2, cls, g);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int s = 8 * g + b;
        const float acc =
            bit(fresh, s)
                ? __ldg(p.z2refb + static_cast<size_t>(lane0 + orig[s]) * Z +
                        j)
                : z2b[b];
        const float z2n = (acc + c1[b]) + c2[b];
        const float q3 = rm * (z2n - z1[b]) + lm[b];
        dq[b] = q3 - q3p[b];
        if (CHECK) az[b] = fabsf((z2n - z2b[b]) * mr);
        if (!bit(frozen, s)) {
          q3p[b] = q3;
          z2b[b] = z2n;
        }
      }
      tp::st8_dq<L>(dqm, j, g, dq);
      tp::st8<L>(leaf[Q3], j, g, q3p);
      tp::st8<L>(leaf[Z2B], j, g, z2b);
      if (CHECK) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            az[b] = fmaxf(az[b], __shfl_xor_sync(FULL, az[b], off));
        }
        if ((j & 31) == 0) {
          float4* w = reinterpret_cast<float4*>(red2 + (j >> 5) * L + 8 * g);
          w[0] = make_float4(az[0], az[1], az[2], az[3]);
          w[1] = make_float4(az[4], az[5], az[6], az[7]);
        }
      }
    }
  }

  // P3 with tiles of 8 lanes x TCX columns: z3n = z3acc + dq3 @ M3p, the
  // residual rows and the dual ascent of the tile's cells; with CHECK their
  // maxima and the keepers' part.
  template <int TCX, bool CHECK>
  __device__ __forceinline__ unsigned finish(unsigned dead, unsigned frozen,
                                             unsigned rmask, int kinc) {
    const tp::Tile<L, TCX> tile(tid, Z);
    float acc[TCX][8];
#pragma unroll
    for (int q = 0; q < TCX; ++q) {
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[q][b] = 0.0f;
    }
    const bool live = tile.active && !bit(dead, 8 * tile.lg);
    tp::product<L, TCX, SR>(ring, dqm, tile, acc, live, tid, Z, false,
                            [] {});
    float pf[8], az[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) pf[b] = az[b] = 0.0f;
    if (live) {
      const unsigned fz = frozen >> (8 * tile.lg);
      const unsigned fr = fresh >> (8 * tile.lg);
#pragma unroll
      for (int q = 0; q < TCX; ++q) {
        const int c = tile.col(q);
        const float crm = __ldg(p.rows[0] + c), crht = __ldg(p.rows[1] + c),
                    cmh = __ldg(p.rows[2] + c), cmt = __ldg(p.rows[3] + c),
                    cmr = __ldg(p.rows[4] + c);
        float z1[8], z2[8], z3[8], lm[8], lht[8], x0[8];
        tp::ld8<L>(z1, leaf[Z1], c, tile.lg);
        tp::ld8<L>(z2, leaf[Z2B], c, tile.lg);
        tp::ld8<L>(z3, leaf[Z3], c, tile.lg);
        tp::ld8<L>(lm, leaf[LM], c, tile.lg);
        tp::ld8<L>(lht, leaf[LHT], c, tile.lg);
        tp::ld8<L>(x0, leaf[X0], c, tile.lg);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const float z3n = (bit(fr, b) ? 0.0f : z3[b]) + acc[q][b];
          const float midR = z2[b] + z3n - z1[b];
          const float htR = cmh * z1[b] - x0[b] + cmt * (z2[b] - z1[b]);
          if (CHECK) {
            pf[b] = fmaxf(pf[b], fmaxf(fabsf(midR * cmr), fabsf(htR)));
            az[b] = fmaxf(az[b], fabsf((z3n - z3[b]) * cmr));
          }
          if (!bit(fz, b)) {
            z3[b] = z3n;
            lm[b] = lm[b] + crm * midR;
            lht[b] = lht[b] + crht * htR;
          }
        }
        tp::st8<L>(leaf[Z3], c, tile.lg, z3);
        tp::st8<L>(leaf[LM], c, tile.lg, lm);
        tp::st8<L>(leaf[LHT], c, tile.lg, lht);
      }
    }
    if (!CHECK) {
      __syncthreads();
      return 0u;
    }
    // a half warp's 16 threads share one lane group: Z / TCX threads a
    // group, a multiple of 16
#pragma unroll
    for (int b = 0; b < 8; ++b) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        pf[b] = fmaxf(pf[b], __shfl_xor_sync(FULL, pf[b], off));
        az[b] = fmaxf(az[b], __shfl_xor_sync(FULL, az[b], off));
      }
    }
    if (live && (tid & 15) == 0) {
      float4* w = reinterpret_cast<float4*>(red3 + (tid >> 4) * 16);
      w[0] = make_float4(pf[0], pf[1], pf[2], pf[3]);
      w[1] = make_float4(pf[4], pf[5], pf[6], pf[7]);
      w[2] = make_float4(az[0], az[1], az[2], az[3]);
      w[3] = make_float4(az[4], az[5], az[6], az[7]);
    }
    __syncthreads();
    if (tid < 32) keep(Z / TCX, rmask, kinc);
    __syncthreads();
    return ctrl[0];
  }

  // The keepers' part of a checked iteration, run by all of warp 0: lane
  // t's three residuals over the maxima (ncg threads a lane group in the
  // product's tiles); the lanes that meet tol go to ctrl[0].
  __device__ __forceinline__ void keep(int ncg, unsigned rmask, int kinc) {
    bool conv = false;
    if (tid < L) {
      float r[3] = {0.0f, 0.0f, 0.0f};
      for (int w = 0; w < (Z >> 5); ++w)
        r[1] = fmaxf(r[1], red2[w * L + tid]);
      const int h0 = (tid >> 3) * (ncg >> 4);
      const int h1 = min(Z >> 4, h0 + (ncg >> 4));
      for (int h = h0; h < h1; ++h) {
        r[0] = fmaxf(r[0], red3[h * 16 + (tid & 7)]);
        r[2] = fmaxf(r[2], red3[h * 16 + 8 + (tid & 7)]);
      }
      conv = r[0] <= p.tol && r[1] <= p.tol && r[2] <= p.tol;
      if (bit(rmask, tid)) {
        kp.k += kinc;
#pragma unroll
        for (int q = 0; q < 3; ++q) kp.r[q] = r[q];
      }
    }
    const unsigned m = __ballot_sync(FULL, conv);
    if (tid == 0) ctrl[0] = m;
  }

  // Exact-k compaction (tp::compact_lanes) over the seven snapshot leaves
  // and x0b. No slot is fresh here: a window start that compacts follows a
  // whole window of every lane's iterations.
  __device__ __forceinline__ unsigned compact(unsigned done) {
    float* const moved[NSNAP + 1] = {leaf[Z2B], leaf[Z3],  leaf[LM],
                                     leaf[LHT], leaf[V2M], leaf[V2T],
                                     leaf[Q3],  leaf[X0]};
    return tp::compact_lanes<L>(done, moved, orig, tid);
  }

  // Exact-k: this thread's column of the seven snapshot leaves between
  // shared memory and the lanes' snapshots, for the slots in `lanes` (slot b
  // holds lane orig[b]). Reading them back (every lane in its own slot
  // again) also restores x0b, zeroes z1 and marks the lanes whose window
  // starts at 0 fresh.
  template <bool TO_GLOBAL>
  __device__ __forceinline__ void snapshot(unsigned lanes) {
#pragma unroll
    for (int l = 0; l < NSNAP; ++l) {
      for (int b = 0; b < L; ++b) {
        if (!bit(lanes, b)) continue;
        float* g = p.snap +
                   (static_cast<size_t>(lane0 + orig[b]) * NSNAP + l) * Z +
                   tid;
        float& sh = tp::at<L>(leaf[l], tid, b);
        if (TO_GLOBAL)
          *g = sh;
        else
          sh = *g;
      }
    }
    if (!TO_GLOBAL) {
      fresh = 0;
      for (int b = 0; b < L; ++b) {
        tp::at<L>(leaf[X0], tid, b) =
            p.x0b[static_cast<size_t>(lane0 + b) * Z + tid];
        tp::at<L>(leaf[Z1], tid, b) = 0.0f;
        if (sn_k[b] == 0) fresh |= 1u << b;
      }
      __syncthreads();
    }
  }
};

template <int L, int TC, int SR, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) fused_eadmm_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  Engine<L, TC, SR> e(p, smem);
  const int j = e.tid;
  const int Z = p.Z;
  {
    // state: z2b0, z30, lm0, lht0, zero previous inputs, zero z1, x0b
    const float* src[NLEAF] = {p.z2b0,  p.z30,   p.lm0,   p.lht0, nullptr,
                               nullptr, nullptr, nullptr, p.x0b};
#pragma unroll
    for (int l = 0; l < NLEAF; ++l) {
      for (int b = 0; b < L; ++b)
        tp::at<L>(e.leaf[l], j, b) =
            src[l] ? src[l][static_cast<size_t>(e.lane0 + b) * Z + j] : 0.0f;
    }
  }
  if (j < L) {
    e.sn_k[j] = 0;
    e.orig[j] = j;
  }
  __syncthreads();
  const unsigned done =
      tp::run_modes<L>(e, p.k_max, p.check_every, p.exact_k, 0);
  tp::ring_drain(e.ring);
  const int leaves[5] = {Z1, Z2B, Z3, LM, LHT};
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    for (int b = 0; b < L; ++b)
      p.out[l][static_cast<size_t>(e.lane0 + b) * Z + j] =
          tp::at<L>(e.leaf[leaves[l]], j, b);
  }
  if (j < L) {
    const int lane = e.lane0 + j;
    p.k[lane] = e.kp.k;
    p.done[lane] = bit(done, j) ? 1 : 0;
#pragma unroll
    for (int q = 0; q < 3; ++q) p.res[q][lane] = e.kp.r[q];
  }
  if (TP_CLOCKS && j == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p.ext[4 * blockIdx.x + i] = static_cast<int>(e.clk[i] >> 10);
  }
}

// Rows a slab, and whether C2d is copied to shared memory, of the builds at
// `lanes` lanes.
int slab_rows(int lanes) { return lanes == 8 ? Build<8>::SR : Build<16>::SR; }
bool staged(int lanes) {
  return lanes == 8 ? Build<8>::STAGE : Build<16>::STAGE;
}

template <int L>
int launch(const Params& p, int blocks, int threads, int smem, void* stream) {
  // up to NARROW columns the build of Build<L>; wider, one block of up to
  // MAX_COLS threads an SM (not at 16 lanes: above 256 columns its state
  // does not fit shared memory)
  void (*kernel)(Params) = nullptr;
  if (threads <= NARROW)
    kernel = fused_eadmm_kernel<L, Build<L>::TC, Build<L>::SR, NARROW,
                                Build<L>::MINB>;
  else if constexpr (L == 8)
    kernel = fused_eadmm_kernel<L, Build<L>::TC, Build<L>::SR, MAX_COLS, 1>;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared bytes at `lanes` lanes a block and nd classes of columns
// (kernels/fused_eadmm.py shared_bytes computes the same): the ring of M3p's
// slabs, the nine leaves as [Z][lanes], dv2m/dq3 with its padding, dv2t, the
// chains' results, the row maxima, the masks, the window starts, the slots'
// lanes and the row bounds.
extern "C" long fused_eadmm_smem(int Z, int lanes, int nd) {
  const long L = lanes, D = lanes + tp::DQ_PAD;
  return tp::ring_bytes(Z, slab_rows(lanes)) +
         4L * (NLEAF * Z * L + Z * D + Z * L + 2L * nd * D +
               (staged(lanes) ? static_cast<long>(Z) * nd : 0L) +
               (Z / 32) * L + Z + 4 + 2 * L + 4);
}

// Launch on `stream` (a cudaStream_t). The geometry comes from the wrapper
// (kernels/fused_eadmm.py launch_plan) and is checked here again: B / lanes
// blocks of Z threads; `ext` is 4 blocks int32 of scratch. Returns the CUDA
// error of the launch, as an int.
extern "C" int fused_eadmm_launch(
    const float* x0b, const float* z2refb, const float* z2b0,
    const float* z30, const float* lm0, const float* lht0, const float* c2d,
    const float* c2td, const int* col_of, const float* m3p, const float* rm,
    const float* rht, const float* mh, const float* mt, const float* mr,
    const float* h1i, const float* lb, const float* ub, float* z1,
    float* z2b, float* z3, float* lm, float* lht, int* k, int* done,
    float* rpf, float* rz2, float* rz3, float* snap, int* ext, int B, int Z,
    int nd, int lanes, int blocks, int threads, int smem, float tol,
    int k_max, int check_every, int exact_k, void* stream) {
  const bool exact = check_every > 1 && exact_k;
  if (Z <= 0 || Z % 32 != 0 || Z > MAX_COLS || nd < 1 || nd > Z ||
      (lanes != 8 && lanes != 16) || B % lanes != 0 ||
      blocks != B / lanes || threads != Z ||
      smem != fused_eadmm_smem(Z, lanes, nd) || check_every < 1 ||
      k_max < 1 || (exact && B > 0 && snap == nullptr) || ext == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Params p{x0b, z2refb, z2b0, z30, lm0, lht0, c2d, c2td, col_of, m3p,
           {rm, rht, mh, mt, mr, h1i, lb, ub},
           {z1, z2b, z3, lm, lht}, k, done, {rpf, rz2, rz3}, snap, ext,
           Z, nd, tol, k_max, check_every, exact_k};
  return lanes == 8 ? launch<8>(p, blocks, threads, smem, stream)
                    : launch<16>(p, blocks, threads, smem, stream);
}
#endif  // !WIDE_PART

#if WIDE_PART
// The wide build, a translation unit of its own (-DWIDE_PART=1;
// kernels/_build.py compiles the narrow builds above with
// -DWIDE_PART=0 from exactly their earlier text).

#include <cuda_runtime.h>

#include "wide_cols.cuh"

namespace {

constexpr int NLEAF = 9;  // state leaves
constexpr int NSNAP = 7;  // snapshot leaves, the first NSNAP

// ---- the wide build ---------------------------------------------------------
//
// Past MAX_COLS columns, up to wc::COLS = 1024: fused_eadmm_wide_kernel runs
// 512 threads of two columns, t and t + 512, at 8 lanes a block, on the
// first layout (csrc/variants/fused_eadmm_parent.cu: one column a thread,
// the matrices read from L2) with each thread taking two columns
// (csrc/wide_cols.cuh). The nine state vectors (2 columns x 8 lanes x 9
// leaves would pass a 512-thread block's 128 registers) live in global
// memory that only their thread touches; shared memory holds the three
// products' inputs dv2m, dv2t and dq3 as [Z][8], the row maxima, and C2d,
// the distinct columns of C2m ([Z][nd], as the narrow builds' 16-lane build
// copies it). A column's z2 sums run over its class's column of C2d and
// C2td, byte for byte its own column of C2m and C2t: the same fmaf chains
// as the first layout's, so the kernel gives this kernel's bits. The row
// maxima of P2 and P3 are taken over a thread's two columns, then the warp
// and the warps. No refill: plain free-run drains each block.

using wc::TB;

struct EadmmWide {
  const float* __restrict__ x0b;
  const float* __restrict__ z2refb;
  const float* __restrict__ z2b0;
  const float* __restrict__ z30;
  const float* __restrict__ lm0;
  const float* __restrict__ lht0;
  const float* __restrict__ c2d;   // [Z][nd]: C2m's distinct columns
  const float* __restrict__ c2td;  // [Z][nd]: C2t's, over the same classes
  const int* __restrict__ col_of;  // [Z]: the class of each column
  const float* __restrict__ m3p;   // [Z][Z], dq3 @ m3p
  const float* __restrict__ rows[8];  // rm, rht, mh, mt, mr, h1i, lb, ub
  float* out[5];                      // z1, z2b, z3, lm, lht
  int* k;
  int* done;
  float* res[3];  // r_pf, r_z2, r_z3
  float* snap;    // exact-k: per lane [z2b | z3 | lm | lht | v2m | v2t | q3]
  float* state;   // [blocks][9][Z][8]: the leaves below
  int Z, nd;
  float tol;
  int k_max, check_every, exact_k;
};
// the state leaves; the first NSNAP are the snapshot's, in its order
enum { W_Z2B, W_Z3, W_LM, W_LHT, W_V2M, W_V2T, W_Q3, W_Z1, W_X0 };

// What a thread knows of its two columns and of the block.
struct EadmmCols {
  float rm[wc::CPT], rht[wc::CPT], mh[wc::CPT], mt[wc::CPT], mr[wc::CPT],
      sg[wc::CPT], h1i[wc::CPT], lb[wc::CPT], ub[wc::CPT];
  int cls[wc::CPT];
  int nr, t0, t1;  // the rows the products read, as the first layout's
  int lane0;
  float* d2m;  // shared: [Z][8]  product inputs
  float* d2t;
  float* dq3;
  float* red;  // shared: [WARPS][3][8]
  float* c2d;  // shared: [Z][nd]
  float* st[NLEAF];  // global: [Z][8] each
};

// acc[b] = sum_{i0 <= i < i1} v[i][b] m[i][c]: m in shared memory with
// leading dimension ld; one fmaf chain in row order.
__device__ __forceinline__ void chain_shared(const float* v, const float* m,
                                             int ld, int i0, int i1, int c,
                                             float (&acc)[TB]) {
  wc::zero(acc);
#pragma unroll 8
  for (int i = i0; i < i1; ++i) {
    const float w = m[i * ld + c];
    const float4* v4 = reinterpret_cast<const float4*>(v + i * TB);
#pragma unroll
    for (int q = 0; q < TB / 4; ++q) {
      const float4 d = v4[q];
      acc[4 * q] = fmaf(d.x, w, acc[4 * q]);
      acc[4 * q + 1] = fmaf(d.y, w, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(d.z, w, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(d.w, w, acc[4 * q + 3]);
    }
  }
}

// One iteration of the thread's columns for the block's 8 lanes, as the
// first layout's iterate: lanes in `frozen` keep all their state; lanes in
// `fresh` take z2refb and 0 as the accumulators (their first iteration).
// Thread 0 records the residuals of the lanes in `rmask` in lres. Returns
// the lanes whose three residuals meet tol.
__device__ __forceinline__ unsigned eadmm_wide_iterate(
    const EadmmWide& p, const EadmmCols& c, unsigned frozen, unsigned fresh,
    unsigned rmask, float (&lres)[3][TB]) {
  const int Z = p.Z;
  float z1[wc::CPT][TB], z2n[wc::CPT][TB];
  // 1. P1: z1 = clip(-q1 h1i); the deltas of the z2 product's inputs
#pragma unroll
  for (int h = 0; h < wc::CPT; ++h) {
    const int j = wc::col(h, Z);
    if (j < 0) break;
    const int o = j * TB;
    float z2b[TB], z3[TB], lm[TB], lht[TB], x0[TB], vm[TB], vt[TB];
    float dm[TB], dt[TB], z1s[TB];
    wc::load(z2b, c.st[W_Z2B] + o);
    wc::load(z3, c.st[W_Z3] + o);
    wc::load(lm, c.st[W_LM] + o);
    wc::load(lht, c.st[W_LHT] + o);
    wc::load(x0, c.st[W_X0] + o);
    wc::load(vm, c.st[W_V2M] + o);
    wc::load(vt, c.st[W_V2T] + o);
    wc::load(z1s, c.st[W_Z1] + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float s_ht = c.rht[h] * (c.mt[h] * z2b[b] - x0[b]) + lht[b];
      const float q1 =
          -(c.rm[h] * (z2b[b] + z3[b]) + lm[b]) + c.sg[h] * s_ht;
      z1[h][b] = fminf(fmaxf(-q1 * c.h1i[h], c.lb[h]), c.ub[h]);
      const float v2m = c.rm[h] * (z3[b] - z1[h][b]) + lm[b];
      const float v2t = c.mt[h] * (c.rht[h] * (-z1[h][b]) + lht[b]);
      dm[b] = v2m - vm[b];
      dt[b] = v2t - vt[b];
      if (!wc::bit(frozen, b)) {
        vm[b] = v2m;
        vt[b] = v2t;
        z1s[b] = z1[h][b];
      }
    }
    wc::store(c.d2m + o, dm);
    wc::store(c.d2t + o, dt);
    wc::store(c.st[W_V2M] + o, vm);
    wc::store(c.st[W_V2T] + o, vt);
    wc::store(c.st[W_Z1] + o, z1s);
  }
  __syncthreads();
  // 2. P2: z2bn = z2acc + dv2m @ C2m + dv2t @ C2t; q3 and its delta
  {
    float az[TB];
    wc::zero(az);
#pragma unroll
    for (int h = 0; h < wc::CPT; ++h) {
      const int j = wc::col(h, Z);
      if (j < 0) break;
      const int o = j * TB;
      float a1[TB], a2[TB], z2b[TB], lm[TB], q3p[TB], dq[TB];
      chain_shared(c.d2m, c.c2d, p.nd, 0, c.nr, c.cls[h], a1);
      wc::zero(a2);
      wc::product<8>(c.d2t, p.c2td, p.nd, c.t0, c.t1, c.cls[h], a2);
      wc::load(z2b, c.st[W_Z2B] + o);
      wc::load(lm, c.st[W_LM] + o);
      wc::load(q3p, c.st[W_Q3] + o);
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const float acc =
            wc::bit(fresh, b)
                ? __ldg(p.z2refb + static_cast<size_t>(c.lane0 + b) * Z + j)
                : z2b[b];
        z2n[h][b] = (acc + a1[b]) + a2[b];
        const float q3 = c.rm[h] * (z2n[h][b] - z1[h][b]) + lm[b];
        dq[b] = q3 - q3p[b];
        az[b] = fmaxf(az[b], fabsf((z2n[h][b] - z2b[b]) * c.mr[h]));
        if (!wc::bit(frozen, b)) {
          q3p[b] = q3;
          z2b[b] = z2n[h][b];
        }
      }
      wc::store(c.dq3 + o, dq);
      wc::store(c.st[W_Q3] + o, q3p);
      wc::store(c.st[W_Z2B] + o, z2b);
    }
    wc::warp_max<3>(az, c.red, 1);
  }
  __syncthreads();
  // 3. P3: z3n = z3acc + dq3 @ M3p; residual rows and dual ascent
  {
    float pf[TB], az[TB];
    wc::zero(pf);
    wc::zero(az);
#pragma unroll
    for (int h = 0; h < wc::CPT; ++h) {
      const int j = wc::col(h, Z);
      if (j < 0) break;
      const int o = j * TB;
      float a3[TB], z3[TB], lm[TB], lht[TB], x0[TB];
      wc::zero(a3);
      wc::product<8>(c.dq3, p.m3p, Z, 0, c.nr, j, a3);
      wc::load(z3, c.st[W_Z3] + o);
      wc::load(lm, c.st[W_LM] + o);
      wc::load(lht, c.st[W_LHT] + o);
      wc::load(x0, c.st[W_X0] + o);
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const float acc = wc::bit(fresh, b) ? 0.0f : z3[b];
        const float z3n = acc + a3[b];
        const float midR = z2n[h][b] + z3n - z1[h][b];
        const float htR =
            c.mh[h] * z1[h][b] - x0[b] + c.mt[h] * (z2n[h][b] - z1[h][b]);
        pf[b] = fmaxf(pf[b], fmaxf(fabsf(midR * c.mr[h]), fabsf(htR)));
        az[b] = fmaxf(az[b], fabsf((z3n - z3[b]) * c.mr[h]));
        if (!wc::bit(frozen, b)) {
          z3[b] = z3n;
          lm[b] = lm[b] + c.rm[h] * midR;
          lht[b] = lht[b] + c.rht[h] * htR;
        }
      }
      wc::store(c.st[W_Z3] + o, z3);
      wc::store(c.st[W_LM] + o, lm);
      wc::store(c.st[W_LHT] + o, lht);
    }
    wc::warp_max<3>(pf, c.red, 0);
    wc::warp_max<3>(az, c.red, 2);
  }
  __syncthreads();
  // 4. the residuals of each lane, and the lanes that meet tol
  float rs[3][TB];
#pragma unroll
  for (int q = 0; q < 3; ++q) wc::block_max<3>(c.red, q, rs[q]);
  unsigned conv = 0;
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    if (rs[0][b] <= p.tol && rs[1][b] <= p.tol && rs[2][b] <= p.tol)
      conv |= 1u << b;
    if (threadIdx.x == 0 && wc::bit(rmask, b)) {
#pragma unroll
      for (int q = 0; q < 3; ++q) lres[q][b] = rs[q][b];
    }
  }
  return conv;
}

// The seven snapshot leaves of the thread's columns to (TO_GLOBAL) or from
// each lane's [z2b | z3 | lm | lht | v2m | v2t | q3] in p.snap, for the
// lanes in `lanes`.
template <bool TO_GLOBAL>
__device__ __forceinline__ void eadmm_wide_snapshot(const EadmmWide& p,
                                                    const EadmmCols& c,
                                                    unsigned lanes) {
#pragma unroll
  for (int h = 0; h < wc::CPT; ++h) {
    const int j = wc::col(h, p.Z);
    if (j < 0) break;
#pragma unroll
    for (int l = 0; l < NSNAP; ++l)
      wc::snap_row<TO_GLOBAL>(c.st[l], p.snap, NSNAP * p.Z, l * p.Z + j, j,
                              c.lane0, lanes);
  }
}

__global__ void __launch_bounds__(wc::THREADS, 1)
    fused_eadmm_wide_kernel(EadmmWide p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sn_k[TB];       // exact-k: each lane's window start
  __shared__ float lres[3][TB];  // thread 0's residuals of each lane
  __shared__ int bounds[3];      // nr, t0, t1
  const int Z = p.Z;
  const int tid = threadIdx.x;
  EadmmCols c;
  c.lane0 = blockIdx.x * TB;
  c.d2m = smem;
  c.d2t = c.d2m + Z * TB;
  c.dq3 = c.d2t + Z * TB;
  c.red = c.dq3 + Z * TB;
  c.c2d = c.red + wc::WARPS * 3 * TB;
#pragma unroll
  for (int l = 0; l < NLEAF; ++l) c.st[l] = wc::leaf(p.state, NLEAF, l, Z);
  for (int i = tid; i < Z * p.nd; i += wc::THREADS) c.c2d[i] = p.c2d[i];
  if (tid == 0) {
    bounds[0] = 0;
    bounds[1] = Z;
    bounds[2] = 0;
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int q = 0; q < 3; ++q) lres[q][b] = wc::RBIG;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < wc::CPT; ++h) {
    const int j = wc::col(h, Z);
    c.rm[h] = j < 0 ? 0.0f : p.rows[0][j];
    c.rht[h] = j < 0 ? 0.0f : p.rows[1][j];
    c.mh[h] = j < 0 ? 0.0f : p.rows[2][j];
    c.mt[h] = j < 0 ? 0.0f : p.rows[3][j];
    c.mr[h] = j < 0 ? 0.0f : p.rows[4][j];
    c.h1i[h] = j < 0 ? 0.0f : p.rows[5][j];
    c.lb[h] = j < 0 ? 0.0f : p.rows[6][j];
    c.ub[h] = j < 0 ? 0.0f : p.rows[7][j];
    c.sg[h] = c.mh[h] - c.mt[h];
    c.cls[h] = j < 0 ? 0 : p.col_of[j];
    if (j < 0) continue;
    if (c.mr[h] != 0.0f) atomicMax(&bounds[0], j + 1);
    if (c.mt[h] != 0.0f) {
      atomicMin(&bounds[1], j);
      atomicMax(&bounds[2], j + 1);
    }
    // state: z2b0, z30, lm0, lht0, zero previous inputs, zero z1, x0b
    const float* src[9] = {p.z2b0, p.z30,   p.lm0,   p.lht0, nullptr,
                           nullptr, nullptr, nullptr, p.x0b};
#pragma unroll
    for (int l = 0; l < NLEAF; ++l)
      wc::read_row(c.st[l], src[l], Z, j, c.lane0);
  }
  __syncthreads();
  c.nr = bounds[0];
  c.t0 = bounds[1];
  c.t1 = bounds[2];
  unsigned done = 0;
  int k[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) k[b] = 0;
  const int C = p.check_every;
  constexpr unsigned ALL = wc::ALL;

  if (C > 1 && p.exact_k) {
    // free-run windows of C iterations; snapshot every still-active lane
    // at each window start; a lane is done once the window's last
    // iteration meets tol. Windows may overshoot k_max: the replay budget
    // cuts each lane off at exactly k_max.
    for (int it = 0; it < p.k_max && done != ALL; it += C) {
      eadmm_wide_snapshot<true>(p, c, ~done & ALL);
      if (tid == 0) {
#pragma unroll
        for (int b = 0; b < TB; ++b)
          if (!wc::bit(done, b)) sn_k[b] = it;
      }
      for (int f = 0; f < C - 1; ++f)
        eadmm_wide_iterate(p, c, 0u, (it == 0 && f == 0) ? ALL : 0u, 0u,
                           lres);
      done |= eadmm_wide_iterate(p, c, 0u, 0u, 0u, lres);
    }
    __syncthreads();  // the window starts, written by thread 0
    // replay each lane's last window from its snapshot with per-iteration
    // checks: k counts on from the window start
    eadmm_wide_snapshot<false>(p, c, ALL);
#pragma unroll
    for (int h = 0; h < wc::CPT; ++h) {
      const int j = wc::col(h, Z);
      if (j < 0) break;
      float zero[TB];
      wc::zero(zero);
      wc::store(c.st[W_Z1] + j * TB, zero);
    }
    int budget[TB];
    unsigned first = 0;  // lanes replaying from the initial state
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      k[b] = sn_k[b];
      budget[b] = min(C, p.k_max - k[b]);
      if (k[b] == 0) first |= 1u << b;
    }
    unsigned convd = 0;
    for (int w = 0; w < C; ++w) {
      unsigned frozen = convd;
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (w >= budget[b]) frozen |= 1u << b;
      if (frozen == ALL) break;
      const unsigned conv = eadmm_wide_iterate(
          p, c, frozen, w == 0 ? first : 0u, ~frozen & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!wc::bit(frozen, b)) ++k[b];
      convd |= conv & ~frozen;
    }
    done = convd;
  } else if (C > 1) {
    // free-run: C-1 plain iterations, then one tested iteration; every
    // lane keeps iterating until the block's lanes (one group of 8) are
    // all done, k is recorded at check granularity, and a done lane's
    // residuals stay at its exit
    for (int it = 0; it < p.k_max && done != ALL;) {
      const int n_fast = min(C - 1, p.k_max - 1 - it);
      for (int f = 0; f < n_fast; ++f)
        eadmm_wide_iterate(p, c, 0u, (it == 0 && f == 0) ? ALL : 0u, 0u,
                           lres);
      const unsigned conv = eadmm_wide_iterate(
          p, c, 0u, (it == 0 && n_fast == 0) ? ALL : 0u, ~done & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!wc::bit(done, b)) k[b] += n_fast + 1;
      done |= conv;
      it += n_fast + 1;
    }
  } else {
    // checked: exit tests every iteration; a converged lane freezes
    for (int it = 0; it < p.k_max && done != ALL; ++it) {
      const unsigned conv = eadmm_wide_iterate(
          p, c, done, it == 0 ? ALL : 0u, ~done & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!wc::bit(done, b)) ++k[b];
      done |= conv;
    }
  }

  {
    const int leaves[5] = {W_Z1, W_Z2B, W_Z3, W_LM, W_LHT};
#pragma unroll
    for (int h = 0; h < wc::CPT; ++h) {
      const int j = wc::col(h, Z);
      if (j < 0) break;
#pragma unroll
      for (int l = 0; l < 5; ++l)
        wc::write_row(c.st[leaves[l]], p.out[l], Z, j, c.lane0);
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      p.k[c.lane0 + b] = k[b];
      p.done[c.lane0 + b] = wc::bit(done, b) ? 1 : 0;
#pragma unroll
      for (int q = 0; q < 3; ++q) p.res[q][c.lane0 + b] = lres[q][b];
    }
  }
}

}  // namespace

// Dynamic shared bytes of a block of the wide build at nd classes of
// columns (kernels/fused_eadmm.py shared_bytes(Z, 8, nd, wide=True)
// computes the same): dv2m, dv2t and dq3 as [Z][8], the warps' row maxima
// and C2d as [Z][nd].
extern "C" long fused_eadmm_wide_smem(int Z, int nd) {
  return 4L * (3L * Z * TB + 3L * wc::WARPS * TB + static_cast<long>(Z) * nd);
}

// Launch the wide build on `stream`: the arguments of fused_eadmm_launch but
// the clock counts and the lanes, and `state`, the blocks' global state
// ([B / 8][9][Z][8] floats). The geometry comes from the wrapper
// (kernels/fused_eadmm.py launch_plan with wide=True) and is checked here
// again. Returns the CUDA error of the launch, as an int.
extern "C" int fused_eadmm_wide_launch(
    const float* x0b, const float* z2refb, const float* z2b0,
    const float* z30, const float* lm0, const float* lht0, const float* c2d,
    const float* c2td, const int* col_of, const float* m3p, const float* rm,
    const float* rht, const float* mh, const float* mt, const float* mr,
    const float* h1i, const float* lb, const float* ub, float* z1,
    float* z2b, float* z3, float* lm, float* lht, int* k, int* done,
    float* rpf, float* rz2, float* rz3, float* snap, float* state, int B,
    int Z, int nd, int blocks, int threads, int smem, float tol, int k_max,
    int check_every, int exact_k, void* stream) {
  const bool exact = check_every > 1 && exact_k;
  if (Z <= 0 || Z % 32 != 0 || Z > wc::COLS || nd < 1 || nd > Z ||
      B % TB != 0 || blocks != B / TB || threads != wc::THREADS ||
      smem != fused_eadmm_wide_smem(Z, nd) || smem > wc::SMEM_MAX ||
      check_every < 1 || k_max < 1 ||
      (B > 0 && (state == nullptr || (exact && snap == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_eadmm_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  EadmmWide p{x0b, z2refb, z2b0, z30, lm0, lht0, c2d, c2td, col_of, m3p,
              {rm, rht, mh, mt, mr, h1i, lb, ub},
              {z1, z2b, z3, lm, lht}, k, done, {rpf, rz2, rz3}, snap, state,
              Z, nd, tol, k_max, check_every, exact_k};
  fused_eadmm_wide_kernel<<<blocks, wc::THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

#endif  // WIDE_PART
