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

#include <cuda_runtime.h>

#include "tile_product.cuh"

// What the narrow builds (#if !WIDE_PART) and the wide build (#if
// WIDE_PART) share: the element-wise steps of one (lane, column) cell, so
// that the iteration's arithmetic lies in one place.
namespace {

// P1: z1 = clip(-q1 h1i) and the z2 product's inputs v2m, v2t (sg = mh -
// mt).
__device__ __forceinline__ void p1_cell(float rm, float rht, float mt,
                                        float sg, float h1i, float lb,
                                        float ub, float z2b, float z3,
                                        float lm, float lht, float x0,
                                        float& z1, float& v2m, float& v2t) {
  const float s_ht = rht * (mt * z2b - x0) + lht;
  const float q1 = -(rm * (z2b + z3) + lm) + sg * s_ht;
  z1 = fminf(fmaxf(-q1 * h1i, lb), ub);
  v2m = rm * (z3 - z1) + lm;
  v2t = mt * (rht * (-z1) + lht);
}

// P2: z2bn = (z2acc + a1) + a2 and q3.
__device__ __forceinline__ void p2_cell(float rm, float acc, float a1,
                                        float a2, float z1, float lm,
                                        float& z2n, float& q3) {
  z2n = (acc + a1) + a2;
  q3 = rm * (z2n - z1) + lm;
}

// P3's rest at lane b of a group whose fresh and frozen lanes are the bits
// of fr and fz: z3n = z3acc (0 on a fresh lane, else z3) + the product's
// sum, the residual rows and, unless the lane is frozen, the dual ascent;
// with CHECK the cell's part of the row maxima of r_pf (pf) and r_z3 (az).
// (The masks are tested here, in the order of the cell's operations: bools
// formed at the call gave the 8-lane narrow builds 16 bytes of spill at
// their 128 registers.)
template <bool CHECK>
__device__ __forceinline__ void p3_cell(float rm, float rht, float mh,
                                        float mt, float mr, unsigned fr,
                                        unsigned fz, int b, float acc,
                                        float z1, float z2, float x0,
                                        float& z3, float& lm, float& lht,
                                        float& pf, float& az) {
  const float z3n = (tp::bit(fr, b) ? 0.0f : z3) + acc;
  const float midR = z2 + z3n - z1;
  const float htR = mh * z1 - x0 + mt * (z2 - z1);
  if (CHECK) {
    pf = fmaxf(pf, fmaxf(fabsf(midR * mr), fabsf(htR)));
    az = fmaxf(az, fabsf((z3n - z3) * mr));
  }
  if (!tp::bit(fz, b)) {
    z3 = z3n;
    lm = lm + rm * midR;
    lht = lht + rht * htR;
  }
}

}  // namespace

#if !WIDE_PART
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
        float z1, v2m, v2t;
        p1_cell(rm, rht, mt, sg, h1i, lb, ub, z2b[b], z3[b], lm[b], lht[b],
                x0[b], z1, v2m, v2t);
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
        float z2n, q3;
        p2_cell(rm, acc, c1[b], c2[b], z1[b], lm[b], z2n, q3);
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
        for (int b = 0; b < 8; ++b)
          p3_cell<CHECK>(crm, crht, cmh, cmt, cmr, fr, fz, b, acc[q][b],
                         z1[b], z2[b], x0[b], z3[b], lm[b], lht[b], pf[b],
                         az[b]);
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
// kernels/_build.py compiles the narrow builds above with -DWIDE_PART=0
// from exactly their text).
//
// Past MAX_COLS columns, up to tp::WIDE_COLS = 1024: fused_eadmm_wide_kernel
// runs WideEngine, the narrow Engine's iteration on tp::WIDE_THREADS = 512
// threads of tp::WIDE_CPT = 2 columns (t and t + 512), at 16 or 8 lanes a
// block (kernels/stage.py WIDE_BUILDS), one block per L lanes and no refill,
// its modes tp::run_modes', as the narrow builds run them. What differs
// from the narrow builds is where the state lies and who forms P3's results:
//   - the nine leaves lie in the block's global scratch ([9][Z][L], the
//     swizzled layout), which at 16 lanes would take 313 KB of shared
//     memory at 544 columns and 590 KB at 1024, and so does dv2t ([Z][L],
//     of which the chains read the rows [t0, t1) alone). Each leaf is
//     touched by its column's thread alone, so it needs no barrier; dv2t's
//     rows are published by the barrier after P1;
//   - P3's tile owner (8 lanes x TC columns, TC = tp::wide_tc<L>(): 4 at
//     16 lanes, 2 at 8; M3p's rows [0, nr) through the stage's TMA ring)
//     only writes its sums into dqm, once a barrier has ended the
//     product's reads of dq3 there; after a second barrier the column's
//     thread forms z3n, the residual rows, the dual ascent and the row
//     maxima of its columns, which the narrow builds' tile owner does:
//     each element sees the same operations in the same order, so the bits
//     hold, and a maximum does not depend on its order;
//   - the z2 chains read C2d from a copy in shared memory where it fits
//     beside a ring of 8-row slabs, else by __ldg (over L2, their loads
//     took the chains from 3 % to 17 % of an iteration at 1024 columns);
//     then M3p comes in the build's slabs (tp::wide_slab: 16 rows at 16
//     lanes) where they fit, else in 8-row slabs (wide_staged,
//     wide_slab_rows: the copy and 16-row slabs at 544 columns, the copy
//     and 8-row slabs at 1024);
//   - the column loops of P1, P2 and P3's column part stay rolled: their
//     global loads, batched across columns and groups, spilled.
// The row maxima of P2 and of P3's column part are taken over a thread's
// two columns, then its warp, into [16 warps][3][L], which lane t's keeper
// folds. Both engines run each cell's arithmetic through p1_cell, p2_cell
// and p3_cell above. The build before this one ran the first wide layout
// (8 lanes a block, M3p read from L2 by every thread).

namespace {

constexpr int NSNAP = 7;  // snapshot leaves (SNAP_LEAVES in the wrapper)
constexpr int NLEAF = 9;  // state leaves, in the block's global scratch
constexpr int NSCR = NLEAF + 1;  // the scratch's [Z][L] parts: dv2t's last
constexpr int NRED = 3;   // row maxima a lane: r_pf, r_z2, r_z3
constexpr int WARPS = tp::WIDE_THREADS / 32;
constexpr float RBIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

struct WideParams {
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
  float* res[3];   // r_pf, r_z2, r_z3
  float* snap;     // exact-k: per lane [z2b | z3 | lm | lht | v2m | v2t | q3]
  float* scratch;  // [blocks][NSCR][Z][L]: the leaves, dv2t
  int* ext;        // TP_CLOCKS: [4 b, 4 b + 4) block b's kilo-clocks of P1,
                   // of the chains, of P2, and of P3 and the keepers
  int Z, nd, staged;
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
  float r[NRED] = {RBIG, RBIG, RBIG};
};

// Dynamic shared bytes at `lanes` lanes, nd classes of columns, slabs of sr
// rows and C2d's copy (staged) or not: the ring of M3p's slabs, dv2m, dq3
// and then P3's sums with their padding, the chains' results, C2d's copy,
// the 16 warps' row maxima, the masks, the window starts, the slots' lanes
// and the row bounds.
long wide_bytes(int Z, int lanes, int nd, int sr, int staged) {
  return tp::ring_bytes(Z, sr) +
         4L * (Z * (lanes + tp::DQ_PAD) + 2L * nd * (lanes + tp::DQ_PAD) +
               staged * static_cast<long>(Z) * nd + NRED * WARPS * lanes + 4 +
               2L * lanes + 4);
}

// Whether the z2 chains read C2d from a copy in shared memory: where it
// fits beside a ring of tp::WIDE_SLAB_8-row slabs.
int wide_staged(int Z, int lanes, int nd) {
  return wide_bytes(Z, lanes, nd, tp::WIDE_SLAB_8, 1) <= tp::SMEM_MAX;
}

// Rows a slab: the build's where its ring fits beside the buffers (and
// C2d's copy where wide_staged), else tp::WIDE_SLAB_8.
int wide_slab_rows(int Z, int lanes, int nd) {
  return wide_bytes(Z, lanes, nd, tp::wide_slab(lanes),
                    wide_staged(Z, lanes, nd)) <= tp::SMEM_MAX
             ? tp::wide_slab(lanes)
             : tp::WIDE_SLAB_8;
}

template <int L, int TC, int SR>
struct WideEngine {
  static constexpr int G = L / 8;
  static constexpr int DS = L + tp::DQ_PAD;  // row stride of dqm, a1, a2
  static constexpr unsigned ALL = (1u << L) - 1u;
  static constexpr int T = tp::WIDE_THREADS;
  const WideParams& p;
  float* leaf[NLEAF];  // the block's global scratch: [Z][L] each, swizzled
  float* dqm;          // [Z][DS]: dv2m, then dq3, then P3's sums
  float* d2t;          // the block's global scratch: [Z][L], dv2t
  float *a1, *a2;      // [nd][DS]: the chains' results
  float* c2s;          // staged: [Z][nd], C2d's rows [0, nr)
  float* red;          // [WARPS][NRED][L]: the warps' row maxima
  unsigned* ctrl;      // [4]
  int *sn_k, *orig;    // [L] each: window starts, the lane a slot holds
  tp::Ring ring;
  Keeper kp;
  int tid, Z, nd, lane0, nr, t0, t1;
  bool staged;
  unsigned fresh = ALL;  // slots whose next iteration is their lane's first
  long long clk[4] = {0, 0, 0, 0};  // TP_CLOCKS: thread 0's clocks of P1,
                                    // of the chains, of P2, and of P3 and
                                    // the keepers

  // The thread's c-th column (c < tp::WIDE_CPT); none where it is >= Z,
  // which holds for whole warps.
  __device__ __forceinline__ int col(int c) const { return tid + c * T; }

  __device__ __forceinline__ WideEngine(const WideParams& p_, float* smem)
      : p(p_) {
    tid = threadIdx.x;
    Z = p.Z;
    nd = p.nd;
    staged = p.staged != 0;
    lane0 = blockIdx.x * L;
    float* a = smem + tp::ring_bytes(Z, SR) / 4;
    dqm = a;
    a1 = dqm + Z * DS;
    a2 = a1 + nd * DS;
    c2s = a2 + nd * DS;
    red = c2s + (staged ? Z * nd : 0);
    ctrl = reinterpret_cast<unsigned*>(red + WARPS * NRED * L);
    sn_k = reinterpret_cast<int*>(ctrl + 4);
    orig = sn_k + L;
    int* bnd = orig + L;  // nr, t0, t1
    float* st = p.scratch + static_cast<size_t>(blockIdx.x) * NSCR * Z * L;
#pragma unroll
    for (int l = 0; l < NLEAF; ++l)
      leaf[l] = st + static_cast<size_t>(l) * Z * L;
    d2t = st + static_cast<size_t>(NLEAF) * Z * L;
    if (tid == 0) {
      bnd[0] = 0;
      bnd[1] = Z;
      bnd[2] = 0;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < tp::WIDE_CPT; ++c) {
      const int j = col(c);
      if (j >= Z) break;
      if (p.rows[4][j] != 0.0f) atomicMax(&bnd[0], j + 1);
      if (p.rows[3][j] != 0.0f) {
        atomicMin(&bnd[1], j);
        atomicMax(&bnd[2], j + 1);
      }
    }
    __syncthreads();
    nr = bnd[0];
    t0 = bnd[1];
    t1 = bnd[2];
    // C2d's rows [0, nr), read by the first iteration's chains after its
    // first barrier
    if (staged) {
      for (int i = tid; i < nr * nd; i += T) c2s[i] = p.c2d[i];
    }
    // a ring of at least one row: with no real row M3p is zero
    tp::ring_init<SR>(ring, smem, p.m3p, Z, max(1, nr), 0, 0, tid, T);
  }

  __device__ __forceinline__ void tic(long long& t, int i) {
    if (TP_CLOCKS && tid == 0) {
      const long long now = clock64();
      clk[i] += now - t;
      t = now;
    }
  }

  // One iteration (tp::run_modes), as the narrow Engine's: lanes in
  // `frozen` keep all their state; what `idle` lanes hold is never read
  // again, and a group of 8 lanes that are all frozen or idle is skipped.
  // With CHECK, the keepers of the lanes in rmask record their residuals
  // and count kinc iterations, and the lanes whose three residuals meet
  // tol are returned (identical in every thread of the block).
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
    if constexpr (TC >= 2 && G >= 2) {
      if (packed && 2 * nl <= G)
        product<TC / 2>(dead);
      else
        product<TC>(dead);
    } else {
      product<TC>(dead);
    }
    const unsigned conv = finish<CHECK>(dead, frozen, rmask, kinc);
    tic(t, 3);
    fresh &= frozen;
    return conv;
  }

  // P1: z1 = clip(-q1 h1i); the deltas of the z2 product's inputs (dv2t on
  // the rows [t0, t1) alone, where mt is nonzero: it is 0 elsewhere).
  __device__ __forceinline__ void p1(unsigned dead, unsigned frozen) {
#pragma unroll 1
    for (int c = 0; c < tp::WIDE_CPT; ++c) {
      const int j = col(c);
      if (j >= Z) break;
      const float rm = __ldg(p.rows[0] + j), rht = __ldg(p.rows[1] + j),
                  mh = __ldg(p.rows[2] + j), mt = __ldg(p.rows[3] + j),
                  h1i = __ldg(p.rows[5] + j), lb = __ldg(p.rows[6] + j),
                  ub = __ldg(p.rows[7] + j);
      const float sg = mh - mt;
      const bool tail = j >= t0 && j < t1;
#pragma unroll 1
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
        tp::ld8<L>(z1s, leaf[Z1], j, g);
        if (tail) tp::ld8<L>(vt, leaf[V2T], j, g);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          float z1, v2m, v2t;
          p1_cell(rm, rht, mt, sg, h1i, lb, ub, z2b[b], z3[b], lm[b],
                  lht[b], x0[b], z1, v2m, v2t);
          dm[b] = v2m - vm[b];
          if (tail) dt[b] = v2t - vt[b];
          if (!bit(frozen, 8 * g + b)) {
            vm[b] = v2m;
            if (tail) vt[b] = v2t;
            z1s[b] = z1;
          }
        }
        tp::st8_dq<L>(dqm, j, g, dm);
        if (tail) {
          float4* d4 = reinterpret_cast<float4*>(d2t + j * L + 8 * g);
          d4[0] = make_float4(dt[0], dt[1], dt[2], dt[3]);
          d4[1] = make_float4(dt[4], dt[5], dt[6], dt[7]);
          tp::st8<L>(leaf[V2T], j, g, vt);
        }
        tp::st8<L>(leaf[V2M], j, g, vm);
        tp::st8<L>(leaf[Z1], j, g, z1s);
      }
    }
  }

  // The z2 chains of every (class, lane) of a live group, as the narrow
  // Engine's: a1 over rows [0, nr) of C2d, a2 over rows [t0, t1) of C2td,
  // each in ascending order.
  __device__ __forceinline__ void chains(unsigned dead) {
    const int n = nd * L;
    for (int ch = tid; ch < n; ch += T) {
      const int d = ch / L, b = ch % L;
      if (bit(dead, b)) continue;
      // a2 first: its few rows of C2td come from L2 while nothing waits
      const float* ct = p.c2td + d;
      float s2 = 0.0f;
#pragma unroll 8
      for (int i = t0; i < t1; ++i)
        s2 = fmaf(d2t[i * L + b], __ldg(ct + static_cast<size_t>(i) * nd),
                  s2);
      const float* dv = dqm + b;
      float s1 = 0.0f;
      if (staged) {
        const float* cm = c2s + d;
#pragma unroll 8
        for (int i = 0; i < nr; ++i) s1 = fmaf(dv[i * DS], cm[i * nd], s1);
      } else {
        const float* cm = p.c2d + d;
#pragma unroll 8
        for (int i = 0; i < nr; ++i)
          s1 = fmaf(dv[i * DS], __ldg(cm + i * nd), s1);
      }
      a1[d * DS + b] = s1;
      a2[d * DS + b] = s2;
    }
  }

  // The maxima over the warp of v (8 lanes of group g), to red's `slot`.
  __device__ __forceinline__ void warp_max(float (&v)[8], int slot, int g) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[b] = fmaxf(v[b], __shfl_xor_sync(FULL, v[b], off));
    }
    if ((tid & 31) == 0) {
      float4* w = reinterpret_cast<float4*>(
          red + ((tid >> 5) * NRED + slot) * L + 8 * g);
      w[0] = make_float4(v[0], v[1], v[2], v[3]);
      w[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }

  // P2: z2bn = (z2acc + a1) + a2 at each column's class; q3 and its delta
  // (into dqm); with CHECK the row maxima of |dz2|.
  template <bool CHECK>
  __device__ __forceinline__ void p2(unsigned dead, unsigned frozen) {
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float az[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) az[b] = 0.0f;
#pragma unroll 1
      for (int c = 0; c < tp::WIDE_CPT; ++c) {
        const int j = col(c);
        if (j >= Z) break;
        const float rm = __ldg(p.rows[0] + j), mr = __ldg(p.rows[4] + j);
        const int cls = __ldg(p.col_of + j);
        float z2b[8], lm[8], q3p[8], z1[8], c1[8], c2[8], dq[8];
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
                  ? __ldg(p.z2refb +
                          static_cast<size_t>(lane0 + orig[s]) * Z + j)
                  : z2b[b];
          float z2n, q3;
          p2_cell(rm, acc, c1[b], c2[b], z1[b], lm[b], z2n, q3);
          dq[b] = q3 - q3p[b];
          if (CHECK) az[b] = fmaxf(az[b], fabsf((z2n - z2b[b]) * mr));
          if (!bit(frozen, s)) {
            q3p[b] = q3;
            z2b[b] = z2n;
          }
        }
        tp::st8_dq<L>(dqm, j, g, dq);
        tp::st8<L>(leaf[Q3], j, g, q3p);
        tp::st8<L>(leaf[Z2B], j, g, z2b);
      }
      if (CHECK) warp_max(az, 1, g);
    }
  }

  // P3's product with tiles of 8 lanes x TCX columns: its sums dq3 @ M3p
  // into dqm once every thread is done reading dq3 there, published by a
  // second barrier.
  template <int TCX>
  __device__ __forceinline__ void product(unsigned dead) {
    const tp::Tile<L, TCX> tile(tid, Z);
    float acc[TCX][8];
#pragma unroll
    for (int q = 0; q < TCX; ++q) {
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[q][b] = 0.0f;
    }
    const bool live = tile.active && !bit(dead, 8 * tile.lg);
    tp::product<L, TCX, SR>(ring, dqm, tile, acc, live, tid, T, false,
                            [] {});
    __syncthreads();
    if (live) {
#pragma unroll
      for (int q = 0; q < TCX; ++q)
        tp::st8_dq<L>(dqm, tile.col(q), tile.lg, acc[q]);
    }
    __syncthreads();
  }

  // P3's rest, each thread its columns: z3n = z3acc + the product's sums,
  // the residual rows and the dual ascent; with CHECK their row maxima and
  // the keepers' part.
  template <bool CHECK>
  __device__ __forceinline__ unsigned finish(unsigned dead, unsigned frozen,
                                             unsigned rmask, int kinc) {
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      const unsigned fz = frozen >> (8 * g);
      const unsigned fr = fresh >> (8 * g);
      float pf[8], az[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) pf[b] = az[b] = 0.0f;
#pragma unroll 1
      for (int c = 0; c < tp::WIDE_CPT; ++c) {
        const int j = col(c);
        if (j >= Z) break;
        const float crm = __ldg(p.rows[0] + j), crht = __ldg(p.rows[1] + j),
                    cmh = __ldg(p.rows[2] + j), cmt = __ldg(p.rows[3] + j),
                    cmr = __ldg(p.rows[4] + j);
        float ac[8], z1[8], z2[8], z3[8], lm[8], lht[8], x0[8];
        tp::ld8_dq<L>(ac, dqm, j, g);
        tp::ld8<L>(z1, leaf[Z1], j, g);
        tp::ld8<L>(z2, leaf[Z2B], j, g);
        tp::ld8<L>(z3, leaf[Z3], j, g);
        tp::ld8<L>(lm, leaf[LM], j, g);
        tp::ld8<L>(lht, leaf[LHT], j, g);
        tp::ld8<L>(x0, leaf[X0], j, g);
#pragma unroll
        for (int b = 0; b < 8; ++b)
          p3_cell<CHECK>(crm, crht, cmh, cmt, cmr, fr, fz, b, ac[b], z1[b],
                         z2[b], x0[b], z3[b], lm[b], lht[b], pf[b], az[b]);
        tp::st8<L>(leaf[Z3], j, g, z3);
        tp::st8<L>(leaf[LM], j, g, lm);
        tp::st8<L>(leaf[LHT], j, g, lht);
      }
      if (CHECK) {
        warp_max(pf, 0, g);
        warp_max(az, 2, g);
      }
    }
    // without CHECK the next iteration's first barrier comes before any
    // thread reads what another wrote here
    if (!CHECK) return 0u;
    __syncthreads();
    if (tid < 32) keep(rmask, kinc);
    __syncthreads();
    return ctrl[0];
  }

  // The keepers' part of a checked iteration, run by all of warp 0: lane
  // t's three residuals over the warps' maxima; the lanes that meet tol go
  // to ctrl[0].
  __device__ __forceinline__ void keep(unsigned rmask, int kinc) {
    bool conv = false;
    if (tid < L) {
      float r[NRED] = {0.0f, 0.0f, 0.0f};
      for (int w = 0; w < WARPS; ++w) {
#pragma unroll
        for (int q = 0; q < NRED; ++q)
          r[q] = fmaxf(r[q], red[(w * NRED + q) * L + tid]);
      }
      conv = r[0] <= p.tol && r[1] <= p.tol && r[2] <= p.tol;
      if (bit(rmask, tid)) {
        kp.k += kinc;
#pragma unroll
        for (int q = 0; q < NRED; ++q) kp.r[q] = r[q];
      }
    }
    const unsigned m = __ballot_sync(FULL, conv);
    if (tid == 0) ctrl[0] = m;
  }

  // Exact-k compaction (tp::compact_lanes) over the seven snapshot leaves
  // and x0b of the thread's columns. No slot is fresh here: a window start
  // that compacts follows a whole window of every lane's iterations.
  __device__ __forceinline__ unsigned compact(unsigned done) {
    const unsigned live = ~done & ALL;
    const int n = __popc(live);
    if (__popc(tp::whole_groups<L>(done)) / 8 == (L - n) / 8) return done;
    float* const moved[NSNAP + 1] = {leaf[Z2B], leaf[Z3],  leaf[LM],
                                     leaf[LHT], leaf[V2M], leaf[V2T],
                                     leaf[Q3],  leaf[X0]};
#pragma unroll
    for (int c = 0; c < tp::WIDE_CPT; ++c) {
      const int j = col(c);
      if (j >= Z) break;
#pragma unroll
      for (int l = 0; l < NSNAP + 1; ++l) {
        int to = 0;
        for (int s = 0; s < L; ++s) {
          if (!bit(live, s)) continue;
          if (s != to) tp::at<L>(moved[l], j, to) = tp::at<L>(moved[l], j, s);
          ++to;
        }
      }
    }
    if (tid == 0) {
      int to = 0;
      for (int s = 0; s < L; ++s) {
        if (!bit(live, s)) continue;
        orig[to++] = orig[s];
      }
    }
    __syncthreads();
    return ALL & ~((1u << n) - 1u);
  }

  // Exact-k: the thread's columns of the seven snapshot leaves between its
  // scratch and the lanes' snapshots, for the slots in `lanes` (slot b
  // holds lane orig[b]). Reading them back (every lane in its own slot
  // again) also restores x0b, zeroes z1 and marks the lanes whose window
  // starts at 0 fresh.
  template <bool TO_GLOBAL>
  __device__ __forceinline__ void snapshot(unsigned lanes) {
#pragma unroll
    for (int c = 0; c < tp::WIDE_CPT; ++c) {
      const int j = col(c);
      if (j >= Z) break;
#pragma unroll
      for (int l = 0; l < NSNAP; ++l) {
        for (int b = 0; b < L; ++b) {
          if (!bit(lanes, b)) continue;
          float* g = p.snap +
                     (static_cast<size_t>(lane0 + orig[b]) * NSNAP + l) * Z +
                     j;
          float& sh = tp::at<L>(leaf[l], j, b);
          if (TO_GLOBAL)
            *g = sh;
          else
            sh = *g;
        }
      }
      if (!TO_GLOBAL) {
        for (int b = 0; b < L; ++b) {
          tp::at<L>(leaf[X0], j, b) =
              p.x0b[static_cast<size_t>(lane0 + b) * Z + j];
          tp::at<L>(leaf[Z1], j, b) = 0.0f;
        }
      }
    }
    if (!TO_GLOBAL) {
      fresh = 0;
      for (int b = 0; b < L; ++b)
        if (sn_k[b] == 0) fresh |= 1u << b;
      __syncthreads();
    }
  }
};

template <int L, int TC, int SR>
__global__ void __launch_bounds__(tp::WIDE_THREADS, 1)
    fused_eadmm_wide_kernel(WideParams p) {
  extern __shared__ __align__(16) float smem[];
  WideEngine<L, TC, SR> e(p, smem);
  const int Z = p.Z;
  // state: z2b0, z30, lm0, lht0, zero previous inputs, zero z1, x0b
  const float* src[NLEAF] = {p.z2b0,  p.z30,   p.lm0,   p.lht0, nullptr,
                             nullptr, nullptr, nullptr, p.x0b};
#pragma unroll
  for (int c = 0; c < tp::WIDE_CPT; ++c) {
    const int j = e.col(c);
    if (j >= Z) break;
#pragma unroll
    for (int l = 0; l < NLEAF; ++l) {
      for (int b = 0; b < L; ++b)
        tp::at<L>(e.leaf[l], j, b) =
            src[l] ? src[l][static_cast<size_t>(e.lane0 + b) * Z + j] : 0.0f;
    }
  }
  if (e.tid < L) {
    e.sn_k[e.tid] = 0;
    e.orig[e.tid] = e.tid;
  }
  __syncthreads();
  const unsigned done =
      tp::run_modes<L>(e, p.k_max, p.check_every, p.exact_k, 0);
  tp::ring_drain(e.ring);
  const int leaves[5] = {Z1, Z2B, Z3, LM, LHT};
#pragma unroll
  for (int c = 0; c < tp::WIDE_CPT; ++c) {
    const int j = e.col(c);
    if (j >= Z) break;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      for (int b = 0; b < L; ++b)
        p.out[l][static_cast<size_t>(e.lane0 + b) * Z + j] =
            tp::at<L>(e.leaf[leaves[l]], j, b);
    }
  }
  if (e.tid < L) {
    const int lane = e.lane0 + e.tid;
    p.k[lane] = e.kp.k;
    p.done[lane] = bit(done, e.tid) ? 1 : 0;
#pragma unroll
    for (int q = 0; q < NRED; ++q) p.res[q][lane] = e.kp.r[q];
  }
  if (TP_CLOCKS && e.tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p.ext[4 * blockIdx.x + i] = static_cast<int>(e.clk[i] >> 10);
  }
}

template <int L, int SR>
int wide_launch(const WideParams& p, int blocks, int smem, void* stream) {
  void (*kernel)(WideParams) =
      fused_eadmm_wide_kernel<L, tp::wide_tc<L>(), SR>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, tp::WIDE_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared bytes of a block of the wide build at `lanes` lanes and nd
// classes of columns (kernels/fused_eadmm.py shared_bytes(Z, lanes, nd,
// wide=True) computes the same).
extern "C" long fused_eadmm_wide_smem(int Z, int lanes, int nd) {
  return wide_bytes(Z, lanes, nd, wide_slab_rows(Z, lanes, nd),
                    wide_staged(Z, lanes, nd));
}

// Launch the wide build on `stream`: the arguments of fused_eadmm_launch
// with `scratch`, the blocks' leaves and dv2t (B / lanes x 10 Z lanes
// floats), before
// `ext`; `threads` tp::WIDE_THREADS, `lanes` 8 or 16, Z up to
// tp::WIDE_COLS, B / lanes blocks. The geometry comes from the wrapper
// (kernels/fused_eadmm.py launch_plan with wide=True) and is checked here
// again. Returns the CUDA error of the launch, as an int.
extern "C" int fused_eadmm_wide_launch(
    const float* x0b, const float* z2refb, const float* z2b0,
    const float* z30, const float* lm0, const float* lht0, const float* c2d,
    const float* c2td, const int* col_of, const float* m3p, const float* rm,
    const float* rht, const float* mh, const float* mt, const float* mr,
    const float* h1i, const float* lb, const float* ub, float* z1,
    float* z2b, float* z3, float* lm, float* lht, int* k, int* done,
    float* rpf, float* rz2, float* rz3, float* snap, float* scratch,
    int* ext, int B, int Z, int nd, int lanes, int blocks, int threads,
    int smem, float tol, int k_max, int check_every, int exact_k,
    void* stream) {
  const bool exact = check_every > 1 && exact_k;
  if (Z <= 0 || Z % 32 != 0 || Z > tp::WIDE_COLS || nd < 1 || nd > Z ||
      (lanes != 8 && lanes != 16) || B % lanes != 0 ||
      blocks != B / lanes || threads != tp::WIDE_THREADS ||
      smem != fused_eadmm_wide_smem(Z, lanes, nd) || smem > tp::SMEM_MAX ||
      check_every < 1 || k_max < 1 ||
      (B > 0 && (scratch == nullptr || ext == nullptr ||
                 (exact && snap == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  WideParams p{x0b, z2refb, z2b0, z30, lm0, lht0, c2d, c2td, col_of, m3p,
               {rm, rht, mh, mt, mr, h1i, lb, ub},
               {z1, z2b, z3, lm, lht}, k, done, {rpf, rz2, rz3}, snap,
               scratch, ext, Z, nd, wide_staged(Z, lanes, nd), tol, k_max,
               check_every, exact_k};
  if (lanes == 8)
    return wide_launch<8, tp::WIDE_SLAB_8>(p, blocks, smem, stream);
  if (wide_slab_rows(Z, lanes, nd) == tp::WIDE_SLAB_16)
    return wide_launch<16, tp::WIDE_SLAB_16>(p, blocks, smem, stream);
  return wide_launch<16, tp::WIDE_SLAB_8>(p, blocks, smem, stream);
}

#endif  // WIDE_PART
