// Fused two-block split (S)ADMM for HMPC-ADMM-split and HMPC-SADMM-split on
// NVIDIA Hopper (sm_90a), written by hand: the parent of csrc/fused_split.cu,
// its first layout (8 lanes a block, one column a thread, M1' from L2),
// which no wrapper launches. tools/ab_kernels.py holds every build of
// csrc/fused_split.cu to it bit for bit and times the two in turns. Its wide
// build stays in csrc/fused_split.cu.
//
// Like csrc/fused_split.cu it replaces the Pallas TPU kernel
// spcies_tpu/kernels/fused_split.py::_fused_split_kernel. It computes what
// that kernel computes, mode for mode (checked, free-run, exact-k with
// window replay): for every lane of the batch, in the layout [z (dim_p) |
// s], the whole split loop
//
//     lm_h   = lm + alpha scale (aux - zs_old)      (SADMM: the half-step
//                                                    with the previous (z,
//                                                    s), code_HMPC_ADMM_
//                                                    split_C.c:215-225)
//     w      = aux + iscale lm_h
//     zs     = clip(w, lb, ub)                      on the head columns
//     zs     = SOC, or diamond (a=+1 at lby, then a=-1 at uby), of each
//              cone's (y0, y1, y2)                  on the cone lanes
//     lm'    = lm_h + alpha scale (aux - zs)
//     dq     = (lm' - lm) - scale (zs - zs_old)      (the JAX kernel's order)
//     aux   += dq @ M1'
//     r_p    = max|aux - zs|, r_d = max|zs - zs_old|
//
// until the lane meets tol or k_max (alpha = 1 for ADMM). The wrapper and
// the plain PyTorch version of every mode are in kernels/fused_split.py.
//
// This is K5's kernel (csrc/fused_soc.cu) with four changes: the alpha
// half-step, alpha in the dual update, a clip with per-column bounds on
// every column that is not a cone's (the z slab with the harmonic
// references free at +-3e38, the s slab's box rows in output mode), and
// a projection of cones in place of one SOC.
//
// Layout. One thread block per TB = 8 lanes; one thread per column j of the
// padded width P (at most 512; 320 at N=30: z 258 -> 288, one warp of 8
// cones). Thread j owns column j of the four state vectors (aux, the
// consumed aux, zs, lm) for the block's TB lanes, in shared memory that
// only thread j touches. The cones lie in whole warps from column cone0, g
// <= 10 cones a warp, cone c's y0, y1, y2 at lanes c, g + c, 2g + c: each
// lane of a cone reads its cone's three entries by warp shuffles and
// computes the projection itself (the three lanes of a cone do the same
// arithmetic on the same values), in the blended form of the JAX kernel's
// _proj_ssoc_seg, with no barrier. As in K5, an iteration has one
// __syncthreads, after the deltas dq are stored to shared memory as
// [P][TB] (and, at a checked iteration, the warps' row maxima), both
// double-buffered by iteration parity; then thread j forms
// aux[b][j] += sum_i dq[b][i] M1'[i][j]. dq is exactly 0 on the pad
// columns (iscale = 0 there), so the product reads only the real rows:
// those below the z slab's last real column and from dim_p to the s slab's
// last real column (282 of 320 at N=30), found from iscale by each block
// before its loop. Every thread reads the same row maxima after the
// product, so loop control is uniform across a block; lanes that are done
// are frozen by a mask and keep all their state. Up to 320 columns the
// kernel is compiled for three blocks an SM (at most 64 registers, 444
// bytes of spills), which at N=30 on an NVIDIA H100 ran faster than two
// blocks, as K5 is compiled (96 registers), or one (tools/ab_kernels.py;
// the times are in PERF.md, K7).
//
// Bound. Every block re-reads the real rows of M1' (282 x 320 at N=30, 361
// KB) from L2 on every iteration, for 2 TB FLOP per 4 bytes read; M1' stays
// in the 50 MB L2. The product is an fmaf chain in row order, unrolled 8
// deep to keep 8 L2 loads in flight per thread.
//
// Arithmetic. fp32 on the CUDA cores, no TF32. The library is built with
// -fmad=false, so the element-wise steps (sqrtf and the division included)
// round as PyTorch's separate operations do; the product uses explicit
// fmaf.
//
// Exact-k snapshots. At each window start aux, zs and lm of every lane not
// yet done go to global scratch (each thread writes, and later reads back,
// only its own column), and the window start to shared memory; the replay
// runs each lane's last window with the checked semantics and the budget
// min(C, k_max - kws), as K1-K5 do.
//
// Padding. Pad columns carry zero rows and columns of M1', [0, 0] bounds
// and iscale = 0, so they stay exactly 0 (a pad cone slot projects a zero
// triple onto zero) and add nothing to the row maxima.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 8;          // lanes per block
constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr int NARROW = 320;    // up to this width, three blocks an SM
constexpr int MAX_G = 10;      // cones a warp (MAX_CONES_PER_WARP)
constexpr int NSNAP = 3;       // snapshot leaves (SNAP_LEAVES in the wrapper)
constexpr int UNROLL = 8;      // L2 loads in flight per thread
constexpr float RBIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ALL = (1u << TB) - 1u;
static_assert(TB % 4 == 0, "vectors are moved as float4");

struct Params {
  const float* __restrict__ aux1;
  const float* __restrict__ zs0;
  const float* __restrict__ lm0;
  const float* __restrict__ m1p;     // [P][P], row-major, dq @ m1p
  const float* __restrict__ lb;      // [P]: clip bounds, a cone's lby
  const float* __restrict__ ub;      // [P]: clip bounds, a cone's uby
  const float* __restrict__ scale;   // [P]: sigma | rho
  const float* __restrict__ iscale;  // [P]: 1/sigma | 1/rho, 0 on pads
  float* zs;
  float* lm;
  float* aux;
  int* k;
  int* done;
  float* rp;
  float* rd;
  float* snap;  // exact-k: per lane [aux | zs | lm]
  int P, dim_p, cone0, cone_g, symmetric, use_soc;
  float alpha, tol_p, tol_d;
  int k_max, check_every, exact_k;
};

// Shared memory: the product's input and the warps' row maxima, read by
// every thread; the state columns, each read and written by its own thread.
struct Shared {
  float* dq;     // [2][P][TB]
  float* red;    // [2][warps][2][TB]
  float* st[4];  // [P][TB] each, the leaves below
};
// the state leaves; the first NSNAP are the snapshot's, in its order
enum { AUX, ZS, LM, AUXC };  // aux (prepared), zs, lm, the consumed aux

// What thread j knows of its column.
struct Col {
  int j;
  int z_end, s_end;  // the product reads rows [0, z_end) and [dim_p, s_end)
  int warps;
  bool cone_warp;    // j in a warp of cones: the warp shuffles
  bool cone;         // j holds an entry of a cone (lane < 3g)
  int src, seg;      // the lane of its cone's y0; which entry it holds
  float lb, ub, scale, iscale;
};

__device__ __forceinline__ bool bit(unsigned m, int b) {
  return (m >> b) & 1u;
}

__device__ __forceinline__ void load(float (&v)[TB], const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < TB / 4; ++q) {
    const float4 a = s4[q];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

__device__ __forceinline__ void store(float* dst, const float (&v)[TB]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < TB / 4; ++q)
    d4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// The maxima of v[b] over the warp, written to red[warp][slot][b] by the
// warp's first thread.
__device__ __forceinline__ void warp_max(float (&v)[TB], float* red, int j,
                                         int slot) {
#pragma unroll
  for (int b = 0; b < TB; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[b] = fmaxf(v[b], __shfl_xor_sync(FULL, v[b], off));
  }
  if ((j & 31) == 0) store(red + ((j >> 5) * 2 + slot) * TB, v);
}

// acc[b] += sum_{i0 <= i < i1} dq[i][b] m[i][j], UNROLL L2 loads in flight.
__device__ __forceinline__ void product(const float* dq_s,
                                        const float* __restrict__ m, int ld,
                                        int i0, int i1, int j,
                                        float (&acc)[TB]) {
  const float* col = m + j;
#pragma unroll UNROLL
  for (int i = i0; i < i1; ++i) {
    const float w = __ldg(col + static_cast<size_t>(i) * ld);
    const float4* d4 = reinterpret_cast<const float4*>(dq_s + i * TB);
#pragma unroll
    for (int q = 0; q < TB / 4; ++q) {
      const float4 d = d4[q];
      acc[4 * q] = fmaf(d.x, w, acc[4 * q]);
      acc[4 * q + 1] = fmaf(d.y, w, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(d.z, w, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(d.w, w, acc[4 * q + 3]);
    }
  }
}

// Projection onto {||(y1, y2)|| <= a (y0 - dd)}, a in {-1, +1}, in
// _proj_ssoc_seg's blended form (as csrc/fused_hmpc.cu).
__device__ __forceinline__ void proj_ssoc(float& y0, float& y1, float& y2,
                                          float a, float dd) {
  const float ny1 = sqrtf(y1 * y1 + y2 * y2);
  const float corr = a * (y0 - dd);
  const float inside = ny1 <= corr ? 1.0f : 0.0f;
  const float apex = (ny1 <= -corr ? 1.0f : 0.0f) * (1.0f - inside);
  const float proj = (1.0f - inside) * (1.0f - apex);
  const float safe = fmaxf(ny1, 1e-30f);
  const float step = (corr + ny1) / (2.0f * safe);
  const float z0 = inside * y0 + apex * dd + proj * (step * ny1 * a + dd);
  const float z1 = inside * y1 + proj * (step * y1);
  const float z2 = inside * y2 + proj * (step * y2);
  y0 = z0;
  y1 = z1;
  y2 = z2;
}

// One iteration of column j for the block's TB lanes. Lanes in `frozen`
// keep all their state. With CHECK, returns the lanes whose residuals meet
// tol (identical in every thread of the block), and thread 0 records the
// residuals of the lanes in `rmask` in lres.
template <bool CHECK>
__device__ __forceinline__ unsigned iterate(const Params& p, const Shared& s,
                                            const Col& c, int& parity,
                                            unsigned frozen, unsigned rmask,
                                            float (&lres)[2][TB]) {
  const int o = c.j * TB;  // this thread's column in every buffer
  float* dq_s = s.dq + parity * p.P * TB;
  float* red = s.red + parity * c.warps * 2 * TB;
  float aux[TB], zs[TB], lm[TB], lh[TB], zn[TB];
  load(aux, s.st[AUX] + o);
  load(zs, s.st[ZS] + o);
  load(lm, s.st[LM] + o);
  const float as = p.alpha * c.scale;
  {
    float w[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      lh[b] = p.symmetric ? lm[b] + as * (aux[b] - zs[b]) : lm[b];
      w[b] = aux[b] + c.iscale * lh[b];
    }
    if (c.cone_warp) {
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        float y0 = __shfl_sync(FULL, w[b], c.src);
        float y1 = __shfl_sync(FULL, w[b], c.src + p.cone_g);
        float y2 = __shfl_sync(FULL, w[b], c.src + 2 * p.cone_g);
        if (p.use_soc) {
          proj_ssoc(y0, y1, y2, 1.0f, 0.0f);
        } else {
          proj_ssoc(y0, y1, y2, 1.0f, c.lb);
          proj_ssoc(y0, y1, y2, -1.0f, c.ub);
        }
        const float v = c.seg == 0 ? y0 : (c.seg == 1 ? y1 : y2);
        zn[b] = c.cone ? v : fminf(fmaxf(w[b], c.lb), c.ub);
      }
    } else {
#pragma unroll
      for (int b = 0; b < TB; ++b) zn[b] = fminf(fmaxf(w[b], c.lb), c.ub);
    }
  }
  {
    float dq[TB], ap[TB], ad[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float lmn = lh[b] + as * (aux[b] - zn[b]);
      const float dd = zn[b] - zs[b];
      dq[b] = (lmn - lm[b]) - c.scale * dd;
      if (CHECK) {
        ap[b] = fabsf(aux[b] - zn[b]);
        ad[b] = fabsf(dd);
      }
      if (!bit(frozen, b)) {
        lm[b] = lmn;
        zs[b] = zn[b];
      }
    }
    store(dq_s + o, dq);
    store(s.st[ZS] + o, zs);
    store(s.st[LM] + o, lm);
    if (CHECK) {
      warp_max(ap, red, c.j, 0);
      warp_max(ad, red, c.j, 1);
    }
  }
  __syncthreads();
  float acc[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) acc[b] = 0.0f;
  product(dq_s, p.m1p, p.P, 0, c.z_end, c.j, acc);
  product(dq_s, p.m1p, p.P, p.dim_p, c.s_end, c.j, acc);
  {
    float ac[TB];
    load(ac, s.st[AUXC] + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (!bit(frozen, b)) {
        ac[b] = aux[b];
        aux[b] = aux[b] + acc[b];
      }
    }
    store(s.st[AUX] + o, aux);
    store(s.st[AUXC] + o, ac);
  }
  parity ^= 1;
  unsigned conv = 0;
  if (CHECK) {
    float rs[2][TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      rs[0][b] = 0.0f;
      rs[1][b] = 0.0f;
    }
    for (int w = 0; w < c.warps; ++w) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float m[TB];
        load(m, red + (w * 2 + q) * TB);
#pragma unroll
        for (int b = 0; b < TB; ++b) rs[q][b] = fmaxf(rs[q][b], m[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (rs[0][b] <= p.tol_p && rs[1][b] <= p.tol_d) conv |= 1u << b;
      if (c.j == 0 && bit(rmask, b)) {
        lres[0][b] = rs[0][b];
        lres[1][b] = rs[1][b];
      }
    }
  }
  return conv;
}

// Copy this thread's column of aux, zs and lm between shared memory and the
// per-lane [aux | zs | lm] layout in global memory, for the lanes in
// `lanes`. TO_GLOBAL selects the direction.
template <bool TO_GLOBAL>
__device__ __forceinline__ void snapshot(const Params& p, const Shared& s,
                                         int j, int lane0, unsigned lanes) {
#pragma unroll
  for (int l = 0; l < NSNAP; ++l) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (!bit(lanes, b)) continue;
      float* g = p.snap + static_cast<size_t>(lane0 + b) * NSNAP * p.P +
                 l * p.P + j;
      float* sh = s.st[l] + j * TB + b;
      if (TO_GLOBAL)
        *g = *sh;
      else
        *sh = *g;
    }
  }
}

template <int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) fused_split_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sn_k[TB];       // exact-k: each lane's window start
  __shared__ float lres[2][TB];  // thread 0's residuals of each lane
  __shared__ int bounds[2];      // z_end, s_end
  const int P = p.P;
  const int j = threadIdx.x;
  Shared s;
  s.dq = smem;
  s.red = smem + 2 * P * TB;
  {
    float* a = s.red + 2 * (P / 32) * 2 * TB;
    for (int l = 0; l < 4; ++l, a += P * TB) s.st[l] = a;
  }
  Col c;
  c.j = j;
  c.warps = P >> 5;
  c.scale = p.scale[j];
  c.iscale = p.iscale[j];
  c.lb = p.lb[j];
  c.ub = p.ub[j];
  c.cone_warp = j >= p.cone0;
  {
    const int lane = j & 31;
    c.cone = c.cone_warp && lane < 3 * p.cone_g;
    c.seg = lane / p.cone_g;
    c.src = lane % p.cone_g;
  }
  if (j == 0) {
    bounds[0] = 0;
    bounds[1] = p.dim_p;
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      lres[0][b] = RBIG;
      lres[1][b] = RBIG;
    }
  }
  __syncthreads();
  if (c.iscale != 0.0f) atomicMax(&bounds[j < p.dim_p ? 0 : 1], j + 1);
  __syncthreads();
  c.z_end = bounds[0];
  c.s_end = bounds[1];
  const int lane0 = blockIdx.x * TB;
  const int o = j * TB;
  {
    float aux[TB], zs[TB], lm[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const size_t g = static_cast<size_t>(lane0 + b) * P + j;
      aux[b] = p.aux1[g];
      zs[b] = p.zs0[g];
      lm[b] = p.lm0[g];
    }
    store(s.st[AUX] + o, aux);
    store(s.st[AUXC] + o, aux);
    store(s.st[ZS] + o, zs);
    store(s.st[LM] + o, lm);
  }
  int parity = 0;
  unsigned done = 0;
  int k[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) k[b] = 0;
  const int C = p.check_every;
  int aout = AUXC;  // the leaf written out as aux: the consumed aux ...

  if (C > 1 && p.exact_k) {
    // free-run windows of C iterations; snapshot every still-active lane
    // at each window start, so the window a lane converges in can be
    // replayed with per-iteration checks once the block has drained.
    // Windows may overshoot k_max: the replay budget cuts each lane off at
    // exactly k_max.
    for (int it = 0; it < p.k_max && done != ALL; it += C) {
      snapshot<true>(p, s, j, lane0, ~done & ALL);
      if (j == 0) {
#pragma unroll
        for (int b = 0; b < TB; ++b)
          if (!bit(done, b)) sn_k[b] = it;
      }
      for (int f = 0; f < C - 1; ++f)
        iterate<false>(p, s, c, parity, 0u, 0u, lres);
      done |= iterate<true>(p, s, c, parity, 0u, 0u, lres);
    }
    __syncthreads();  // the window starts, written by thread 0
    // replay each lane's last window from its snapshot with per-iteration
    // checks: k counts on from the window start
    snapshot<false>(p, s, j, lane0, ALL);
    {
      float aux[TB];
      load(aux, s.st[AUX] + o);
      store(s.st[AUXC] + o, aux);
    }
    int budget[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      k[b] = sn_k[b];
      budget[b] = min(C, p.k_max - k[b]);
    }
    unsigned convd = 0;
    for (int w = 0; w < C; ++w) {
      unsigned frozen = convd;
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (w >= budget[b]) frozen |= 1u << b;
      if (frozen == ALL) break;
      const unsigned conv =
          iterate<true>(p, s, c, parity, frozen, ~frozen & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(frozen, b)) ++k[b];
      convd |= conv & ~frozen;
    }
    done = convd;
  } else if (C > 1) {
    // free-run: C-1 plain iterations, then one checked iteration; every
    // lane keeps iterating until the block's lanes are all done, k is
    // recorded at check granularity, and a done lane's residuals stay at
    // its exit
    for (int it = 0; it < p.k_max && done != ALL;) {
      const int n_fast = min(C - 1, p.k_max - 1 - it);
      for (int f = 0; f < n_fast; ++f)
        iterate<false>(p, s, c, parity, 0u, 0u, lres);
      const unsigned conv =
          iterate<true>(p, s, c, parity, 0u, ~done & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(done, b)) k[b] += n_fast + 1;
      done |= conv;
      it += n_fast + 1;
    }
    aout = AUX;  // ... but the prepared one in free-run
  } else {
    // checked: exit tests every iteration; a converged lane freezes and
    // keeps the aux it consumed at exit
    for (int it = 0; it < p.k_max && done != ALL; ++it) {
      const unsigned conv =
          iterate<true>(p, s, c, parity, done, ~done & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(done, b)) ++k[b];
      done |= conv;
    }
  }

  {
    const int leaves[3] = {ZS, LM, aout};
    float* outs[3] = {p.zs, p.lm, p.aux};
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      float x[TB];
      load(x, s.st[leaves[l]] + o);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        outs[l][static_cast<size_t>(lane0 + b) * P + j] = x[b];
    }
  }
  if (j == 0) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      p.k[lane0 + b] = k[b];
      p.done[lane0 + b] = bit(done, b) ? 1 : 0;
      p.rp[lane0 + b] = lres[0][b];
      p.rd[lane0 + b] = lres[1][b];
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t): B / 8 blocks of P threads and the
// shared bytes 4 * 8 * (6 P + 4 P / 32), checked here.
// Returns the CUDA error of the launch, as an int.
extern "C" int fused_split_launch(
    const float* aux1, const float* zs0, const float* lm0, const float* m1p,
    const float* lb, const float* ub, const float* scale,
    const float* iscale, float* zs, float* lm, float* aux, int* k,
    int* done, float* rp, float* rd, float* snap, int B, int P, int dim_p,
    int cone0, int cone_g, int symmetric, int use_soc, int blocks,
    int threads, int smem, float alpha, float tol_p, float tol_d, int k_max,
    int check_every, int exact_k, void* stream) {
  const long need = 4L * TB * (6L * P + 4L * (P / 32));
  const bool exact = check_every > 1 && exact_k;
  if (P <= 0 || P % 32 != 0 || P > MAX_COLS || dim_p <= 0 ||
      dim_p % 32 != 0 || cone0 < dim_p || cone0 % 32 != 0 || cone0 >= P ||
      cone_g < 1 || cone_g > MAX_G || B % TB != 0 || blocks != B / TB ||
      threads != P ||
      smem != need || check_every < 1 || k_max < 1 ||
      (exact && B > 0 && snap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  // up to NARROW columns, compiled for three blocks an SM (at most 64
  // registers a thread), wider for one block of up to MAX_COLS threads
  void (*kernel)(Params) = P <= NARROW ? fused_split_kernel<NARROW, 3>
                                       : fused_split_kernel<MAX_COLS, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Params p{aux1,  zs0,   lm0,    m1p,       lb,      ub,    scale, iscale,
           zs,    lm,    aux,    k,         done,    rp,    rd,    snap,
           P,     dim_p, cone0,  cone_g,    symmetric, use_soc, alpha,
           tol_p, tol_d, k_max,  check_every, exact_k};
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
