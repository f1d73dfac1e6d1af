// Fused single-split cone ADMM for HMPC-ADMM and ellipHMPC-ADMM on NVIDIA
// Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
// spcies_tpu/kernels/fused_hmpc.py::_fused_hmpc_kernel (with its
// _proj_ssoc_seg). It computes what that kernel computes, mode for mode
// (checked, free-run, exact-k with window replay): for every lane of the
// batch, with z [dim_p] and s, lam [ns_p], the whole loop
//
//     czd  = z @ CT - d
//     y    = -czd - rho^-1 lam
//     s    = clip(y, lb, ub)                      on the box rows
//     s    = SOC, or diamond (a=+1 at lby, then a=-1 at uby), of each
//            cone's (y0, y1, y2)                  on the cone lanes
//     lam += rho (czd + s)
//     w    = rho (s - s_old) + rho (czd + s)
//     z   += w @ MC                               (MC = C M1')
//     r_p  = max|czd + s|, r_d = max|s - s_old|
//
// until the lane meets tol or k_max. The wrapper and the plain PyTorch
// version of every mode are in kernels/fused_hmpc.py.
//
// Layout. One thread block per TB = 8 lanes; one thread per column of the
// wider of the two padded widths (dim_p for z, ns_p for s; at most 512, 288
// at N=30). Thread j owns z column j and s column j: it forms czd, s, lam
// and w of s column j, then z of z column j. The prepared z and w are read
// by every thread and live in shared memory as [columns][TB]; the consumed
// z, s and lam are read and written by their own thread only, in shared
// memory too (K5's layout, csrc/fused_soc.cu: it leaves the registers to
// the products' loads in flight). An iteration has two barriers, one after
// each half: w must be whole before z's product, and z before the next
// czd. Up to 320 columns the kernel is compiled for three blocks an SM (at
// most 64 registers, about 1 KB of spills a thread), which at N=30 on an
// NVIDIA H100 ran faster than two blocks (96 registers, 588 bytes of
// spills) or one (tools/ab_kernels.py; the times are in PERF.md, K6).
//
// The cones. A projection couples a cone's three entries, which the TPU
// kernel keeps in three 128-lane segments. Here the adapter lays the cones
// out in whole warps from column cone0, g <= 10 cones a warp, cone c's y0,
// y1, y2 at lanes c, g + c, 2g + c: each lane of a cone reads its cone's
// three entries by warp shuffles and computes the projection itself (the
// three lanes of a cone do the same arithmetic on the same values, so they
// agree), with no barrier. The blended inside / apex / boundary sums of
// _proj_ssoc_seg are kept as they are.
//
// Bytes. C is sparse: in box mode a box row of CT is one -1, and the cone
// rows touch only the 3 (n + m) harmonic entries of z. Each thread finds,
// once, the rows of its CT column that can be nonzero (first to last
// nonzero) and sums only those: a skipped term is an exact 0, so no sum
// changes. Of MC = C M1' (dense), the product reads the rows of real
// constraints only: [0, box_end) and [cone0, s_end), found from CT by each
// block before its loop (258 of 288 at N=30). Every block re-reads those
// rows (297 KB at N=30) from L2 each iteration; MC stays in the 50 MB L2.
// Both products are fmaf chains in row order, the second unrolled 8 deep
// to keep 8 L2 loads in flight per thread.
//
// Arithmetic. fp32 on the CUDA cores, no TF32: z is an O(1) operand of the
// first product, where a truncated product would floor the residual near
// 1e-3 (the JAX kernel pins it to HIGHEST). The library is built with
// -fmad=false, so the element-wise steps (sqrtf and the division included)
// round as PyTorch's separate operations do; the products use explicit
// fmaf.
//
// Exact-k snapshots. At each window start z, s and lam of every lane not
// yet done go to global scratch (each thread writes, and later reads back,
// only its own columns), and the window start to shared memory; the replay
// runs each lane's last window with the checked semantics and the budget
// min(C, k_max - kws), as K1-K5 do.
//
// Padding. Pad columns carry zero rows and columns of CT and MC, d = 0 and
// [0, 0] bounds; a pad cone slot projects a zero triple onto zero. So pad
// state stays exactly 0 and adds nothing to the row maxima.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 8;          // lanes per block (CTA_LANES in the wrapper)
constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr int NARROW = 320;    // up to this width, three blocks an SM
constexpr int MAX_G = 10;      // cones a warp (MAX_CONES_PER_WARP)
constexpr int UNROLL = 8;      // L2 loads in flight per thread
constexpr float RBIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ALL = (1u << TB) - 1u;
static_assert(TB % 4 == 0, "vectors are moved as float4");

struct Params {
  const float* __restrict__ z1;
  const float* __restrict__ s0;
  const float* __restrict__ lam0;
  const float* __restrict__ ct;  // [dim_p][ns_p], row-major, z @ ct
  const float* __restrict__ mc;  // [ns_p][dim_p], row-major, w @ mc
  const float* __restrict__ d;   // [ns_p]
  const float* __restrict__ lb;  // [ns_p]: box bounds, a cone's lby
  const float* __restrict__ ub;  // [ns_p]: box bounds, a cone's uby
  float* z;
  float* s;
  float* lam;
  int* k;
  int* done;
  float* rp;
  float* rd;
  float* snap;  // exact-k: per lane [z (dim_p) | s (ns_p) | lam (ns_p)]
  int dim_p, ns_p, cone0, cone_g, use_soc;
  float rho, rho_i, tol_p, tol_d;
  int k_max, check_every, exact_k;
};

// Shared memory: the prepared z, the product's input w and the warps' row
// maxima, read by every thread; the consumed z, s and lam, each column read
// and written by its own thread.
struct Shared {
  float* zn;   // [dim_p][TB]
  float* w;    // [ns_p][TB]
  float* red;  // [ns_p / 32][2][TB]
  float* zc;   // [dim_p][TB]
  float* s;    // [ns_p][TB]
  float* lam;  // [ns_p][TB]
};

// What thread j knows of its columns.
struct Col {
  int j;
  bool has_z, has_s;  // j < dim_p, j < ns_p
  bool cone_warp;     // j in a warp of cones: the warp shuffles
  bool cone;          // j holds an entry of a cone (lane < 3g)
  int src, seg;       // the lane of its cone's y0; which entry it holds
  int lo, hi;         // the rows of CT column j that can be nonzero
  int box_end, s_end;  // MC rows read: [0, box_end) and [cone0, s_end)
  float d, lb, ub;
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

// acc[b] += sum_{i0 <= i < i1} x[i][b] m[i][j], UNROLL L2 loads in flight.
__device__ __forceinline__ void product(const float* x_s,
                                        const float* __restrict__ m, int ld,
                                        int i0, int i1, int j,
                                        float (&acc)[TB]) {
  const float* col = m + j;
#pragma unroll UNROLL
  for (int i = i0; i < i1; ++i) {
    const float w = __ldg(col + static_cast<size_t>(i) * ld);
    const float4* x4 = reinterpret_cast<const float4*>(x_s + i * TB);
#pragma unroll
    for (int q = 0; q < TB / 4; ++q) {
      const float4 x = x4[q];
      acc[4 * q] = fmaf(x.x, w, acc[4 * q]);
      acc[4 * q + 1] = fmaf(x.y, w, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(x.z, w, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(x.w, w, acc[4 * q + 3]);
    }
  }
}

// Projection onto {||(y1, y2)|| <= a (y0 - dd)}, a in {-1, +1}, in
// _proj_ssoc_seg's blended form.
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

// One iteration of thread j's columns for the block's TB lanes. Lanes in
// `frozen` keep all their state. With CHECK, returns the lanes whose
// residuals meet tol (identical in every thread of the block), and thread 0
// records the residuals of the lanes in `rmask` in lres.
template <bool CHECK>
__device__ __forceinline__ unsigned iterate(const Params& p, const Shared& s,
                                            const Col& c, unsigned frozen,
                                            unsigned rmask,
                                            float (&lres)[2][TB]) {
  if (c.has_s) {
    const int o = c.j * TB;
    float czd[TB], y[TB], sn[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) czd[b] = 0.0f;
    product(s.zn, p.ct, p.ns_p, c.lo, c.hi, c.j, czd);
    {
      float lam[TB];
      load(lam, s.lam + o);
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        czd[b] = czd[b] - c.d;
        y[b] = -czd[b] - p.rho_i * lam[b];
      }
    }
    if (c.cone_warp) {
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        float y0 = __shfl_sync(FULL, y[b], c.src);
        float y1 = __shfl_sync(FULL, y[b], c.src + p.cone_g);
        float y2 = __shfl_sync(FULL, y[b], c.src + 2 * p.cone_g);
        if (p.use_soc) {
          proj_ssoc(y0, y1, y2, 1.0f, 0.0f);
        } else {
          proj_ssoc(y0, y1, y2, 1.0f, c.lb);
          proj_ssoc(y0, y1, y2, -1.0f, c.ub);
        }
        const float v = c.seg == 0 ? y0 : (c.seg == 1 ? y1 : y2);
        sn[b] = c.cone ? v : fminf(fmaxf(y[b], c.lb), c.ub);
      }
    } else {
#pragma unroll
      for (int b = 0; b < TB; ++b) sn[b] = fminf(fmaxf(y[b], c.lb), c.ub);
    }
    float sv[TB], lam[TB], w[TB], ap[TB], ad[TB];
    load(sv, s.s + o);
    load(lam, s.lam + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float resid = czd[b] + sn[b];
      const float ds = sn[b] - sv[b];
      w[b] = p.rho * ds + p.rho * resid;
      if (CHECK) {
        ap[b] = fabsf(resid);
        ad[b] = fabsf(ds);
      }
      if (!bit(frozen, b)) {
        lam[b] = lam[b] + p.rho * resid;
        sv[b] = sn[b];
      }
    }
    store(s.w + o, w);
    store(s.s + o, sv);
    store(s.lam + o, lam);
    if (CHECK) {
      warp_max(ap, s.red, c.j, 0);
      warp_max(ad, s.red, c.j, 1);
    }
  }
  __syncthreads();
  if (c.has_z) {
    const int o = c.j * TB;
    float acc[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) acc[b] = 0.0f;
    product(s.w, p.mc, p.dim_p, 0, c.box_end, c.j, acc);
    product(s.w, p.mc, p.dim_p, p.cone0, c.s_end, c.j, acc);
    float zn[TB], zc[TB];
    load(zn, s.zn + o);
    load(zc, s.zc + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (!bit(frozen, b)) {
        zc[b] = zn[b];
        zn[b] = zn[b] + acc[b];
      }
    }
    store(s.zn + o, zn);
    store(s.zc + o, zc);
  }
  unsigned conv = 0;
  if (CHECK) {
    float rs[2][TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      rs[0][b] = 0.0f;
      rs[1][b] = 0.0f;
    }
    for (int w = 0; w < (p.ns_p >> 5); ++w) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float m[TB];
        load(m, s.red + (w * 2 + q) * TB);
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
  __syncthreads();
  return conv;
}

// Copy thread j's columns of the prepared z, s and lam between shared
// memory and the per-lane [z | s | lam] layout in global memory, for the
// lanes in `lanes`. TO_GLOBAL selects the direction.
template <bool TO_GLOBAL>
__device__ __forceinline__ void snapshot(const Params& p, const Shared& s,
                                         const Col& c, int lane0,
                                         unsigned lanes) {
  const int width = p.dim_p + 2 * p.ns_p;
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    if (!bit(lanes, b)) continue;
    float* g = p.snap + static_cast<size_t>(lane0 + b) * width;
    const int o = c.j * TB + b;
    float* sh[3] = {s.zn + o, s.s + o, s.lam + o};
    const int at[3] = {c.j, p.dim_p + c.j, p.dim_p + p.ns_p + c.j};
    const bool own[3] = {c.has_z, c.has_s, c.has_s};
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      if (!own[l]) continue;
      if (TO_GLOBAL)
        g[at[l]] = *sh[l];
      else
        *sh[l] = g[at[l]];
    }
  }
}

template <int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) fused_hmpc_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sn_k[TB];       // exact-k: each lane's window start
  __shared__ float lres[2][TB];  // thread 0's residuals of each lane
  __shared__ int bounds[2];      // box_end, s_end
  const int j = threadIdx.x;
  Shared s;
  s.zn = smem;
  s.w = s.zn + p.dim_p * TB;
  s.red = s.w + p.ns_p * TB;
  s.zc = s.red + (p.ns_p >> 5) * 2 * TB;
  s.s = s.zc + p.dim_p * TB;
  s.lam = s.s + p.ns_p * TB;
  Col c;
  c.j = j;
  c.has_z = j < p.dim_p;
  c.has_s = j < p.ns_p;
  c.cone_warp = c.has_s && j >= p.cone0;
  const int lane = j & 31;
  c.cone = c.cone_warp && lane < 3 * p.cone_g;
  c.seg = lane / p.cone_g;
  c.src = lane % p.cone_g;
  c.d = c.has_s ? p.d[j] : 0.0f;
  c.lb = c.has_s ? p.lb[j] : 0.0f;
  c.ub = c.has_s ? p.ub[j] : 0.0f;
  c.lo = 0;
  c.hi = 0;
  if (c.has_s) {
    // the first and last nonzero of CT column j
    for (int i = 0; i < p.dim_p; ++i) {
      if (p.ct[static_cast<size_t>(i) * p.ns_p + j] != 0.0f) {
        if (c.hi == 0) c.lo = i;
        c.hi = i + 1;
      }
    }
  }
  if (j == 0) {
    bounds[0] = 0;
    bounds[1] = p.cone0;
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      lres[0][b] = RBIG;
      lres[1][b] = RBIG;
    }
  }
  __syncthreads();
  if (c.hi > c.lo) atomicMax(&bounds[j < p.cone0 ? 0 : 1], j + 1);
  __syncthreads();
  c.box_end = bounds[0];
  c.s_end = bounds[1];
  const int lane0 = blockIdx.x * TB;
  const int o = j * TB;
  if (c.has_z) {
    float z[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b)
      z[b] = p.z1[static_cast<size_t>(lane0 + b) * p.dim_p + j];
    store(s.zn + o, z);
    store(s.zc + o, z);
  }
  if (c.has_s) {
    float sv[TB], lam[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const size_t g = static_cast<size_t>(lane0 + b) * p.ns_p + j;
      sv[b] = p.s0[g];
      lam[b] = p.lam0[g];
    }
    store(s.s + o, sv);
    store(s.lam + o, lam);
  }
  __syncthreads();
  unsigned done = 0;
  int k[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) k[b] = 0;
  const int C = p.check_every;
  const float* zout = s.zc;  // the z written out: the consumed z ...

  if (C > 1 && p.exact_k) {
    // free-run windows of C iterations; snapshot every still-active lane
    // at each window start, so the window a lane converges in can be
    // replayed with per-iteration checks once the block has drained.
    // Windows may overshoot k_max: the replay budget cuts each lane off at
    // exactly k_max.
    for (int it = 0; it < p.k_max && done != ALL; it += C) {
      snapshot<true>(p, s, c, lane0, ~done & ALL);
      if (j == 0) {
#pragma unroll
        for (int b = 0; b < TB; ++b)
          if (!bit(done, b)) sn_k[b] = it;
      }
      for (int f = 0; f < C - 1; ++f)
        iterate<false>(p, s, c, 0u, 0u, lres);
      done |= iterate<true>(p, s, c, 0u, 0u, lres);
    }
    // replay each lane's last window from its snapshot with per-iteration
    // checks: k counts on from the window start (the last iteration's
    // closing barrier ordered thread 0's window starts)
    snapshot<false>(p, s, c, lane0, ALL);
    if (c.has_z) {
      float z[TB];
      load(z, s.zn + o);
      store(s.zc + o, z);
    }
    __syncthreads();
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
          iterate<true>(p, s, c, frozen, ~frozen & ALL, lres);
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
        iterate<false>(p, s, c, 0u, 0u, lres);
      const unsigned conv =
          iterate<true>(p, s, c, 0u, ~done & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(done, b)) k[b] += n_fast + 1;
      done |= conv;
      it += n_fast + 1;
    }
    zout = s.zn;  // ... but the prepared one in free-run
  } else {
    // checked: exit tests every iteration; a converged lane freezes and
    // keeps the z it consumed at exit
    for (int it = 0; it < p.k_max && done != ALL; ++it) {
      const unsigned conv =
          iterate<true>(p, s, c, done, ~done & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(done, b)) ++k[b];
      done |= conv;
    }
  }

  if (c.has_z) {
    float x[TB];
    load(x, zout + o);
#pragma unroll
    for (int b = 0; b < TB; ++b)
      p.z[static_cast<size_t>(lane0 + b) * p.dim_p + j] = x[b];
  }
  if (c.has_s) {
    const float* leaves[2] = {s.s, s.lam};
    float* outs[2] = {p.s, p.lam};
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      float x[TB];
      load(x, leaves[l] + o);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        outs[l][static_cast<size_t>(lane0 + b) * p.ns_p + j] = x[b];
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

// Launch on `stream` (a cudaStream_t). The geometry comes from the wrapper
// (kernels/fused_hmpc.py launch_geometry) and is checked here again.
// Returns the CUDA error of the launch, as an int.
extern "C" int fused_hmpc_launch(
    const float* z1, const float* s0, const float* lam0, const float* ct,
    const float* mc, const float* d, const float* lb, const float* ub,
    float* z, float* s, float* lam, int* k, int* done, float* rp, float* rd,
    float* snap, int B, int dim_p, int ns_p, int cone0, int cone_g,
    int use_soc, int blocks, int threads, int smem, float rho, float rho_i,
    float tol_p, float tol_d, int k_max, int check_every, int exact_k,
    void* stream) {
  const long need = 4L * TB * (2L * dim_p + 3L * ns_p + 2L * (ns_p / 32));
  const bool exact = check_every > 1 && exact_k;
  const int width = dim_p > ns_p ? dim_p : ns_p;
  if (dim_p <= 0 || dim_p % 32 != 0 || dim_p > MAX_COLS || ns_p <= 0 ||
      ns_p % 32 != 0 || ns_p > MAX_COLS || cone0 < 0 || cone0 % 32 != 0 ||
      cone0 >= ns_p || cone_g < 1 || cone_g > MAX_G || B % TB != 0 ||
      blocks != B / TB || threads != width || smem != need ||
      check_every < 1 || k_max < 1 || (exact && B > 0 && snap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  // up to NARROW columns, compiled for three blocks an SM (at most 64
  // registers a thread), wider for one block of up to MAX_COLS threads
  void (*kernel)(Params) = width <= NARROW ? fused_hmpc_kernel<NARROW, 3>
                                           : fused_hmpc_kernel<MAX_COLS, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Params p{z1,    s0,    lam0,   ct,      mc,    d,     lb,   ub,
           z,     s,     lam,    k,       done,  rp,    rd,   snap,
           dim_p, ns_p,  cone0,  cone_g,  use_soc, rho, rho_i, tol_p,
           tol_d, k_max, check_every, exact_k};
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
