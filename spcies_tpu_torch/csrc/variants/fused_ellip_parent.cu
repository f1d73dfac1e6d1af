// Fused ellipMPC-ADMM on NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
// spcies_tpu/kernels/fused_ellip.py::_fused_ellip_kernel. It computes what
// that kernel computes, mode for mode (checked, free-run, exact-k with
// window replay, fixed_iters): for every lane of the batch, the whole ADMM
// loop in P_half coordinates
//
//     y      = z' + rho_i lam
//     v'     = clip(y, LB, UB)                          on the stage columns
//     v'     = c' + min(1, r / max(||y - c'||, 1e-30)) (y - c')  on the slab
//     lam   += rho (z' - v')
//     dq     = rho (z' - 2 v' + v'_prev)
//     z_next = z' + dq @ M2                             (M2 = S M_q S)
//
// with the terminal slab at columns t0 .. t0+n-1, and at a checked
// iteration the residuals r_p = max|z' - v'|, r_d = max|v' - v'_prev| after
// the slab's differences are mapped back to the original coordinates
// (d_slab @ pinvh, pinvh = P_half^-T, n x n). The wrapper and the plain
// PyTorch version of every mode are in kernels/fused_ellip.py.
//
// Layout. One thread block per TB = 8 lanes; one thread per column j of the
// padded width nzp (a multiple of 32, at most 512). Thread j owns column j
// of the four state vectors (z_next, the consumed z, v, lam) for the
// block's TB lanes, in shared memory that only thread j touches: kept out
// of registers, they leave the registers to the product's loads in flight
// (K2 and K3 do the same; with the state in registers this kernel spilled
// about 550 bytes a thread). K1's iteration (csrc/fused_admm.cu) needs
// nothing from other columns before the product; this one needs two
// reductions across the slab:
//   - the ball's norm ||y - c'|| over the n slab columns before v, and
//   - at a checked iteration, the slab's differences of all n columns for
//     each column's entry of d_slab @ pinvh.
// The adapter lays the slab out inside one warp (t0 % 32 + n <= 32; at
// N=30, columns 234..239 of warp 7), so both are warp shuffles within that
// warp: the slab's n entries are broadcast in turn and added in slab order.
// No barrier is added: like K1, an iteration has one __syncthreads, after
// the deltas dq are stored to shared memory as [nzp][TB] (and, at a checked
// iteration, the warps' row maxima), both double-buffered by iteration
// parity. Then thread j forms z_next[b][j] = z[b][j] + sum_i dq[b][i]
// M2[i][j], reading row i of M2 at column j (a warp reads 32 consecutive
// floats) and dq as broadcast reads of shared memory; rows from t0 + n on
// are pads (dq = 0) and are skipped. Every thread reads the same row maxima
// after the product, so loop control is uniform across a block; lanes that
// are done are frozen by a mask and keep all their state.
//
// Sum orders. The ball's norm and the pinvh map add their n terms in slab
// order, one after the other, each product and sum rounded on its own, as
// the plain version does; the product is an fmaf chain in row order. (A
// butterfly sum for the norm moved the exit of 8 of 4096 lanes where the
// ball binds, on an NVIDIA H100.)
//
// Exact-k snapshots. At each window start z, v and lam of every lane not
// yet done go to global scratch (each thread writes, and later reads back,
// only its own column), and the window start to shared memory; the replay
// runs each lane's last window with the checked semantics and the budget
// min(C, k_max - kws), as K1-K3 do.
//
// Bound. Every block re-reads the t0 + n real rows of M2 (240 x 256 floats,
// 240 KiB at the N=30 shapes) from L2 on every iteration, for 2 TB FLOP per
// 4 bytes read; M2 stays in the 50 MB L2. The product must stay full fp32
// (the JAX kernel pins it to HIGHEST: a truncated M2 shifts the fixed point
// of degenerate ellipsoids), so no bf16 or TF32 path. The product loop is
// unrolled 16 deep to keep 16 L2 loads in flight per thread, and up to 256
// columns the kernel is compiled for three blocks an SM (at most 85
// registers; it spills about 280 bytes): on an NVIDIA H100 (700 W) at
// B=8192 and 32768 that took 26.5 / 85.3 ms, against 26.6 / 89.3 ms at 128
// registers (two blocks an SM), 28.0 / 87.6 ms unrolled 8 and 37.6 / 112.1
// ms unrolled 4 (tools/ab_kernels.py; PERF.md, K4). Staging M2
// through shared memory, wgmma and TMA are left for later work.
//
// Arithmetic. fp32 on the CUDA cores, no TF32. The library is built with
// -fmad=false, so the element-wise steps (sqrtf and the division included)
// round as PyTorch's separate operations do; the products use explicit
// fmaf.
//
// Padding. Pad columns carry zero rows and columns of M2, [0, 0] bounds
// and c' = 0, so they stay exactly 0 and add nothing to the row maxima.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 8;          // lanes per block (CTA_LANES in the wrapper)
constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr int NARROW = 256;    // up to this width, three blocks an SM
constexpr int NSNAP = 3;       // snapshot leaves (SNAP_LEAVES in the wrapper)
constexpr int UNROLL = 16;     // L2 loads in flight per thread
constexpr float RBIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ALL = (1u << TB) - 1u;
static_assert(TB % 4 == 0, "vectors are moved as float4");

struct Params {
  const float* __restrict__ z1;
  const float* __restrict__ v0;
  const float* __restrict__ lam0;
  const float* __restrict__ m2;     // [nzp][nzp], row-major, dq @ m2
  const float* __restrict__ pinvh;  // [n][n], d_slab @ pinvh
  const float* __restrict__ lb;
  const float* __restrict__ ub;
  const float* __restrict__ c;      // c' on the slab, 0 elsewhere
  float* z;
  float* v;
  float* lam;
  int* k;
  int* done;
  float* rp;
  float* rd;
  float* snap;  // exact-k: per lane [z | v | lam]
  int nzp, t0, n;
  float rho, rho_i, r_ball, tol_p, tol_d;
  int k_max, check_every, fixed_iters, exact_k;
};

// Shared memory: the product's input and the warps' row maxima, read by
// every thread; the state columns, each read and written by its own thread.
struct Shared {
  float* dq;     // [2][nzp][TB]
  float* red;    // [2][warps][2][TB]
  float* st[4];  // [nzp][TB] each, the leaves below
};
// the state leaves; the first NSNAP are the snapshot's, in its order
enum { Z, V, LAM, ZC };  // z_next, v, lam, the consumed z

// What thread j knows of its column.
struct Col {
  int j, jj;       // column, and its place in the slab
  bool slab;       // a terminal column
  bool slab_warp;  // in the warp that holds the slab (warp-uniform)
  int nr;          // rows of M2 the product reads
  int warps;
  float lb, ub, c;
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
  float* dq_s = s.dq + parity * p.nzp * TB;
  float* red = s.red + parity * c.warps * 2 * TB;
  float z[TB], v[TB], lam[TB], vn[TB];
  load(z, s.st[Z] + o);
  load(v, s.st[V] + o);
  load(lam, s.st[LAM] + o);
  if (c.slab_warp) {
    // the ball about c' on the slab: the squares of the slab's columns,
    // broadcast in turn and added in slab order
    float yc[TB], sq[TB], q[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float y = z[b] + p.rho_i * lam[b];
      yc[b] = y - c.c;
      sq[b] = yc[b] * yc[b];
      q[b] = 0.0f;
      vn[b] = fminf(fmaxf(y, c.lb), c.ub);
    }
    for (int i = 0; i < p.n; ++i) {
      const int src = (p.t0 + i) & 31;
#pragma unroll
      for (int b = 0; b < TB; ++b)
        q[b] = q[b] + __shfl_sync(FULL, sq[b], src);
    }
    if (c.slab) {
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const float nrm = sqrtf(q[b]);
        const float scale = fminf(1.0f, p.r_ball / fmaxf(nrm, 1e-30f));
        vn[b] = c.c + scale * yc[b];
      }
    }
  } else {
#pragma unroll
    for (int b = 0; b < TB; ++b)
      vn[b] = fminf(fmaxf(z[b] + p.rho_i * lam[b], c.lb), c.ub);
  }
  {
    float dq[TB], ap[TB], ad[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      dq[b] = p.rho * ((z[b] - 2.0f * vn[b]) + v[b]);
      if (CHECK) {
        ap[b] = z[b] - vn[b];
        ad[b] = vn[b] - v[b];
      }
      if (!bit(frozen, b)) {
        lam[b] = lam[b] + p.rho * (z[b] - vn[b]);
        v[b] = vn[b];
      }
    }
    store(dq_s + o, dq);
    store(s.st[V] + o, v);
    store(s.st[LAM] + o, lam);
    if (CHECK) {
      if (c.slab_warp) {
        // the slab's differences back to the original coordinates:
        // column jj of d_slab @ pinvh, the slab's entries broadcast in
        // turn
        float bp[TB], bd[TB];
#pragma unroll
        for (int b = 0; b < TB; ++b) {
          bp[b] = 0.0f;
          bd[b] = 0.0f;
        }
        for (int i = 0; i < p.n; ++i) {
          const int src = (p.t0 + i) & 31;
          const float w = c.slab ? __ldg(p.pinvh + i * p.n + c.jj) : 0.0f;
#pragma unroll
          for (int b = 0; b < TB; ++b) {
            bp[b] = bp[b] + __shfl_sync(FULL, ap[b], src) * w;
            bd[b] = bd[b] + __shfl_sync(FULL, ad[b], src) * w;
          }
        }
        if (c.slab) {
#pragma unroll
          for (int b = 0; b < TB; ++b) {
            ap[b] = bp[b];
            ad[b] = bd[b];
          }
        }
      }
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        ap[b] = fabsf(ap[b]);
        ad[b] = fabsf(ad[b]);
      }
      warp_max(ap, red, c.j, 0);
      warp_max(ad, red, c.j, 1);
    }
  }
  __syncthreads();
  float acc[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) acc[b] = 0.0f;
  const float* col = p.m2 + c.j;
#pragma unroll UNROLL
  for (int i = 0; i < c.nr; ++i) {
    const float m = __ldg(col + static_cast<size_t>(i) * p.nzp);
    const float4* d4 = reinterpret_cast<const float4*>(dq_s + i * TB);
#pragma unroll
    for (int q = 0; q < TB / 4; ++q) {
      const float4 d = d4[q];
      acc[4 * q] = fmaf(d.x, m, acc[4 * q]);
      acc[4 * q + 1] = fmaf(d.y, m, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(d.z, m, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(d.w, m, acc[4 * q + 3]);
    }
  }
  {
    float zc[TB];
    load(zc, s.st[ZC] + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (!bit(frozen, b)) {
        zc[b] = z[b];
        z[b] = z[b] + acc[b];
      }
    }
    store(s.st[Z] + o, z);
    store(s.st[ZC] + o, zc);
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

// Copy this thread's column of z, v and lam between shared memory and the
// per-lane [z | v | lam] layout in global memory, for the lanes in
// `lanes`. TO_GLOBAL selects the direction.
template <bool TO_GLOBAL>
__device__ __forceinline__ void snapshot(const Params& p, const Shared& s,
                                         int j, int lane0, unsigned lanes) {
#pragma unroll
  for (int l = 0; l < NSNAP; ++l) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (!bit(lanes, b)) continue;
      float* g = p.snap + static_cast<size_t>(lane0 + b) * NSNAP * p.nzp +
                 l * p.nzp + j;
      float* sh = s.st[l] + j * TB + b;
      if (TO_GLOBAL)
        *g = *sh;
      else
        *sh = *g;
    }
  }
}

template <int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) fused_ellip_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sn_k[TB];       // exact-k: each lane's window start
  __shared__ float lres[2][TB];  // thread 0's residuals of each lane
  const int nzp = p.nzp;
  const int j = threadIdx.x;
  Shared s;
  s.dq = smem;
  s.red = smem + 2 * nzp * TB;
  {
    float* a = s.red + 2 * (nzp / 32) * 2 * TB;
    for (int l = 0; l < 4; ++l, a += nzp * TB) s.st[l] = a;
  }
  Col c;
  c.j = j;
  c.jj = j - p.t0;
  c.slab = j >= p.t0 && j < p.t0 + p.n;
  c.slab_warp = (j >> 5) == (p.t0 >> 5);
  c.nr = p.t0 + p.n;
  c.warps = nzp >> 5;
  c.lb = p.lb[j];
  c.ub = p.ub[j];
  c.c = p.c[j];
  const int lane0 = blockIdx.x * TB;
  const int o = j * TB;
  {
    float z[TB], v[TB], lam[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const size_t g = static_cast<size_t>(lane0 + b) * nzp + j;
      z[b] = p.z1[g];
      v[b] = p.v0[g];
      lam[b] = p.lam0[g];
    }
    store(s.st[Z] + o, z);
    store(s.st[ZC] + o, z);
    store(s.st[V] + o, v);
    store(s.st[LAM] + o, lam);
  }
  if (j == 0) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      lres[0][b] = RBIG;
      lres[1][b] = RBIG;
    }
  }
  int parity = 0;
  unsigned done = 0;
  int k[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) k[b] = 0;
  const int C = p.check_every;
  int zout = ZC;  // the leaf written out as z: the consumed z ...

  if (p.fixed_iters > 0) {
    // exactly fixed_iters plain iterations, no exit tests
    for (int it = 0; it < p.fixed_iters; ++it)
      iterate<false>(p, s, c, parity, 0u, 0u, lres);
#pragma unroll
    for (int b = 0; b < TB; ++b) k[b] = p.fixed_iters;
    done = ALL;
    zout = Z;  // ... but the prepared one here and in free-run
  } else if (C > 1 && p.exact_k) {
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
      float z[TB];
      load(z, s.st[Z] + o);
      store(s.st[ZC] + o, z);
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
    zout = Z;
  } else {
    // checked: exit tests every iteration; a converged lane freezes and
    // keeps the z it consumed at exit
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
    const int leaves[3] = {zout, V, LAM};
    float* outs[3] = {p.z, p.v, p.lam};
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      float x[TB];
      load(x, s.st[leaves[l]] + o);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        outs[l][static_cast<size_t>(lane0 + b) * nzp + j] = x[b];
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
// (kernels/fused_ellip.py launch_geometry) and is checked here again.
// Returns the CUDA error of the launch, as an int.
extern "C" int fused_ellip_launch(
    const float* z1, const float* v0, const float* lam0, const float* m2,
    const float* pinvh, const float* lb, const float* ub, const float* c,
    float* z, float* v, float* lam, int* k, int* done, float* rp, float* rd,
    float* snap, int B, int nzp, int t0, int n, int blocks, int threads,
    int smem, float rho, float rho_i, float r_ball, float tol_p, float tol_d,
    int k_max, int check_every, int fixed_iters, int exact_k, void* stream) {
  const long need = 4L * TB * (6L * nzp + 4L * (nzp / 32));
  const bool exact = check_every > 1 && exact_k && fixed_iters <= 0;
  if (nzp <= 0 || nzp % 32 != 0 || nzp > MAX_COLS || B % TB != 0 ||
      blocks != B / TB || threads != nzp || smem != need || check_every < 1 ||
      k_max < 1 || n < 1 || n > 32 || t0 < 0 || t0 + n > nzp ||
      t0 % 32 + n > 32 || (exact && B > 0 && snap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  // up to NARROW columns, compiled for three blocks an SM (at most 85
  // registers a thread), wider for one block of up to MAX_COLS threads
  void (*kernel)(Params) = nzp <= NARROW ? fused_ellip_kernel<NARROW, 3>
                                         : fused_ellip_kernel<MAX_COLS, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Params p{z1,   v0,    lam0, m2,          pinvh,       lb,
           ub,   c,     z,    v,           lam,         k,
           done, rp,    rd,   snap,        nzp,         t0,
           n,    rho,   rho_i, r_ball,     tol_p,       tol_d,
           k_max, check_every, fixed_iters, exact_k};
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
