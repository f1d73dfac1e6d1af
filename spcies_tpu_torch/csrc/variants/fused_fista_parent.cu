// Fused dual FISTA on NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
// spcies_tpu/kernels/fused_fista.py::_fused_fista_kernel. It computes what
// that kernel computes, mode for mode (checked, free-run, exact-k with
// window-minimum exit and window replay, fixed_iters; adaptive restart):
// for every lane of the batch, the whole dual-FISTA loop
//
//     z     = clip(-hinv q, LB, UB)
//     r     = r - (z - z_prev) @ G'             (GT = G', padded)
//     res   = max_j |r|
//     lam'  = y + r @ Winv'
//     t     = 1 where restart and res > res_prev
//     t'    = (1 + sqrt(1 + 4 t t)) / 2
//     y'    = lam' + ((t - 1) / t') (lam' - lam)
//     q     = q - (y' - y) @ G
//
// until the lane meets tol or k_max. The wrapper and the plain PyTorch
// version of every mode are in kernels/fused_fista.py.
//
// Layout. One thread block per TB = 8 lanes; one thread per column j of
// the wider of the two padded widths, nzp (decision vector) and nlamp
// (duals), each a multiple of 32 and at most 512. Thread j owns q and
// z_prev of column j (when j < nzp) and r, y and lam of column j (when
// j < nlamp) for the block's TB lanes, kept in shared memory that only
// thread j touches; t and res of each lane are computed identically by
// every thread. Keeping the five vectors out of registers leaves the
// registers to the products' loads in flight: with the state in registers
// the kernel hit its 128-register cap, spilled, and ran about 3x slower
// per byte of L2 than K1 (PERF.md). An iteration is a chain of
// three products, each of which needs the whole of its input vector:
//   1. thread j forms dz of its column and stores it to shared memory as
//      [nzp][TB];                                            __syncthreads
//   2. thread j < nlamp forms r[b][j] -= sum_i dz[b][i] GT[i][j] and stores
//      it as [nlamp][TB]; the row maxima of |r| go through warp shuffles,
//      then shared memory across warps;                      __syncthreads
//   3. every thread reads the maxima (res), applies restart and the t
//      update; thread j < nlamp forms lam', y' and dy;       __syncthreads
//   4. thread j < nzp forms q[b][j] -= sum_i dy[b][i] G[i][j].
// Each product reads row i of its matrix at column j (the 32 threads of a
// warp read 32 consecutive floats) and its vector as broadcast reads of
// shared memory. The three vectors have three buffers, so three barriers
// per iteration order every read before the next write. Loop control is
// uniform across a block because every thread reads the same maxima.
// Threads beyond a width keep zeros there and still reach every barrier.
//
// Exact-k snapshots. At each window start the seven in-loop leaves of
// every lane not yet done are saved: the five vectors to global scratch
// (each thread writes, and later reads back, only its own columns), t,
// res and the window's first iteration to shared memory.
//
// Bound. Every block re-reads G, G' and Winv' (2 nzp nlamp + nlamp^2
// floats, 528 KiB at the N=30 shapes nzp = 256, nlamp = 192) from L2 on
// every iteration, for 2 TB FLOP per 4 bytes read. They stay resident in
// the 50 MB L2; at 465 KiB unpadded they do not fit a block's 227 KB of
// shared memory. Each product is a chain of L2 loads, and the three
// barriers let no block overlap one product with the next, so the latency
// of those loads binds: the product loop is unrolled 16 deep to keep 16
// loads in flight per thread (at B=8192 on an H100, unrolled 4 it took
// 17.6 ms, 8 8.9 ms, 16 7.9 ms, 32 7.8 ms). G's band structure, staging
// the matrices through shared memory, wgmma and TMA are left for later
// work.
//
// Arithmetic. fp32 on the CUDA cores, no TF32. The library is built with
// -fmad=false, so the element-wise steps (sqrtf and the division in the t
// update included) round as PyTorch's separate operations do; the products
// use explicit fmaf. Only the order of the products' sums differs from a
// cuBLAS or CPU matmul.
//
// Padding. Pad columns carry zero rows and columns of G, G' and Winv',
// zero hinv and [0, 0] bounds, so they stay exactly 0 and add nothing to
// the row maxima.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 8;          // lanes per block (CTA_LANES in the wrapper)
constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr float RBIG = 3.4e38f;
constexpr unsigned ALL = (1u << TB) - 1u;
static_assert(TB % 4 == 0, "vectors are moved as float4");

struct Params {
  const float* __restrict__ q1;
  const float* __restrict__ z0;
  const float* __restrict__ r0;
  const float* __restrict__ y0;
  const float* __restrict__ lam0;
  const float* __restrict__ g;      // [nlamp][nzp], dy @ g
  const float* __restrict__ gt;     // [nzp][nlamp], dz @ gt
  const float* __restrict__ winvt;  // [nlamp][nlamp], r @ winvt
  const float* __restrict__ hinv;
  const float* __restrict__ lb;
  const float* __restrict__ ub;
  float* z;
  float* y;
  float* lam;
  int* k;
  int* done;
  float* res;
  float* snap;  // exact-k: per lane [q | z_prev | r | y | lam]
  int nzp, nlamp;
  float tol;
  int k_max, restart, check_every, fixed_iters, exact_k;
};

// Per-lane scalars, identical in every thread of the block.
struct Lanes {
  float t[TB];
  float res[TB];
};

// Shared memory. The product inputs are read by every thread; the state
// columns are each read and written by their own thread only.
struct Shared {
  float* dz;   // [nzp][TB]    product inputs
  float* r;    // [nlamp][TB]
  float* dy;   // [nlamp][TB]
  float* q;    // [nzp][TB]    state: q, z_prev (nz-wide)
  float* zp;   // [nzp][TB]
  float* rs;   // [nlamp][TB]  state: r, y, lam (nlam-wide)
  float* y;    // [nlamp][TB]
  float* lam;  // [nlamp][TB]
  float* red;  // [nlamp / 32][TB] row maxima of each warp
};

struct Col {
  int j, nzp, nlamp;
  bool zc, lc;  // j < nzp, j < nlamp
  float nhinv, lb, ub;
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

// acc[b] = sum_{i < n} v[i][b] m[i][j]: v in shared memory as [n][TB],
// m row-major with leading dimension ld, read from L2.
__device__ __forceinline__ void product(const float* v,
                                        const float* __restrict__ m, int ld,
                                        int n, int j, float (&acc)[TB]) {
#pragma unroll
  for (int b = 0; b < TB; ++b) acc[b] = 0.0f;
  const float* col = m + j;
#pragma unroll 16
  for (int i = 0; i < n; ++i) {
    const float w = __ldg(col + i * ld);
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

__device__ __forceinline__ float z_of(const Col& c, float q) {
  return fminf(fmaxf(c.nhinv * q, c.lb), c.ub);
}

// One iteration of column j for the block's TB lanes. Plain (CHECKED =
// false): every lane takes the full update. Checked: lanes in `frozen`
// keep everything, and a lane that converges on this iteration keeps its
// lam, y and t (the dense engine's momentum mask). Returns the lanes with
// res <= tol (identical in every thread of the block).
template <bool CHECKED>
__device__ __forceinline__ unsigned iterate(const Params& p, const Shared& s,
                                            const Col& c, Lanes& ln,
                                            unsigned frozen) {
  const int o = c.j * TB;  // this thread's column in every buffer
  // 1. z = clip(-hinv q), dz = z - z_prev
  if (c.zc) {
    float q[TB], zp[TB];
    load(q, s.q + o);
    load(zp, s.zp + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) q[b] = z_of(c, q[b]) - zp[b];
    store(s.dz + o, q);
  }
  __syncthreads();
  // 2. r -= dz @ G', and its row maxima
  if (c.lc) {
    float acc[TB], r[TB], ab[TB];
    product(s.dz, p.gt, c.nlamp, c.nzp, c.j, acc);
    load(r, s.rs + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float rn = r[b] - acc[b];
      acc[b] = rn;
      ab[b] = fabsf(rn);
      if (!CHECKED || !bit(frozen, b)) r[b] = rn;
    }
    store(s.r + o, acc);
    store(s.rs + o, r);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ab[b] = fmaxf(ab[b], __shfl_xor_sync(0xffffffffu, ab[b], off));
    }
    if ((c.j & 31) == 0) store(s.red + (c.j >> 5) * TB, ab);
  }
  __syncthreads();
  // 3. res, restart, t and the momentum coefficient of each lane
  float coef[TB];
  unsigned conv = 0;
  {
    float rs[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) rs[b] = 0.0f;
    for (int w = 0; w < (c.nlamp >> 5); ++w) {
      float m[TB];
      load(m, s.red + w * TB);
#pragma unroll
      for (int b = 0; b < TB; ++b) rs[b] = fmaxf(rs[b], m[b]);
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      float tc = ln.t[b];
      if (p.restart && rs[b] > ln.res[b]) tc = 1.0f;
      const float tn = 0.5f * (1.0f + sqrtf(1.0f + 4.0f * tc * tc));
      coef[b] = (tc - 1.0f) / tn;
      if (rs[b] <= p.tol) conv |= 1u << b;
      if (!CHECKED || !bit(frozen, b)) ln.res[b] = rs[b];
      if (!CHECKED || !bit(conv | frozen, b)) ln.t[b] = tn;
    }
  }
  //    lam' = y + r @ Winv', y' = lam' + coef (lam' - lam), dy = y' - y
  if (c.lc) {
    float acc[TB], y[TB], lam[TB];
    product(s.r, p.winvt, c.nlamp, c.nlamp, c.j, acc);
    load(y, s.y + o);
    load(lam, s.lam + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (CHECKED && bit(conv | frozen, b)) {
        acc[b] = 0.0f;
      } else {
        const float ln_new = y[b] + acc[b];
        const float yn = ln_new + coef[b] * (ln_new - lam[b]);
        acc[b] = yn - y[b];
        y[b] = yn;
        lam[b] = ln_new;
      }
    }
    store(s.dy + o, acc);
    store(s.y + o, y);
    store(s.lam + o, lam);
  }
  __syncthreads();
  // 4. q -= dy @ G; z_prev = z (recomputed from the q it came from)
  if (c.zc) {
    float acc[TB], q[TB], zp[TB];
    product(s.dy, p.g, c.nzp, c.nlamp, c.j, acc);
    load(q, s.q + o);
    load(zp, s.zp + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (!CHECKED || !bit(frozen, b)) {
        zp[b] = z_of(c, q[b]);
        q[b] = q[b] - acc[b];
      }
    }
    store(s.q + o, q);
    store(s.zp + o, zp);
  }
  return conv;
}

// Copy the five state columns of this thread between shared memory and a
// per-lane [q | z_prev | r | y | lam] layout in global memory (the exact-k
// snapshot), for the lanes in `lanes`. TO_GLOBAL selects the direction.
template <bool TO_GLOBAL>
__device__ __forceinline__ void snapshot(const Shared& s, const Col& c,
                                         float* snap, int lane0,
                                         unsigned lanes) {
  const int nzp = c.nzp, nlamp = c.nlamp, j = c.j, W = 2 * nzp + 3 * nlamp;
  float* const cols[5] = {s.q, s.zp, s.rs, s.y, s.lam};
  const int offs[5] = {0, nzp, 2 * nzp, 2 * nzp + nlamp,
                       2 * nzp + 2 * nlamp};
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    if (l < 2 ? !c.zc : !c.lc) continue;
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (!bit(lanes, b)) continue;
      float* g = snap + static_cast<size_t>(lane0 + b) * W + offs[l] + j;
      float* sh = cols[l] + j * TB + b;
      if (TO_GLOBAL)
        *g = *sh;
      else
        *sh = *g;
    }
  }
}

__global__ void __launch_bounds__(MAX_COLS)
    fused_fista_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sn_t[TB], sn_res[TB];  // exact-k snapshot scalars
  __shared__ int sn_k[TB];
  const int nzp = p.nzp, nlamp = p.nlamp;
  const int j = threadIdx.x;
  Shared s;
  {
    float* a = smem;
    float** bufs[8] = {&s.dz, &s.r, &s.dy, &s.q, &s.zp, &s.rs, &s.y, &s.lam};
    const int widths[8] = {nzp, nlamp, nlamp, nzp, nzp, nlamp, nlamp, nlamp};
    for (int l = 0; l < 8; ++l) {
      *bufs[l] = a;
      a += widths[l] * TB;
    }
    s.red = a;
  }
  Col c;
  c.j = j;
  c.nzp = nzp;
  c.nlamp = nlamp;
  c.zc = j < nzp;
  c.lc = j < nlamp;
  c.nhinv = c.zc ? -p.hinv[j] : 0.0f;
  c.lb = c.zc ? p.lb[j] : 0.0f;
  c.ub = c.zc ? p.ub[j] : 0.0f;
  const int lane0 = blockIdx.x * TB;
  const int o = j * TB;

  {
    float v[5][TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const size_t rz = static_cast<size_t>(lane0 + b) * nzp + j;
      const size_t rl = static_cast<size_t>(lane0 + b) * nlamp + j;
      v[0][b] = c.zc ? p.q1[rz] : 0.0f;
      v[1][b] = c.zc ? p.z0[rz] : 0.0f;
      v[2][b] = c.lc ? p.r0[rl] : 0.0f;
      v[3][b] = c.lc ? p.y0[rl] : 0.0f;
      v[4][b] = c.lc ? p.lam0[rl] : 0.0f;
    }
    if (c.zc) {
      store(s.q + o, v[0]);
      store(s.zp + o, v[1]);
    }
    if (c.lc) {
      store(s.rs + o, v[2]);
      store(s.y + o, v[3]);
      store(s.lam + o, v[4]);
    }
  }
  Lanes ln;
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    ln.t[b] = 1.0f;
    ln.res[b] = RBIG;
  }
  unsigned done = 0;
  int k[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) k[b] = 0;
  const int C = p.check_every;

  if (p.fixed_iters > 0) {
    // exactly fixed_iters plain iterations, no exit tests
    for (int it = 0; it < p.fixed_iters; ++it)
      iterate<false>(p, s, c, ln, 0u);
#pragma unroll
    for (int b = 0; b < TB; ++b) k[b] = p.fixed_iters;
    done = ALL;
  } else if (C > 1 && p.exact_k) {
    // free-run windows of C iterations; snapshot every still-active lane
    // at each window start; a lane is done once a window's minimum
    // residual meets tol. Windows may overshoot k_max: the replay budget
    // cuts each lane off at exactly k_max.
    for (int it = 0; it < p.k_max && done != ALL; it += C) {
      snapshot<true>(s, c, p.snap, lane0, ~done & ALL);
      if (j == 0) {
#pragma unroll
        for (int b = 0; b < TB; ++b) {
          if (bit(done, b)) continue;
          sn_t[b] = ln.t[b];
          sn_res[b] = ln.res[b];
          sn_k[b] = it;
        }
      }
      float rmin[TB];
#pragma unroll
      for (int b = 0; b < TB; ++b) rmin[b] = RBIG;
      for (int f = 0; f < C; ++f) {
        iterate<false>(p, s, c, ln, 0u);
#pragma unroll
        for (int b = 0; b < TB; ++b) rmin[b] = fminf(rmin[b], ln.res[b]);
      }
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (rmin[b] <= p.tol) done |= 1u << b;
    }
    __syncthreads();  // the snapshot scalars, written by thread 0
    // replay each lane's last window from its snapshot with per-iteration
    // checks: k counts on from the window start
    snapshot<false>(s, c, p.snap, lane0, ALL);
    int budget[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      ln.t[b] = sn_t[b];
      ln.res[b] = sn_res[b];
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
      const unsigned conv = iterate<true>(p, s, c, ln, frozen);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(frozen, b)) ++k[b];
      convd |= conv & ~frozen;
    }
    done = convd;
  } else if (C > 1) {
    // free-run: C-1 plain iterations, then one tested iteration; every
    // lane keeps iterating until the block's lanes are all done, k is
    // recorded at check granularity, and a done lane's reported residual
    // stays at its exit while its running one feeds the restart test
    float rkeep[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) rkeep[b] = RBIG;
    for (int it = 0; it < p.k_max && done != ALL;) {
      const int n_fast = min(C - 1, p.k_max - 1 - it);
      for (int f = 0; f < n_fast; ++f) iterate<false>(p, s, c, ln, 0u);
      const unsigned conv = iterate<false>(p, s, c, ln, 0u);
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        if (!bit(done, b)) {
          k[b] += n_fast + 1;
          rkeep[b] = ln.res[b];
        }
      }
      done |= conv;
      it += n_fast + 1;
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) ln.res[b] = rkeep[b];
  } else {
    // checked: exit tests every iteration; a converged lane freezes
    for (int it = 0; it < p.k_max && done != ALL; ++it) {
      const unsigned conv = iterate<true>(p, s, c, ln, done);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(done, b)) ++k[b];
      done |= conv;
    }
  }

  {
    float v[TB];
    if (c.zc) {
      load(v, s.zp + o);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        p.z[static_cast<size_t>(lane0 + b) * nzp + j] = v[b];
    }
    if (c.lc) {
      float w[TB];
      load(v, s.y + o);
      load(w, s.lam + o);
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const size_t rl = static_cast<size_t>(lane0 + b) * nlamp + j;
        p.y[rl] = v[b];
        p.lam[rl] = w[b];
      }
    }
  }
  if (j == 0) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      p.k[lane0 + b] = k[b];
      p.done[lane0 + b] = bit(done, b) ? 1 : 0;
      p.res[lane0 + b] = ln.res[b];
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t). The geometry comes from the wrapper
// (kernels/fused_fista.py launch_geometry) and is checked here again.
// Returns the CUDA error of the launch, as an int.
extern "C" int fused_fista_launch(
    const float* q1, const float* z0, const float* r0, const float* y0,
    const float* lam0, const float* g, const float* gt, const float* winvt,
    const float* hinv, const float* lb, const float* ub, float* z, float* y,
    float* lam, int* k, int* done, float* res, float* snap, int B, int nzp,
    int nlamp, int blocks, int threads, int smem, float tol, int k_max,
    int restart, int check_every, int fixed_iters, int exact_k,
    void* stream) {
  const long need = 4L * TB * (3L * nzp + 5L * nlamp + nlamp / 32);
  const bool exact = check_every > 1 && exact_k && fixed_iters <= 0;
  if (nzp <= 0 || nzp % 32 != 0 || nzp > MAX_COLS || nlamp <= 0 ||
      nlamp % 32 != 0 || nlamp > MAX_COLS || B % TB != 0 ||
      blocks != B / TB || threads != (nzp > nlamp ? nzp : nlamp) ||
      smem != need || check_every < 1 || k_max < 1 ||
      (exact && B > 0 && snap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_fista_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Params p{q1,    z0,    r0,          y0,          lam0,    g,
           gt,    winvt, hinv,        lb,          ub,      z,
           y,     lam,   k,           done,        res,     snap,
           nzp,   nlamp, tol,         k_max,       restart, check_every,
           fixed_iters,  exact_k};
  fused_fista_kernel<<<blocks, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
