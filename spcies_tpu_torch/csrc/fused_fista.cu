// Fused dual FISTA on NVIDIA Hopper (sm_90a), written by hand, on the
// product stage csrc/tile_product.cuh.
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
// version of every mode are in kernels/fused_fista.py. The
// one-column-per-thread kernel this design replaced is
// csrc/variants/fused_fista_parent.cu (tools/ab_kernels.py holds every build
// to it, bit for bit).
//
// Layout. A block of max(nzp, nlamp) threads (nzp: the padded decision
// vector, nlamp: the padded duals, each a multiple of 32 and at most 512;
// 256 and 192 at N=30) holds L = 8, 16 or 32 lanes
// (kernels/fused_fista.py launch_plan). In shared memory: q, z_prev, y and
// lam as [rows][L] (the swizzled layout of csrc/tile_product.cuh); r as
// [nlamp][L + 4], which is also the second product's input; one
// [max(nzp, nlamp)][L + 4] buffer for the first product's input dz and then
// the third's, dy. An iteration is a chain of three products on the stage,
// a thread owning 8 lanes x TC columns of each (TC = 4, 2, 1 at L = 32, 16,
// 8), the matrices' real rows coming through one ring of slabs that runs
// over G', Winv' and G in turn (tp::SegRing, whose warps release each slab
// by an mbarrier instead of waiting for each other at a barrier a slab):
//   1. thread j < nzp forms z and dz = z - z_prev of column j for the L
//      lanes, and z_prev = z;
//   2. r -= dz @ G' (width nlamp), each tile's owner updating its part of
//      r;                                                     __syncthreads
//   3. thread j < nlamp takes |r| of its column, and the row maxima go
//      through warp shuffles to shared memory;
//   4. lam' = y + r @ Winv' (width nlamp): after the product's first
//      barrier thread t < L (lane t's keeper, which holds its k, t and
//      residuals) takes lane t's res, the restart test, t' and the momentum
//      coefficient, and warp 0 publishes the lanes that meet tol; each
//      tile's owner then forms y', lam' and dy = y' - y of its part;
//   5. q -= dy @ G (width nzp), each tile's owner its part. __syncthreads
// Groups of 8 lanes that are done are skipped, and in exact-k's windows the
// lanes still running are compacted into the first groups and the tiles
// narrow (tile_product.cuh), so that a block's cost follows its live lanes.
// A lane that is frozen keeps q, z_prev, y, lam, t and its residuals; its r
// runs on and is never read again (r is no output, and a frozen lane stays
// frozen).
//
// Exact-k. At each window start the seven in-loop leaves of every lane not
// yet done are saved: the five vectors to global scratch (each thread
// writes, and later reads back, only its own rows), t, res and the window's
// first iteration to shared memory. A lane is done once a window's least
// residual meets tol (tp::run_modes with WMIN); then each lane's last
// window is replayed with the checked semantics and the budget min(C, k_max
// - kws).
//
// Bound. 2 (nz nlam + nlam^2 + nlam nz) FLOP an iteration and lane at the
// real widths; each block re-reads the real rows of G', Winv' and G from L2
// once an iteration for its L lanes. A small kernel before the loop's finds
// those rows (the last nonzero row of each matrix), so that pad rows, whose
// terms are exactly zero, are not multiplied.
//
// Arithmetic. fp32 on the CUDA cores, no TF32. The library is built with
// -fmad=false, so the element-wise steps (sqrtf and the division in the t
// update included) round as PyTorch's separate operations do; each product
// is an explicit fmaf chain over the rows in ascending order, as in the
// parent, so every build gives the parent's bits.
//
// Padding. Pad columns carry zero rows and columns of G, G' and Winv',
// zero hinv and [0, 0] bounds, so they stay exactly 0 and add nothing to
// the row maxima.

#include <cuda_runtime.h>

#include "tile_product.cuh"

// What the narrow builds (#if !WIDE_PART) and the wide build (#if
// WIDE_PART) share: the kernel that finds the matrices' real rows, and the
// element-wise parts of the iteration's steps, so that its arithmetic lies
// in one place.
namespace {

// ext[s] = 1 + the last row of matrix s (G', Winv', G) that holds a nonzero
// (ext zeroed by the wrapper): block (s, c) scans every gridDim.y-th row of
// matrix s from row c.
__global__ void row_extents(const float* __restrict__ gt,
                            const float* __restrict__ winvt,
                            const float* __restrict__ g, int nzp, int nlamp,
                            int* ext) {
  const int s = blockIdx.x;
  const float* m = s == 0 ? gt : s == 1 ? winvt : g;
  const int rows = s == 0 ? nzp : nlamp, cols = s == 2 ? nzp : nlamp;
  int last = 0;
  for (int i = blockIdx.y; i < rows; i += gridDim.y)
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
      if (m[static_cast<size_t>(i) * cols + c] != 0.0f) last = i + 1;
  if (last > 0) atomicMax(ext + s, last);
}

// 1. at column j, the lanes of group g: z = clip(-hinv q) (nhinv = -hinv),
// dz = z - z_prev into dv, and z_prev = z on the lanes not frozen.
template <int L>
__device__ __forceinline__ void z_step(const float* q, float* zp, float* dv,
                                       int j, int g, float nhinv, float lb,
                                       float ub, unsigned frozen) {
  float qv[8], zo[8], d[8];
  tp::ld8<L>(qv, q, j, g);
  tp::ld8<L>(zo, zp, j, g);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const float zn = fminf(fmaxf(nhinv * qv[b], lb), ub);
    d[b] = zn - zo[b];
    if (!tp::bit(frozen, 8 * g + b)) zo[b] = zn;
  }
  tp::st8_dq<L>(dv, j, g, d);
  tp::st8<L>(zp, j, g, zo);
}

// 2. the product's tile: r -= dz @ G' (its sums, acc).
template <int L, int TCX>
__device__ __forceinline__ void r_step(float* r, const tp::Tile<L, TCX>& tl,
                                       const float (&acc)[TCX][8]) {
#pragma unroll
  for (int c = 0; c < TCX; ++c) {
    float rv[8];
    tp::ld8_dq<L>(rv, r, tl.col(c), tl.lg);
#pragma unroll
    for (int b = 0; b < 8; ++b) rv[b] = rv[b] - acc[c][b];
    tp::st8_dq<L>(r, tl.col(c), tl.lg, rv);
  }
}

// 4. the product's tile: lam' = y + r @ Winv' (acc), y' = lam' + coef (lam'
// - lam) and dy = y' - y into dv, on the lanes of the tile's group not in
// `hold` (dy = 0 there).
template <int L, int TCX>
__device__ __forceinline__ void lam_step(float* y, float* lam, float* dv,
                                         const float* coef, unsigned hold,
                                         const tp::Tile<L, TCX>& tl,
                                         const float (&acc)[TCX][8]) {
  const float4 c0 = reinterpret_cast<const float4*>(coef)[2 * tl.lg];
  const float4 c1 = reinterpret_cast<const float4*>(coef)[2 * tl.lg + 1];
  const float cf[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
  for (int c = 0; c < TCX; ++c) {
    float yv[8], lv[8], d[8];
    tp::ld8<L>(yv, y, tl.col(c), tl.lg);
    tp::ld8<L>(lv, lam, tl.col(c), tl.lg);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if (tp::bit(hold, b)) {
        d[b] = 0.0f;
      } else {
        const float ln = yv[b] + acc[c][b];
        const float yn = ln + cf[b] * (ln - lv[b]);
        d[b] = yn - yv[b];
        yv[b] = yn;
        lv[b] = ln;
      }
    }
    tp::st8_dq<L>(dv, tl.col(c), tl.lg, d);
    tp::st8<L>(y, tl.col(c), tl.lg, yv);
    tp::st8<L>(lam, tl.col(c), tl.lg, lv);
  }
}

// 5. the product's tile: q -= dy @ G (acc) on the lanes of the tile's group
// not frozen (fz).
template <int L, int TCX>
__device__ __forceinline__ void q_step(float* q, unsigned fz,
                                       const tp::Tile<L, TCX>& tz,
                                       const float (&acc)[TCX][8]) {
#pragma unroll
  for (int c = 0; c < TCX; ++c) {
    float qv[8];
    tp::ld8<L>(qv, q, tz.col(c), tz.lg);
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (!tp::bit(fz, b)) qv[b] = qv[b] - acc[c][b];
    tp::st8<L>(q, tz.col(c), tz.lg, qv);
  }
}

}  // namespace

#if !WIDE_PART
// rows a slab of the ring and blocks an SM of each build up to NARROW
// columns (kernels/fused_fista.py BUILDS), and the columns a thread owns at
// 16 lanes; a timing script may set others
#ifndef FI_SLAB_8
#define FI_SLAB_8 16
#endif
#ifndef FI_BLOCKS_8
#define FI_BLOCKS_8 2
#endif
#ifndef FI_SLAB_16
#define FI_SLAB_16 16
#endif
#ifndef FI_BLOCKS_16
#define FI_BLOCKS_16 1
#endif
#ifndef FI_SLAB_32
#define FI_SLAB_32 16
#endif
#ifndef FI_BLOCKS_32
#define FI_BLOCKS_32 1
#endif
#ifndef FI_COLS_16
#define FI_COLS_16 2
#endif

namespace {

constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr int NARROW = 320;    // up to this width the builds of Build<L>
constexpr int WIDE_SLAB = 16;  // rows a slab above NARROW
constexpr int NSEG = 3;        // the ring's matrices: G', Winv', G
constexpr float RBIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

template <int L>
struct Build;
template <>
struct Build<8> {
  static constexpr int SR = FI_SLAB_8, MINB = FI_BLOCKS_8, TC = 1;
};
template <>
struct Build<16> {
  static constexpr int SR = FI_SLAB_16, MINB = FI_BLOCKS_16, TC = FI_COLS_16;
};
template <>
struct Build<32> {
  static constexpr int SR = FI_SLAB_32, MINB = FI_BLOCKS_32, TC = 4;
};

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
  float* snap;      // exact-k: per lane [q | z_prev | r | y | lam]
  int* ext;         // [0, 3): the real rows of G', Winv', G (row_extents);
                    // TP_CLOCKS: [4 + 4 b, 8 + 4 b) block b's kilo-clocks
                    // of its iterations and of each product's slab loop
  int nzp, nlamp;
  float tol;
  int k_max, restart, check_every, fixed_iters, exact_k;
};

using tp::bit;

// What lane t's keeper (thread t < L) holds of its lane: k, FISTA's t, the
// residual the restart test compares with (res) and the one a free-run
// check reports (rout).
struct Keeper {
  int k = 0;
  float t = 1.0f, res = RBIG, rout = RBIG;
};

template <int L, int TC, int SR>
struct Engine {
  static constexpr int G = L / 8;
  static constexpr int RS = L + tp::DQ_PAD;  // row stride of r and dv
  static constexpr unsigned ALL = L == 32 ? FULL : (1u << L) - 1u;
  const Params& p;
  float *q, *zp, *y, *lam;  // [rows][L], swizzled
  float* r;                 // [nlamp][RS]
  float* dv;                // [max(nzp, nlamp)][RS]: dz, then dy
  float* red;               // [warps][2][L]
  float* coef;              // [L]: the momentum coefficients
  unsigned* ctrl;           // [4]
  int *sn_k, *orig;         // exact-k: [L] each
  float *sn_t, *sn_res;     // exact-k: [L] each
  tp::SegRing<NSEG> ring;
  Keeper kp;
  int tid, T, nzp, nlamp, lane0;
  float nhinv, lbj, ubj;
  long long clk = 0;  // TP_CLOCKS: thread 0's clocks in iterate

  __device__ __forceinline__ Engine(const Params& p_, float* smem)
      : p(p_) {
    tid = threadIdx.x;
    nzp = p.nzp;
    nlamp = p.nlamp;
    T = max(nzp, nlamp);
    lane0 = blockIdx.x * L;
    float* a = smem + tp::ring_bytes(T, SR) / 4;
    q = a;
    zp = q + nzp * L;
    y = zp + nzp * L;
    lam = y + nlamp * L;
    r = lam + nlamp * L;
    dv = r + nlamp * RS;
    red = dv + T * RS;
    coef = red + (T >> 5) * 2 * L;
    ctrl = reinterpret_cast<unsigned*>(coef + L);
    sn_k = reinterpret_cast<int*>(ctrl + 4);
    orig = sn_k + L;
    sn_t = reinterpret_cast<float*>(orig + L);
    sn_res = sn_t + L;
    const bool zc = tid < nzp;
    nhinv = zc ? -p.hinv[tid] : 0.0f;
    lbj = zc ? p.lb[tid] : 0.0f;
    ubj = zc ? p.ub[tid] : 0.0f;
    const float* const m[NSEG] = {p.gt, p.winvt, p.g};
    const int P[NSEG] = {nlamp, nlamp, nzp};
    const int rows[NSEG] = {max(1, p.ext[0]), max(1, p.ext[1]),
                            max(1, p.ext[2])};
    tp::ring_init<SR>(ring, smem, m, P, rows, T, tid, T);
  }

  // One element of row c, lane b of a leaf: 0-1 q, z_prev; 2 r; 3-4 y, lam.
  __device__ __forceinline__ float& el(int l, int c, int b) {
    if (l == 2) return r[c * RS + b];
    float* const sw[4] = {q, zp, y, lam};
    return tp::at<L>(sw[l < 2 ? l : l - 1], c, b);
  }
  __device__ __forceinline__ int rows_of(int l) const {
    return l < 2 ? nzp : nlamp;
  }

  // One iteration (tp::run_modes). Lanes in `frozen` keep all their state;
  // what `idle` lanes hold is never read again, and a group of 8 lanes that
  // are all frozen or idle is skipped; with stop, the lanes that meet tol
  // here keep y, lam and t (the dense engine's momentum mask). With CHECK,
  // the keepers of the lanes in rmask record their residual and count kinc
  // iterations. Returns the lanes whose residual meets tol (identical in
  // every thread of the block), checked or not. `last` does not matter
  // here: K2's outputs are the state after a lane's last iteration.
  template <bool CHECK>
  TP_ITERATE unsigned iterate(unsigned frozen, unsigned idle, unsigned last,
                              bool stop, unsigned rmask, int kinc) {
    const long long t0 = TP_CLOCKS && tid == 0 ? clock64() : 0;
    const unsigned conv = iteration<CHECK>(frozen, idle, stop, rmask, kinc);
    if (TP_CLOCKS && tid == 0) clk += clock64() - t0;
    return conv;
  }

  template <bool CHECK>
  __device__ __forceinline__ unsigned iteration(unsigned frozen,
                                                unsigned idle, bool stop,
                                                unsigned rmask, int kinc) {
    const unsigned dead = tp::whole_groups<L>(frozen | idle);
    // 1. z = clip(-hinv q), dz = z - z_prev, z_prev = z
    if (tid < nzp) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (bit(dead, 8 * g)) continue;
        z_step<L>(q, zp, dv, tid, g, nhinv, lbj, ubj, frozen);
      }
    }
    // the widest tiles the live groups allow, as tp::TileEngine narrows them
    const int nl = max(1, G - __popc(dead) / 8);
    const bool packed = dead == (ALL & ~((1u << (8 * nl - 1) << 1) - 1u));
    if constexpr (TC >= 4 && G >= 4) {
      if (packed && 4 * nl <= G)
        return products<TC / 4, CHECK>(dead, frozen, stop, rmask, kinc);
    }
    if constexpr (TC >= 2 && G >= 2) {
      if (packed && 2 * nl <= G)
        return products<TC / 2, CHECK>(dead, frozen, stop, rmask, kinc);
    }
    return products<TC, CHECK>(dead, frozen, stop, rmask, kinc);
  }

  template <int TCX, bool CHECK>
  __device__ __forceinline__ unsigned products(unsigned dead,
                                               unsigned frozen, bool stop,
                                               unsigned rmask, int kinc) {
    const tp::Tile<L, TCX> tl(tid, nlamp), tz(tid, nzp);
    const bool live_l = tl.active && !bit(dead, 8 * tl.lg);
    const bool live_z = tz.active && !bit(dead, 8 * tz.lg);
    float acc[TCX][8];
    // 2. r -= dz @ G'
    zero(acc);
    tp::product<L, TCX, SR>(ring, 0, dv, tl, acc, live_l, tid, false,
                            [] {});
    if (live_l) r_step(r, tl, acc);
    __syncthreads();
    // 3. the row maxima of |r|
    if (tid < nlamp) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (bit(dead, 8 * g)) continue;
        float ab[8];
        tp::ld8_dq<L>(ab, r, tid, g);
#pragma unroll
        for (int b = 0; b < 8; ++b) ab[b] = fabsf(ab[b]);
        tp::warp_max<L>(ab, red, tid, 0, g);
      }
    }
    // 4. lam' = y + r @ Winv', the keepers' part after its first barrier
    zero(acc);
    tp::product<L, TCX, SR>(ring, 1, r, tl, acc, live_l, tid, true, [&] {
      if (tid < 32) this->template keep<CHECK>(frozen, stop, rmask, kinc);
    });
    if (live_l)
      lam_step(y, lam, dv, coef,
               (frozen | (stop ? ctrl[0] : 0u)) >> (8 * tl.lg), tl, acc);
    // 5. q -= dy @ G
    zero(acc);
    tp::product<L, TCX, SR>(ring, 2, dv, tz, acc, live_z, tid, false,
                            [] {});
    if (live_z) q_step(q, frozen >> (8 * tz.lg), tz, acc);
    __syncthreads();
    return ctrl[0];
  }

  template <int TCX>
  static __device__ __forceinline__ void zero(float (&acc)[TCX][8]) {
#pragma unroll
    for (int c = 0; c < TCX; ++c) {
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[c][b] = 0.0f;
    }
  }

  // The keepers' part of an iteration, run by all of warp 0: lane t's res
  // over the warps' maxima, the restart test, t' and the momentum
  // coefficient (coef[t]); the lanes that meet tol go to ctrl[0].
  template <bool CHECK>
  __device__ __forceinline__ void keep(unsigned frozen, bool stop,
                                       unsigned rmask, int kinc) {
    bool conv = false;
    if (tid < L) {
      const float rs = tp::lane_max<L>(red, nlamp >> 5, 0, tid);
      float tc = kp.t;
      if (p.restart && rs > kp.res) tc = 1.0f;
      const float tn = 0.5f * (1.0f + sqrtf(1.0f + 4.0f * tc * tc));
      coef[tid] = (tc - 1.0f) / tn;
      conv = rs <= p.tol;
      if (!bit(frozen, tid)) {
        kp.res = rs;
        if (!(stop && conv)) kp.t = tn;
      }
      if (CHECK && bit(rmask, tid)) {
        kp.k += kinc;
        kp.rout = rs;
      }
    }
    const unsigned m = __ballot_sync(FULL, conv);
    if (tid == 0) ctrl[0] = m;
  }

  // Exact-k compaction (tp::compact_lanes) over the five leaves, the
  // keepers' t and res moving with their lanes.
  __device__ __forceinline__ unsigned compact(unsigned done) {
    const unsigned live = ~done & ALL;
    const int n = __popc(live);
    if (__popc(tp::whole_groups<L>(done)) / 8 == (L - n) / 8) return done;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      if (tid >= rows_of(l)) continue;
      int to = 0;
      for (int s = 0; s < L; ++s) {
        if (!bit(live, s)) continue;
        if (s != to) el(l, tid, to) = el(l, tid, s);
        ++to;
      }
    }
    if (tid < 32) {
      // slot tid takes the tid-th live slot's lane
      int src = tid, seen = 0;
      for (int s = 0; s < L; ++s) {
        if (!bit(live, s)) continue;
        if (seen++ == tid) src = s;
      }
      const float t = __shfl_sync(FULL, kp.t, src);
      const float rs = __shfl_sync(FULL, kp.res, src);
      if (tid < n) {
        kp.t = t;
        kp.res = rs;
      }
      if (tid == 0) {
        int to = 0;
        for (int s = 0; s < L; ++s) {
          if (!bit(live, s)) continue;
          orig[to++] = orig[s];
        }
      }
    }
    __syncthreads();
    return n == 32 ? 0u : ALL & ~((1u << n) - 1u);
  }

  // Exact-k: this thread's rows of the five leaves between shared memory
  // and the lanes' snapshots ([q | z_prev | r | y | lam]), and the keepers'
  // t and res, for the slots in `lanes` (slot b holds lane orig[b]).
  template <bool TO_GLOBAL>
  __device__ __forceinline__ void snapshot(unsigned lanes) {
    const int W = 2 * nzp + 3 * nlamp;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      if (tid >= rows_of(l)) continue;
      const int off = l < 2 ? l * nzp : 2 * nzp + (l - 2) * nlamp;
      for (int b = 0; b < L; ++b) {
        if (!bit(lanes, b)) continue;
        float* g = p.snap + static_cast<size_t>(lane0 + orig[b]) * W + off +
                   tid;
        if (TO_GLOBAL)
          *g = el(l, tid, b);
        else
          el(l, tid, b) = *g;
      }
    }
    if (tid < L && bit(lanes, tid)) {
      if (TO_GLOBAL) {
        sn_t[orig[tid]] = kp.t;
        sn_res[orig[tid]] = kp.res;
      } else {
        kp.t = sn_t[tid];
        kp.res = sn_res[tid];
      }
    }
    if (!TO_GLOBAL) __syncthreads();
  }
};

template <int L, int TC, int MAXT, int MINB, int SR>
__global__ void __launch_bounds__(MAXT, MINB) fused_fista_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  Engine<L, TC, SR> e(p, smem);
  const int j = e.tid;
  const int nzp = p.nzp, nlamp = p.nlamp;
  for (int b = 0; b < L; ++b) {
    const size_t lz = static_cast<size_t>(e.lane0 + b) * nzp + j;
    const size_t ll = static_cast<size_t>(e.lane0 + b) * nlamp + j;
    if (j < nzp) {
      tp::at<L>(e.q, j, b) = p.q1[lz];
      tp::at<L>(e.zp, j, b) = p.z0[lz];
    }
    if (j < nlamp) {
      e.r[j * e.RS + b] = p.r0[ll];
      tp::at<L>(e.y, j, b) = p.y0[ll];
      tp::at<L>(e.lam, j, b) = p.lam0[ll];
    }
  }
  if (j < L) {
    e.sn_k[j] = 0;
    e.orig[j] = j;
  }
  __syncthreads();
  const unsigned done = tp::run_modes<L, true>(e, p.k_max, p.check_every,
                                               p.exact_k, p.fixed_iters);
  tp::ring_drain(e.ring);
  for (int b = 0; b < L; ++b) {
    const size_t lz = static_cast<size_t>(e.lane0 + b) * nzp + j;
    const size_t ll = static_cast<size_t>(e.lane0 + b) * nlamp + j;
    if (j < nzp) p.z[lz] = tp::at<L>(e.zp, j, b);
    if (j < nlamp) {
      p.y[ll] = tp::at<L>(e.y, j, b);
      p.lam[ll] = tp::at<L>(e.lam, j, b);
    }
  }
  if (j < L) {
    // plain free-run reports the residual of each lane's exit check; every
    // other mode the last one its lane took
    const bool free_run =
        p.fixed_iters <= 0 && p.check_every > 1 && !p.exact_k;
    const int lane = e.lane0 + j;
    p.k[lane] = e.kp.k;
    p.done[lane] = bit(done, j) ? 1 : 0;
    p.res[lane] = free_run ? e.kp.rout : e.kp.res;
  }
  if (TP_CLOCKS && j == 0) {
    int* c = p.ext + 4 + 4 * blockIdx.x;
    c[0] = static_cast<int>(e.clk >> 10);
    for (int s = 0; s < NSEG; ++s)
      c[1 + s] = static_cast<int>(e.ring.clk[s] >> 10);
  }
}

// Rows a slab of the build that runs `threads` threads at `lanes` lanes.
int slab_rows(int threads, int lanes) {
  if (threads > NARROW) return WIDE_SLAB;
  return lanes == 8 ? Build<8>::SR : lanes == 16 ? Build<16>::SR
                                                 : Build<32>::SR;
}

template <int L>
int launch(const Params& p, int blocks, int threads, int smem, void* stream) {
  // up to NARROW columns the build of Build<L>; wider, one block of up to
  // MAX_COLS threads an SM (not at 32 lanes: its state does not fit)
  void (*kernel)(Params) = nullptr;
  if (threads <= NARROW)
    kernel = fused_fista_kernel<L, Build<L>::TC, NARROW, Build<L>::MINB,
                                Build<L>::SR>;
  else if constexpr (L < 32)
    kernel = fused_fista_kernel<L, Build<L>::TC, MAX_COLS, 1, WIDE_SLAB>;
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

// Dynamic shared bytes at `lanes` lanes a block (kernels/fused_fista.py
// shared_bytes computes the same): the ring of slabs of the widest row, q,
// z_prev, y and lam as [rows][lanes], r and the dz/dy buffer with their
// padding, the warps' row maxima, the coefficients, the masks, the window
// starts, the slots' lanes and the snapshot's t and res.
extern "C" long fused_fista_smem(int nzp, int nlamp, int lanes) {
  const long T = nzp > nlamp ? nzp : nlamp;
  return tp::ring_bytes(T, slab_rows(T, lanes)) +
         4L * ((2L * nzp + 2L * nlamp) * lanes +
               (nlamp + T) * (lanes + tp::DQ_PAD) + (T / 32) * 2L * lanes +
               lanes + 4 + 4L * lanes);
}

// Launch on `stream` (a cudaStream_t). The geometry comes from the wrapper
// (kernels/fused_fista.py launch_plan) and is checked here again: B / lanes
// blocks of max(nzp, nlamp) threads; `ext` is 4 + 4 blocks int32 zeros.
// Returns the CUDA error of the launch, as an int.
extern "C" int fused_fista_launch(
    const float* q1, const float* z0, const float* r0, const float* y0,
    const float* lam0, const float* g, const float* gt, const float* winvt,
    const float* hinv, const float* lb, const float* ub, float* z, float* y,
    float* lam, int* k, int* done, float* res, float* snap, int* ext, int B,
    int nzp, int nlamp, int lanes, int blocks, int threads, int smem,
    float tol, int k_max, int restart, int check_every, int fixed_iters,
    int exact_k, void* stream) {
  const bool exact = check_every > 1 && exact_k && fixed_iters <= 0;
  const int T = nzp > nlamp ? nzp : nlamp;
  if (nzp <= 0 || nzp % 32 != 0 || nzp > MAX_COLS || nlamp <= 0 ||
      nlamp % 32 != 0 || nlamp > MAX_COLS ||
      (lanes != 8 && lanes != 16 && lanes != 32) ||
      (lanes == 32 && T > NARROW) || B % lanes != 0 ||
      blocks != B / lanes || threads != T ||
      smem != fused_fista_smem(nzp, nlamp, lanes) || check_every < 1 ||
      k_max < 1 || (exact && B > 0 && snap == nullptr) || ext == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  row_extents<<<dim3(3, 16), 256, 0, st>>>(gt, winvt, g, nzp, nlamp, ext);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p{q1,    z0,    r0,    y0,          lam0,    g,
           gt,    winvt, hinv,  lb,          ub,      z,
           y,     lam,   k,     done,        res,     snap,
           ext,   nzp,   nlamp, tol,         k_max,   restart,
           check_every,  fixed_iters,        exact_k};
  switch (lanes) {
    case 8:
      return launch<8>(p, blocks, threads, smem, stream);
    case 16:
      return launch<16>(p, blocks, threads, smem, stream);
    default:
      return launch<32>(p, blocks, threads, smem, stream);
  }
}
#endif  // !WIDE_PART


#if WIDE_PART
// The wide build, a translation unit of its own (-DWIDE_PART=1;
// kernels/_build.py compiles the narrow builds above with -DWIDE_PART=0
// from exactly their text).
//
// Past MAX_COLS columns of either width, up to tp::WIDE_COLS = 1024:
// fused_fista_wide_kernel runs WideEngine, the narrow Engine's iteration on
// tp::WIDE_THREADS = 512 threads of tp::WIDE_CPT = 2 columns of each width
// (t and t + 512), at 16 or 8 lanes a block (kernels/stage.py
// WIDE_BUILDS), one block per L lanes and no refill, its modes
// tp::run_modes' with the window-minimum exit, as the narrow builds run
// them. Its three products are the narrow builds' on the stage: tiles of 8
// lanes x TC columns of each output width (TC = tp::wide_tc<L>(): 4 at 16
// lanes, 2 at 8, so that the tiles of a width up to 1024 fit 512 threads),
// the real rows of G', Winv' and G through one tp::SegRing, whose 16 warps
// each release every slab once, whatever columns their threads own. The
// four leaves lie in the block's global scratch ([rows][L], swizzled), so
// that the ring takes 16-row slabs where they fit beside r and dz/dy, else
// 8-row slabs (wide_slab_rows: 16 rows at 544 x 416 columns, 8 at 1024 x
// 768 with 16 lanes; each slab's load is waited for, and at 544 x 416 a
// ring of 8-row slabs beside q, y and lam in shared memory was the slower
// layout). z_prev is touched by its column's thread alone, in step 1, so
// it needs no barrier; q, y and lam are updated by their tile owners in the
// products, and every read of them comes after the barrier each product
// already ends with. The row maxima of |r| are taken over a thread's two
// columns, then its warp. Both engines run the steps' element-wise parts
// through z_step, r_step, lam_step and q_step above. The build before this
// one ran the first wide layout (8 lanes a block, the matrices read from L2
// by every thread).

namespace {

constexpr int NSEG = 3;  // the ring's matrices: G', Winv', G
constexpr int WARPS = tp::WIDE_THREADS / 32;
constexpr float RBIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

struct WideParams {
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
  float* snap;      // exact-k: per lane [q | z_prev | r | y | lam]
  float* scratch;   // [blocks][2 nzp + 2 nlamp][L]: z_prev, q, y, lam
  int* ext;         // [0, 3): the real rows of G', Winv', G (row_extents);
                    // TP_CLOCKS: [4 + 4 b, 8 + 4 b) block b's kilo-clocks
                    // of its iterations and of each product's slab loop
  int nzp, nlamp;
  float tol;
  int k_max, restart, check_every, fixed_iters, exact_k;
};

using tp::bit;

// What lane t's keeper (thread t < L) holds of its lane: k, FISTA's t, the
// residual the restart test compares with (res) and the one a free-run
// check reports (rout).
struct Keeper {
  int k = 0;
  float t = 1.0f, res = RBIG, rout = RBIG;
};

int widest(int a, int b) { return a > b ? a : b; }

// Dynamic shared bytes at `lanes` lanes and slabs of sr rows: the ring of
// slabs of the widest row, r and the dz/dy buffer with their padding, the
// 16 warps' row maxima, the coefficients, the masks, the window starts,
// the slots' lanes and the snapshot's t and res.
long wide_bytes(int nzp, int nlamp, int lanes, int sr) {
  return tp::ring_bytes(widest(nzp, nlamp), sr) +
         4L * ((nlamp + widest(nzp, nlamp)) * (lanes + tp::DQ_PAD) +
               WARPS * 2L * lanes + lanes + 4 + 4L * lanes);
}

// Rows a slab: 16 where they fit, else 8.
int wide_slab_rows(int nzp, int nlamp, int lanes) {
  return wide_bytes(nzp, nlamp, lanes, tp::WIDE_SLAB_16) <= tp::SMEM_MAX
             ? tp::WIDE_SLAB_16
             : tp::WIDE_SLAB_8;
}

template <int L, int TC, int SR>
struct WideEngine {
  static constexpr int G = L / 8;
  static constexpr int RS = L + tp::DQ_PAD;  // row stride of r and dv
  static constexpr int T = tp::WIDE_THREADS;
  static constexpr unsigned ALL = (1u << L) - 1u;
  const WideParams& p;
  float *q, *zp, *y, *lam;  // the block's global scratch: [rows][L] each,
                            // swizzled
  float* r;                 // [nlamp][RS]
  float* dv;                // [max(nzp, nlamp)][RS]: dz, then dy
  float* red;               // [WARPS][2][L]
  float* coef;              // [L]: the momentum coefficients
  unsigned* ctrl;           // [4]
  int *sn_k, *orig;         // exact-k: [L] each
  float *sn_t, *sn_res;     // exact-k: [L] each
  tp::SegRing<NSEG> ring;
  Keeper kp;
  int tid, nzp, nlamp, lane0;
  long long clk = 0;  // TP_CLOCKS: thread 0's clocks in iterate

  // The thread's c-th column (c < tp::WIDE_CPT) of each width; none where
  // it is past the width, which holds for whole warps.
  __device__ __forceinline__ int col(int c) const { return tid + c * T; }

  __device__ __forceinline__ WideEngine(const WideParams& p_, float* smem)
      : p(p_) {
    tid = threadIdx.x;
    nzp = p.nzp;
    nlamp = p.nlamp;
    const int W = max(nzp, nlamp);
    lane0 = blockIdx.x * L;
    zp = p.scratch +
         static_cast<size_t>(blockIdx.x) * (2 * nzp + 2 * nlamp) * L;
    q = zp + nzp * L;
    y = q + nzp * L;
    lam = y + nlamp * L;
    r = smem + tp::ring_bytes(W, SR) / 4;
    dv = r + nlamp * RS;
    red = dv + W * RS;
    coef = red + WARPS * 2 * L;
    ctrl = reinterpret_cast<unsigned*>(coef + L);
    sn_k = reinterpret_cast<int*>(ctrl + 4);
    orig = sn_k + L;
    sn_t = reinterpret_cast<float*>(orig + L);
    sn_res = sn_t + L;
    const float* const m[NSEG] = {p.gt, p.winvt, p.g};
    const int P[NSEG] = {nlamp, nlamp, nzp};
    const int rows[NSEG] = {max(1, p.ext[0]), max(1, p.ext[1]),
                            max(1, p.ext[2])};
    tp::ring_init<SR>(ring, smem, m, P, rows, W, tid, T);
  }

  // One element of row c, lane b of a leaf: 0-1 q, z_prev; 2 r; 3-4 y, lam.
  __device__ __forceinline__ float& el(int l, int c, int b) {
    if (l == 2) return r[c * RS + b];
    float* const sw[4] = {q, zp, y, lam};
    return tp::at<L>(sw[l < 2 ? l : l - 1], c, b);
  }
  __device__ __forceinline__ int rows_of(int l) const {
    return l < 2 ? nzp : nlamp;
  }

  // One iteration (tp::run_modes), as the narrow Engine's: lanes in
  // `frozen` keep all their state; what `idle` lanes hold is never read
  // again, and a group of 8 lanes that are all frozen or idle is skipped;
  // with stop, the lanes that meet tol here keep y, lam and t. With CHECK,
  // the keepers of the lanes in rmask record their residual and count kinc
  // iterations. Returns the lanes whose residual meets tol (identical in
  // every thread of the block), checked or not.
  template <bool CHECK>
  TP_ITERATE unsigned iterate(unsigned frozen, unsigned idle, unsigned last,
                              bool stop, unsigned rmask, int kinc) {
    const long long t0 = TP_CLOCKS && tid == 0 ? clock64() : 0;
    const unsigned conv = iteration<CHECK>(frozen, idle, stop, rmask, kinc);
    if (TP_CLOCKS && tid == 0) clk += clock64() - t0;
    return conv;
  }

  template <bool CHECK>
  __device__ __forceinline__ unsigned iteration(unsigned frozen,
                                                unsigned idle, bool stop,
                                                unsigned rmask, int kinc) {
    const unsigned dead = tp::whole_groups<L>(frozen | idle);
    // 1. z = clip(-hinv q), dz = z - z_prev, z_prev = z
#pragma unroll
    for (int c = 0; c < tp::WIDE_CPT; ++c) {
      const int j = col(c);
      if (j >= nzp) break;
      const float nhinv = -__ldg(p.hinv + j), lbj = __ldg(p.lb + j),
                  ubj = __ldg(p.ub + j);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (bit(dead, 8 * g)) continue;
        z_step<L>(q, zp, dv, j, g, nhinv, lbj, ubj, frozen);
      }
    }
    // the widest tiles the live groups allow, as tp::TileEngine narrows them
    const int nl = max(1, G - __popc(dead) / 8);
    const bool packed = dead == (ALL & ~((1u << (8 * nl - 1) << 1) - 1u));
    if constexpr (TC >= 2 && G >= 2) {
      if (packed && 2 * nl <= G)
        return products<TC / 2, CHECK>(dead, frozen, stop, rmask, kinc);
    }
    return products<TC, CHECK>(dead, frozen, stop, rmask, kinc);
  }

  template <int TCX, bool CHECK>
  __device__ __forceinline__ unsigned products(unsigned dead,
                                               unsigned frozen, bool stop,
                                               unsigned rmask, int kinc) {
    const tp::Tile<L, TCX> tl(tid, nlamp), tz(tid, nzp);
    const bool live_l = tl.active && !bit(dead, 8 * tl.lg);
    const bool live_z = tz.active && !bit(dead, 8 * tz.lg);
    float acc[TCX][8];
    // 2. r -= dz @ G'
    zero(acc);
    tp::product<L, TCX, SR>(ring, 0, dv, tl, acc, live_l, tid, false,
                            [] {});
    if (live_l) r_step(r, tl, acc);
    __syncthreads();
    // 3. the row maxima of |r|, over the thread's columns, then its warp
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float ab[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) ab[b] = 0.0f;
#pragma unroll
      for (int c = 0; c < tp::WIDE_CPT; ++c) {
        const int j = col(c);
        if (j >= nlamp) break;
        float rv[8];
        tp::ld8_dq<L>(rv, r, j, g);
#pragma unroll
        for (int b = 0; b < 8; ++b) ab[b] = fmaxf(ab[b], fabsf(rv[b]));
      }
      tp::warp_max<L>(ab, red, tid, 0, g);
    }
    // 4. lam' = y + r @ Winv', the keepers' part after its first barrier
    zero(acc);
    tp::product<L, TCX, SR>(ring, 1, r, tl, acc, live_l, tid, true, [&] {
      if (tid < 32) this->template keep<CHECK>(frozen, stop, rmask, kinc);
    });
    if (live_l)
      lam_step(y, lam, dv, coef,
               (frozen | (stop ? ctrl[0] : 0u)) >> (8 * tl.lg), tl, acc);
    // 5. q -= dy @ G
    zero(acc);
    tp::product<L, TCX, SR>(ring, 2, dv, tz, acc, live_z, tid, false,
                            [] {});
    if (live_z) q_step(q, frozen >> (8 * tz.lg), tz, acc);
    __syncthreads();
    return ctrl[0];
  }

  template <int TCX>
  static __device__ __forceinline__ void zero(float (&acc)[TCX][8]) {
#pragma unroll
    for (int c = 0; c < TCX; ++c) {
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[c][b] = 0.0f;
    }
  }

  // The keepers' part of an iteration, run by all of warp 0, as the narrow
  // Engine's over the 16 warps' maxima.
  template <bool CHECK>
  __device__ __forceinline__ void keep(unsigned frozen, bool stop,
                                       unsigned rmask, int kinc) {
    bool conv = false;
    if (tid < L) {
      const float rs = tp::lane_max<L>(red, WARPS, 0, tid);
      float tc = kp.t;
      if (p.restart && rs > kp.res) tc = 1.0f;
      const float tn = 0.5f * (1.0f + sqrtf(1.0f + 4.0f * tc * tc));
      coef[tid] = (tc - 1.0f) / tn;
      conv = rs <= p.tol;
      if (!bit(frozen, tid)) {
        kp.res = rs;
        if (!(stop && conv)) kp.t = tn;
      }
      if (CHECK && bit(rmask, tid)) {
        kp.k += kinc;
        kp.rout = rs;
      }
    }
    const unsigned m = __ballot_sync(FULL, conv);
    if (tid == 0) ctrl[0] = m;
  }

  // Exact-k compaction (tp::compact_lanes) over the five leaves of the
  // thread's columns, the keepers' t and res moving with their lanes.
  __device__ __forceinline__ unsigned compact(unsigned done) {
    const unsigned live = ~done & ALL;
    const int n = __popc(live);
    if (__popc(tp::whole_groups<L>(done)) / 8 == (L - n) / 8) return done;
#pragma unroll
    for (int c = 0; c < tp::WIDE_CPT; ++c) {
      const int j = col(c);
#pragma unroll
      for (int l = 0; l < 5; ++l) {
        if (j >= rows_of(l)) continue;
        int to = 0;
        for (int s = 0; s < L; ++s) {
          if (!bit(live, s)) continue;
          if (s != to) el(l, j, to) = el(l, j, s);
          ++to;
        }
      }
    }
    if (tid < 32) {
      // slot tid takes the tid-th live slot's lane
      int src = tid, seen = 0;
      for (int s = 0; s < L; ++s) {
        if (!bit(live, s)) continue;
        if (seen++ == tid) src = s;
      }
      const float t = __shfl_sync(FULL, kp.t, src);
      const float rs = __shfl_sync(FULL, kp.res, src);
      if (tid < n) {
        kp.t = t;
        kp.res = rs;
      }
      if (tid == 0) {
        int to = 0;
        for (int s = 0; s < L; ++s) {
          if (!bit(live, s)) continue;
          orig[to++] = orig[s];
        }
      }
    }
    __syncthreads();
    return ALL & ~((1u << n) - 1u);
  }

  // Exact-k: the thread's rows of the five leaves between their places and
  // the lanes' snapshots ([q | z_prev | r | y | lam]), and the keepers' t
  // and res, for the slots in `lanes` (slot b holds lane orig[b]).
  template <bool TO_GLOBAL>
  __device__ __forceinline__ void snapshot(unsigned lanes) {
    const int W = 2 * nzp + 3 * nlamp;
#pragma unroll
    for (int c = 0; c < tp::WIDE_CPT; ++c) {
      const int j = col(c);
#pragma unroll
      for (int l = 0; l < 5; ++l) {
        if (j >= rows_of(l)) continue;
        const int off = l < 2 ? l * nzp : 2 * nzp + (l - 2) * nlamp;
        for (int b = 0; b < L; ++b) {
          if (!bit(lanes, b)) continue;
          float* g = p.snap + static_cast<size_t>(lane0 + orig[b]) * W +
                     off + j;
          if (TO_GLOBAL)
            *g = el(l, j, b);
          else
            el(l, j, b) = *g;
        }
      }
    }
    if (tid < L && bit(lanes, tid)) {
      if (TO_GLOBAL) {
        sn_t[orig[tid]] = kp.t;
        sn_res[orig[tid]] = kp.res;
      } else {
        kp.t = sn_t[tid];
        kp.res = sn_res[tid];
      }
    }
    if (!TO_GLOBAL) __syncthreads();
  }
};

template <int L, int TC, int SR>
__global__ void __launch_bounds__(tp::WIDE_THREADS, 1)
    fused_fista_wide_kernel(WideParams p) {
  extern __shared__ __align__(16) float smem[];
  WideEngine<L, TC, SR> e(p, smem);
  const int nzp = p.nzp, nlamp = p.nlamp;
#pragma unroll
  for (int c = 0; c < tp::WIDE_CPT; ++c) {
    const int j = e.col(c);
    for (int b = 0; b < L; ++b) {
      const size_t lz = static_cast<size_t>(e.lane0 + b) * nzp + j;
      const size_t ll = static_cast<size_t>(e.lane0 + b) * nlamp + j;
      if (j < nzp) {
        tp::at<L>(e.q, j, b) = p.q1[lz];
        tp::at<L>(e.zp, j, b) = p.z0[lz];
      }
      if (j < nlamp) {
        e.r[j * e.RS + b] = p.r0[ll];
        tp::at<L>(e.y, j, b) = p.y0[ll];
        tp::at<L>(e.lam, j, b) = p.lam0[ll];
      }
    }
  }
  if (e.tid < L) {
    e.sn_k[e.tid] = 0;
    e.orig[e.tid] = e.tid;
  }
  __syncthreads();
  const unsigned done = tp::run_modes<L, true>(e, p.k_max, p.check_every,
                                               p.exact_k, p.fixed_iters);
  tp::ring_drain(e.ring);
#pragma unroll
  for (int c = 0; c < tp::WIDE_CPT; ++c) {
    const int j = e.col(c);
    for (int b = 0; b < L; ++b) {
      const size_t lz = static_cast<size_t>(e.lane0 + b) * nzp + j;
      const size_t ll = static_cast<size_t>(e.lane0 + b) * nlamp + j;
      if (j < nzp) p.z[lz] = tp::at<L>(e.zp, j, b);
      if (j < nlamp) {
        p.y[ll] = tp::at<L>(e.y, j, b);
        p.lam[ll] = tp::at<L>(e.lam, j, b);
      }
    }
  }
  if (e.tid < L) {
    // plain free-run reports the residual of each lane's exit check; every
    // other mode the last one its lane took
    const bool free_run =
        p.fixed_iters <= 0 && p.check_every > 1 && !p.exact_k;
    const int lane = e.lane0 + e.tid;
    p.k[lane] = e.kp.k;
    p.done[lane] = bit(done, e.tid) ? 1 : 0;
    p.res[lane] = free_run ? e.kp.rout : e.kp.res;
  }
  if (TP_CLOCKS && e.tid == 0) {
    int* c = p.ext + 4 + 4 * blockIdx.x;
    c[0] = static_cast<int>(e.clk >> 10);
    for (int s = 0; s < NSEG; ++s)
      c[1 + s] = static_cast<int>(e.ring.clk[s] >> 10);
  }
}

template <int L, int SR>
int wide_launch(const WideParams& p, int blocks, int smem, void* stream) {
  void (*kernel)(WideParams) =
      fused_fista_wide_kernel<L, tp::wide_tc<L>(), SR>;
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

// Dynamic shared bytes of a block of the wide build at `lanes` lanes
// (kernels/fused_fista.py shared_bytes(nzp, nlamp, lanes, wide=True)
// computes the same): wide_bytes of wide_slab_rows.
extern "C" long fused_fista_wide_smem(int nzp, int nlamp, int lanes) {
  return wide_bytes(nzp, nlamp, lanes, wide_slab_rows(nzp, nlamp, lanes));
}

// Launch the wide build on `stream`: the arguments of fused_fista_launch
// with `scratch`, the blocks' leaves (B x (2 nzp + 2 nlamp) floats),
// before `ext`; `threads`
// tp::WIDE_THREADS, `lanes` 8 or 16, both widths up to tp::WIDE_COLS, B /
// lanes blocks. The geometry comes from the wrapper (kernels/fused_fista.py
// launch_plan with wide=True) and is checked here again. Returns the CUDA
// error of the launch, as an int.
extern "C" int fused_fista_wide_launch(
    const float* q1, const float* z0, const float* r0, const float* y0,
    const float* lam0, const float* g, const float* gt, const float* winvt,
    const float* hinv, const float* lb, const float* ub, float* z, float* y,
    float* lam, int* k, int* done, float* res, float* snap, float* scratch,
    int* ext, int B, int nzp, int nlamp, int lanes, int blocks, int threads,
    int smem, float tol, int k_max, int restart, int check_every,
    int fixed_iters, int exact_k, void* stream) {
  const bool exact = check_every > 1 && exact_k && fixed_iters <= 0;
  if (nzp <= 0 || nzp % 32 != 0 || nzp > tp::WIDE_COLS || nlamp <= 0 ||
      nlamp % 32 != 0 || nlamp > tp::WIDE_COLS ||
      (lanes != 8 && lanes != 16) || B % lanes != 0 ||
      blocks != B / lanes || threads != tp::WIDE_THREADS ||
      smem != fused_fista_wide_smem(nzp, nlamp, lanes) ||
      smem > tp::SMEM_MAX || check_every < 1 || k_max < 1 ||
      ext == nullptr ||
      (B > 0 && (scratch == nullptr || (exact && snap == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  row_extents<<<dim3(3, 16), 256, 0, st>>>(gt, winvt, g, nzp, nlamp, ext);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const WideParams p{q1,    z0,    r0,    y0,          lam0,    g,
                     gt,    winvt, hinv,  lb,          ub,      z,
                     y,     lam,   k,     done,        res,     snap,
                     scratch,      ext,   nzp,         nlamp,   tol,
                     k_max, restart,      check_every, fixed_iters,
                     exact_k};
  // up to tp::WIDE_COLS columns 8 lanes always take 16-row slabs
  const int sr = wide_slab_rows(nzp, nlamp, lanes);
  if (lanes == 8 && sr == tp::WIDE_SLAB_16)
    return wide_launch<8, tp::WIDE_SLAB_16>(p, blocks, smem, stream);
  if (lanes == 16)
    return sr == tp::WIDE_SLAB_16
               ? wide_launch<16, tp::WIDE_SLAB_16>(p, blocks, smem, stream)
               : wide_launch<16, tp::WIDE_SLAB_8>(p, blocks, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

#endif  // WIDE_PART
