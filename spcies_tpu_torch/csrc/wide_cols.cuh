// The wide builds of K2-K7 on NVIDIA Hopper (sm_90a), written by hand:
// what csrc/fused_fista.cu (K2), csrc/fused_eadmm.cu (K3),
// csrc/fused_ellip.cu (K4), csrc/fused_soc.cu (K5), csrc/fused_hmpc.cu (K6)
// and csrc/fused_split.cu (K7) share in the kernels they run past 512
// padded columns, up to COLS = 1024.
//
// Layout. A block holds TB = 8 lanes on THREADS = 512 threads, and thread
// t owns columns t and t + THREADS of each width (CPT = 2 columns a
// thread): the first layout of the kernels (one column a thread, 8 lanes
// a block, the matrices read from L2; csrc/variants/fused_*_parent.cu and
// csrc/fused_split.cu) with each thread taking two columns. The per-column
// code is the first layout's, so each (lane, column) sum is the same fmaf
// chain over the same rows in the same order: a wide build gives the bits
// of the first layout, which are the narrow builds' bits. Threads past a
// width own no column there (a wide build also runs at the narrow widths,
// for a check of bits).
//
// Columns a thread owns lie in whole warps: a warp's 32 threads own the 32
// columns [32 w, 32 w + 32) in the first half and [512 + 32 w, ...) in the
// second, so warp shuffles within 32 columns (the cones of K6 and K7, the
// s slab of K5, the terminal slab of K4) run over one half at a time, and
// whether a thread owns a column of a half is the same in its whole warp
// (every width is whole warps).
//
// State. Only what crosses threads lives in shared memory: the products'
// inputs as [rows][TB], the warps' row maxima and, in K6, the prepared z
// (the input of its first product). Each lane's state for a thread's own
// columns lives in global memory that only that thread touches, as
// [block][leaf][P][TB] (`leaf` below): at 1024 columns the narrow builds'
// state as [P][lanes] in shared memory no longer fits beside the rest.
//
// Row maxima are taken over a thread's two columns with fmaxf, then over
// the warp and the warps: a maximum does not depend on its order, so the
// residuals are those of the first layout.

#pragma once

#include <cuda_runtime.h>

namespace wc {

constexpr int TB = 8;                  // lanes a block
constexpr int THREADS = 512;           // threads a block
constexpr int CPT = 2;                 // columns a thread
constexpr int COLS = CPT * THREADS;    // the widest padded width
constexpr int WARPS = THREADS / 32;    // warps a block
constexpr long SMEM_MAX = 232448;      // dynamic shared bytes a block can have
constexpr float RBIG = 3.4e38f;        // "no residual yet"
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ALL = (1u << TB) - 1u;
static_assert(TB % 4 == 0, "vectors are moved as float4");
static_assert(THREADS % 32 == 0, "columns a thread lie in whole warps");

__device__ __forceinline__ bool bit(unsigned m, int b) {
  return (m >> b) & 1u;
}

// Thread threadIdx.x's column of half h of a width P, or -1 where it has
// none (the same in its whole warp).
__device__ __forceinline__ int col(int h, int P) {
  const int j = static_cast<int>(threadIdx.x) + h * THREADS;
  return j < P ? j : -1;
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

__device__ __forceinline__ void zero(float (&v)[TB]) {
#pragma unroll
  for (int b = 0; b < TB; ++b) v[b] = 0.0f;
}

// m[b] = max(m[b], |x[b]|).
__device__ __forceinline__ void max_abs(float (&m)[TB], const float (&x)[TB]) {
#pragma unroll
  for (int b = 0; b < TB; ++b) m[b] = fmaxf(m[b], fabsf(x[b]));
}

// The maxima of v[b] over the warp, written to red[warp][slot][b] (NS slots
// a warp) by the warp's first thread. Every thread of the block calls it.
template <int NS>
__device__ __forceinline__ void warp_max(float (&v)[TB], float* red,
                                         int slot) {
#pragma unroll
  for (int b = 0; b < TB; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[b] = fmaxf(v[b], __shfl_xor_sync(FULL, v[b], off));
  }
  const int t = threadIdx.x;
  if ((t & 31) == 0) store(red + ((t >> 5) * NS + slot) * TB, v);
}

// rs[b] = the maxima over the block's warps of red[.][slot][b].
template <int NS>
__device__ __forceinline__ void block_max(const float* red, int slot,
                                          float (&rs)[TB]) {
  zero(rs);
  for (int w = 0; w < WARPS; ++w) {
    float m[TB];
    load(m, red + (w * NS + slot) * TB);
#pragma unroll
    for (int b = 0; b < TB; ++b) rs[b] = fmaxf(rs[b], m[b]);
  }
}

// acc[b] += sum_{i0 <= i < i1} x[i][b] m[i][j]: x in shared memory as
// [rows][TB], m row-major with leading dimension ld, read from L2, UNROLL
// loads in flight; one fmaf chain in row order.
template <int UNROLL>
__device__ __forceinline__ void product(const float* x,
                                        const float* __restrict__ m, int ld,
                                        int i0, int i1, int j,
                                        float (&acc)[TB]) {
  const float* colp = m + j;
#pragma unroll UNROLL
  for (int i = i0; i < i1; ++i) {
    const float w = __ldg(colp + static_cast<size_t>(i) * ld);
    const float4* x4 = reinterpret_cast<const float4*>(x + i * TB);
#pragma unroll
    for (int q = 0; q < TB / 4; ++q) {
      const float4 d = x4[q];
      acc[4 * q] = fmaf(d.x, w, acc[4 * q]);
      acc[4 * q + 1] = fmaf(d.y, w, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(d.z, w, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(d.w, w, acc[4 * q + 3]);
    }
  }
}

// product above for two columns j0 and j1 of m in one pass over the rows:
// each row of x is read once for both, and the two chains' loads are in
// flight together. Each chain is still one fmaf chain in row order, so the
// sums are product's.
template <int UNROLL>
__device__ __forceinline__ void product2(const float* x,
                                         const float* __restrict__ m, int ld,
                                         int i0, int i1, int j0, int j1,
                                         float (&a0)[TB], float (&a1)[TB]) {
  const float* c0 = m + j0;
  const float* c1 = m + j1;
#pragma unroll UNROLL
  for (int i = i0; i < i1; ++i) {
    const float w0 = __ldg(c0 + static_cast<size_t>(i) * ld);
    const float w1 = __ldg(c1 + static_cast<size_t>(i) * ld);
    const float4* x4 = reinterpret_cast<const float4*>(x + i * TB);
#pragma unroll
    for (int q = 0; q < TB / 4; ++q) {
      const float4 d = x4[q];
      a0[4 * q] = fmaf(d.x, w0, a0[4 * q]);
      a0[4 * q + 1] = fmaf(d.y, w0, a0[4 * q + 1]);
      a0[4 * q + 2] = fmaf(d.z, w0, a0[4 * q + 2]);
      a0[4 * q + 3] = fmaf(d.w, w0, a0[4 * q + 3]);
      a1[4 * q] = fmaf(d.x, w1, a1[4 * q]);
      a1[4 * q + 1] = fmaf(d.y, w1, a1[4 * q + 1]);
      a1[4 * q + 2] = fmaf(d.z, w1, a1[4 * q + 2]);
      a1[4 * q + 3] = fmaf(d.w, w1, a1[4 * q + 3]);
    }
  }
}

// acc[h] += the product over rows [i0, i1) for each of the thread's
// columns of width P, both in one pass where it owns two (the same in its
// whole warp).
template <int UNROLL>
__device__ __forceinline__ void product_cols(const float* x,
                                             const float* __restrict__ m,
                                             int ld, int i0, int i1, int P,
                                             float (&acc)[CPT][TB]) {
  const int j0 = col(0, P), j1 = col(1, P);
  if (j1 >= 0)
    product2<UNROLL>(x, m, ld, i0, i1, j0, j1, acc[0], acc[1]);
  else if (j0 >= 0)
    product<UNROLL>(x, m, ld, i0, i1, j0, acc[0]);
}

// Projection onto {||(y1, y2)|| <= a (y0 - dd)}, a in {-1, +1}, in the JAX
// kernel's _proj_ssoc_seg blended form: the cones of K6 and K7, as their
// narrow builds project them.
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

// The block's leaf l (of nleaf, `rows` rows each) in the global state
// scratch [blocks][nleaf][rows][TB]; row j of it is thread j's own.
__device__ __forceinline__ float* leaf(float* st, int nleaf, int l,
                                       int rows) {
  return st + (static_cast<size_t>(blockIdx.x) * nleaf + l) * rows * TB;
}

// Copy row j of a leaf and entry `at` of each lane's exact-k snapshot
// (width W floats a lane) for the lanes in `lanes`. TO_GLOBAL: leaf ->
// snapshot.
template <bool TO_GLOBAL>
__device__ __forceinline__ void snap_row(float* leaf_, float* snap, int W,
                                         int at, int j, int lane0,
                                         unsigned lanes) {
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    if (!bit(lanes, b)) continue;
    float* g = snap + static_cast<size_t>(lane0 + b) * W + at;
    float* s = leaf_ + j * TB + b;
    if (TO_GLOBAL)
      *g = *s;
    else
      *s = *g;
  }
}

// Row j of a leaf from / to a [B][ld] tensor (the lanes of the block).
__device__ __forceinline__ void read_row(float* leaf_, const float* src,
                                         int ld, int j, int lane0) {
  float v[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b)
    v[b] = src ? src[static_cast<size_t>(lane0 + b) * ld + j] : 0.0f;
  store(leaf_ + j * TB, v);
}

__device__ __forceinline__ void write_row(const float* leaf_, float* dst,
                                          int ld, int j, int lane0) {
  float v[TB];
  load(v, leaf_ + j * TB);
#pragma unroll
  for (int b = 0; b < TB; ++b)
    dst[static_cast<size_t>(lane0 + b) * ld + j] = v[b];
}

// ---- one product an iteration: K4, K5, K7 ---------------------------------
//
// The iteration of K4 (csrc/fused_ellip.cu), K5 (csrc/fused_soc.cu) and K7
// (csrc/fused_split.cu): an element-wise half that reads the prepared
// iterate X and two leaves A, B of a column and writes A, B and the delta
// dq; a barrier; then X += dq @ M over up to two ranges of rows, and XC,
// the iterate consumed, keeps X's value before. The kernel's Op gives the
// element-wise half:
//   template <bool CHECK> void ew(const Box&, int h, int j, unsigned frozen,
//       float* dq, float (&ap)[TB], float (&ad)[TB])
// for column j, the thread's column of half h: it stores dq's row j, writes A and B of the lanes not in
// `frozen`, and with CHECK takes the column's |r_p| and |r_d| into ap, ad
// (max_abs). The modes are the first layout's (checked, plain free-run,
// exact-k with window snapshots and a budgeted replay, and fixed_iters).

enum { BX = 0, BA = 1, BB = 2, BXC = 3 };  // the leaves; the first three
constexpr int BOX_LEAVES = 4, BOX_SNAP = 3;  // are the snapshot's, in order

struct Box {
  float* dq;   // shared: [2][P][TB], by iteration parity
  float* red;  // shared: [2][WARPS][2][TB]
  float* st;   // global: [blocks][BOX_LEAVES][P][TB]
  const float* __restrict__ m;  // [P][P] row-major: X += dq @ m
  const float* in[3];           // [B][P]: X's, A's and B's start
  float* out[3];                // [B][P]: X (or XC), A, B at exit
  int* k;
  int* done;
  float* rp;
  float* rd;
  float* snap;  // exact-k: per lane [X | A | B]
  int P;
  int r0, r1, r2, r3;  // the product's rows: [r0, r1) then [r2, r3)
  float tol_p, tol_d;
  int k_max, check_every, fixed_iters, exact_k;
};

__device__ __forceinline__ float* box_leaf(const Box& x, int l) {
  return leaf(x.st, BOX_LEAVES, l, x.P);
}

// Dynamic shared bytes of a block of the one-product wide build.
inline long box_smem(int P) { return 4L * TB * (2L * P + 4L * WARPS); }

template <int UNROLL, bool CHECK, class Op>
__device__ __forceinline__ unsigned box_iterate(const Box& x, Op& op,
                                                int& parity, unsigned frozen,
                                                unsigned rmask,
                                                float (&lres)[2][TB]) {
  float* dq = x.dq + parity * x.P * TB;
  float* red = x.red + parity * WARPS * 2 * TB;
  float ap[TB], ad[TB];
  zero(ap);
  zero(ad);
#pragma unroll
  for (int h = 0; h < CPT; ++h) {
    const int j = col(h, x.P);
    if (j < 0) break;
    op.template ew<CHECK>(x, h, j, frozen, dq, ap, ad);
  }
  if (CHECK) {
    warp_max<2>(ap, red, 0);
    warp_max<2>(ad, red, 1);
  }
  __syncthreads();
  float* X = box_leaf(x, BX);
  float* XC = box_leaf(x, BXC);
  float acc[CPT][TB];
  zero(acc[0]);
  zero(acc[1]);
  product_cols<UNROLL>(dq, x.m, x.P, x.r0, x.r1, x.P, acc);
  product_cols<UNROLL>(dq, x.m, x.P, x.r2, x.r3, x.P, acc);
#pragma unroll
  for (int h = 0; h < CPT; ++h) {
    const int j = col(h, x.P);
    if (j < 0) break;
    float xv[TB], xc[TB];
    load(xv, X + j * TB);
    load(xc, XC + j * TB);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (!bit(frozen, b)) {
        xc[b] = xv[b];
        xv[b] = xv[b] + acc[h][b];
      }
    }
    store(X + j * TB, xv);
    store(XC + j * TB, xc);
  }
  parity ^= 1;
  unsigned conv = 0;
  if (CHECK) {
    float rs[2][TB];
    block_max<2>(red, 0, rs[0]);
    block_max<2>(red, 1, rs[1]);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (rs[0][b] <= x.tol_p && rs[1][b] <= x.tol_d) conv |= 1u << b;
      if (threadIdx.x == 0 && bit(rmask, b)) {
        lres[0][b] = rs[0][b];
        lres[1][b] = rs[1][b];
      }
    }
  }
  return conv;
}

// The snapshot leaves X, A, B of the thread's columns to (TO_GLOBAL) or from
// each lane's [X | A | B] in x.snap, for the lanes in `lanes`.
template <bool TO_GLOBAL>
__device__ __forceinline__ void box_snapshot(const Box& x, int lane0,
                                             unsigned lanes) {
#pragma unroll
  for (int h = 0; h < CPT; ++h) {
    const int j = col(h, x.P);
    if (j < 0) break;
#pragma unroll
    for (int l = 0; l < BOX_SNAP; ++l)
      snap_row<TO_GLOBAL>(box_leaf(x, l), x.snap, BOX_SNAP * x.P,
                          l * x.P + j, j, lane0, lanes);
  }
}

// A block's whole loop: the state in, the modes, the state and each lane's
// k, exit flag and residuals out. Every thread of the block calls it, after
// the Op has read what it needs.
template <int UNROLL, class Op>
__device__ __forceinline__ void box_run(const Box& x, Op& op) {
  __shared__ int sn_k[TB];       // exact-k: each lane's window start
  __shared__ float lres[2][TB];  // thread 0's residuals of each lane
  const int lane0 = blockIdx.x * TB;
  const int P = x.P;
#pragma unroll
  for (int h = 0; h < CPT; ++h) {
    const int j = col(h, P);
    if (j < 0) break;
    read_row(box_leaf(x, BX), x.in[0], P, j, lane0);
    read_row(box_leaf(x, BXC), x.in[0], P, j, lane0);
    read_row(box_leaf(x, BA), x.in[1], P, j, lane0);
    read_row(box_leaf(x, BB), x.in[2], P, j, lane0);
  }
  if (threadIdx.x == 0) {
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
  const int C = x.check_every;
  int xout = BXC;  // the leaf written out as X: the consumed one ...

  if (x.fixed_iters > 0) {
    // exactly fixed_iters plain iterations, no exit tests
    for (int it = 0; it < x.fixed_iters; ++it)
      box_iterate<UNROLL, false>(x, op, parity, 0u, 0u, lres);
#pragma unroll
    for (int b = 0; b < TB; ++b) k[b] = x.fixed_iters;
    done = ALL;
    xout = BX;  // ... but the prepared one here and in free-run
  } else if (C > 1 && x.exact_k) {
    // free-run windows of C iterations; snapshot every still-active lane
    // at each window start, so the window a lane converges in can be
    // replayed with per-iteration checks once the block has drained.
    // Windows may overshoot k_max: the replay budget cuts each lane off at
    // exactly k_max.
    for (int it = 0; it < x.k_max && done != ALL; it += C) {
      box_snapshot<true>(x, lane0, ~done & ALL);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int b = 0; b < TB; ++b)
          if (!bit(done, b)) sn_k[b] = it;
      }
      for (int f = 0; f < C - 1; ++f)
        box_iterate<UNROLL, false>(x, op, parity, 0u, 0u, lres);
      done |= box_iterate<UNROLL, true>(x, op, parity, 0u, 0u, lres);
    }
    __syncthreads();  // the window starts, written by thread 0
    // replay each lane's last window from its snapshot with per-iteration
    // checks: k counts on from the window start
    box_snapshot<false>(x, lane0, ALL);
#pragma unroll
    for (int h = 0; h < CPT; ++h) {
      const int j = col(h, P);
      if (j < 0) break;
      float v[TB];
      load(v, box_leaf(x, BX) + j * TB);
      store(box_leaf(x, BXC) + j * TB, v);
    }
    int budget[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      k[b] = sn_k[b];
      budget[b] = min(C, x.k_max - k[b]);
    }
    unsigned convd = 0;
    for (int w = 0; w < C; ++w) {
      unsigned frozen = convd;
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (w >= budget[b]) frozen |= 1u << b;
      if (frozen == ALL) break;
      const unsigned conv = box_iterate<UNROLL, true>(
          x, op, parity, frozen, ~frozen & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(frozen, b)) ++k[b];
      convd |= conv & ~frozen;
    }
    done = convd;
  } else if (C > 1) {
    // free-run: C-1 plain iterations, then one checked iteration; every
    // lane keeps iterating until the block's lanes (one group of 8) are
    // all done, k is recorded at check granularity, and a done lane's
    // residuals stay at its exit
    for (int it = 0; it < x.k_max && done != ALL;) {
      const int n_fast = min(C - 1, x.k_max - 1 - it);
      for (int f = 0; f < n_fast; ++f)
        box_iterate<UNROLL, false>(x, op, parity, 0u, 0u, lres);
      const unsigned conv = box_iterate<UNROLL, true>(x, op, parity, 0u,
                                                       ~done & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(done, b)) k[b] += n_fast + 1;
      done |= conv;
      it += n_fast + 1;
    }
    xout = BX;
  } else {
    // checked: exit tests every iteration; a converged lane freezes and
    // keeps the iterate it consumed at exit
    for (int it = 0; it < x.k_max && done != ALL; ++it) {
      const unsigned conv = box_iterate<UNROLL, true>(x, op, parity, done,
                                                       ~done & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(done, b)) ++k[b];
      done |= conv;
    }
  }
  __syncthreads();  // thread 0's residuals of the last iteration
#pragma unroll
  for (int h = 0; h < CPT; ++h) {
    const int j = col(h, P);
    if (j < 0) break;
    write_row(box_leaf(x, xout), x.out[0], P, j, lane0);
    write_row(box_leaf(x, BA), x.out[1], P, j, lane0);
    write_row(box_leaf(x, BB), x.out[2], P, j, lane0);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      x.k[lane0 + b] = k[b];
      x.done[lane0 + b] = bit(done, b) ? 1 : 0;
      x.rp[lane0 + b] = lres[0][b];
      x.rd[lane0 + b] = lres[1][b];
    }
  }
}

}  // namespace wc
