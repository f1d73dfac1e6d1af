// The wide builds of K2 and K3 on NVIDIA Hopper (sm_90a), written by hand:
// what csrc/fused_fista.cu (K2) and csrc/fused_eadmm.cu (K3) share in the
// kernels they run past 512 padded columns, up to COLS = 1024. (K1's and
// K4-K7's wide builds run on engines of the product stage,
// csrc/fused_admm.cu and csrc/tile_product.cuh.)
//
// Layout. A block holds TB = 8 lanes on THREADS = 512 threads, and thread
// t owns columns t and t + THREADS of each width (CPT = 2 columns a
// thread): the first layout of the kernels (one column a thread, 8 lanes
// a block, the matrices read from L2; csrc/variants/fused_*_parent.cu)
// with each thread taking two columns. The per-column code is the first
// layout's, so each (lane, column) sum is the same fmaf chain over the
// same rows in the same order: a wide build gives the bits of the first
// layout, which are the narrow builds' bits. Threads past a width own no
// column there (a wide build also runs at the narrow widths, for a check
// of bits).
//
// Columns a thread owns lie in whole warps: a warp's 32 threads own the 32
// columns [32 w, 32 w + 32) in the first half and [512 + 32 w, ...) in the
// second, so whether a thread owns a column of a half is the same in its
// whole warp (every width is whole warps).
//
// State. Only what crosses threads lives in shared memory: the products'
// inputs as [rows][TB] and the warps' row maxima. Each lane's state for a
// thread's own columns lives in global memory that only that thread
// touches, as [block][leaf][P][TB] (`leaf` below): at 1024 columns the
// narrow builds' state as [P][lanes] in shared memory no longer fits
// beside the rest.
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

}  // namespace wc
