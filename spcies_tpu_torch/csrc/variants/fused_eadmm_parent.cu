// Fused three-block EADMM for MPCT on NVIDIA Hopper (sm_90a), written by
// hand.
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
// PyTorch version of every mode are in kernels/fused_eadmm.py.
//
// Layout. One thread block per TB = 8 lanes; one thread per column j of the
// padded width Z (a multiple of 32, at most 512). Thread j owns column j of
// the nine state vectors z1, z2b, z3, lm, lht, the previous product inputs
// v2m_p, v2t_p, q3_p, and x0b for the block's TB lanes, in shared memory
// that only thread j touches. Every element-wise step is column-local; only
// the two products need a lane's whole input row. So an iteration is
//   1. thread j forms z1, v2m, v2t and the deltas dv2m, dv2t of its column
//      and stores the deltas as [Z][TB];                      __syncthreads
//   2. z2bn = z2acc + dv2m @ C2m + dv2t @ C2t, q3 and dq3 (stored as
//      [Z][TB]); the row maxima of |dz2| go through warp shuffles, then
//      shared memory across warps;                            __syncthreads
//   3. z3n = z3acc + dq3 @ M3p, the residual rows, the dual ascent, the row
//      maxima of r_pf and r_z3;                               __syncthreads
//   4. every thread reads the maxima and finds the converged lanes.
// Each product reads row i of its matrix at column j (the 32 threads of a
// warp read 32 consecutive floats) and its input as broadcast reads of
// shared memory. Loop control is uniform across a block because every
// thread reads the same maxima.
//
// Carried state. After the first iteration the accumulators equal z2b and
// z3 on every lane, frozen lanes included (the JAX kernel sets both from
// the same values), so the kernel carries seven leaves and marks the lanes
// whose next iteration is their first ("fresh"): those take z2refb (read
// from the input) and 0 as accumulators. The plain version keeps all nine
// leaves, op for op.
//
// Rows. v2t is exactly 0 outside the tail block (it is masked by mt), and
// the rows of C2m and M3p beyond the last real lane are 0 (the padding
// contract), so the products read only the rows t0..t1 of C2t where mt is
// nonzero and the rows below nr, one past the last lane where mr is
// nonzero, of C2m and M3p: adding zero terms changes no sum. Each block
// finds the three bounds from mt and mr before its loop.
//
// Exact-k snapshots. At each window start the seven leaves of every lane
// not yet done go to global scratch (each thread writes, and later reads
// back, only its own columns), and the window start to shared memory. The
// replay runs each lane's last window with the checked semantics and the
// budget min(C, k_max - kws), as K1 and K2 do.
//
// Bound. Every block re-reads C2m, M3p (nr x Z each) and the tail rows of
// C2t from L2 on every iteration: 504 KiB at the N=30 shapes (nr = 248,
// Z = 256, 8 tail rows), for 2 TB FLOP per 4 bytes read. They stay in the
// 50 MB L2 and do not fit a block's 227 KB of shared memory. The product
// loops are unrolled 8 deep to keep 8 L2 loads in flight per thread: on an
// NVIDIA H100 (700 W) unrolled 16 the kernel spilled 60 bytes and ran
// 1.5-2.4 % slower, unrolled 32 it spilled 104 bytes and ran 15 % slower
// (PERF.md, K3). Folding C2m into its rank-(n+m) factors (block sum, W2,
// broadcast) would read 32x fewer bytes for the z2 product but sums in
// another order than the plain version; it is left for later work, with
// wgmma/TMA staging.
//
// Arithmetic. fp32 on the CUDA cores, no TF32. The library is built with
// -fmad=false, so the element-wise steps round as PyTorch's separate
// operations do; the products use explicit fmaf. Only the order of the
// products' sums differs from a cuBLAS or CPU matmul.
//
// Padding. Pad columns carry zero rows and columns of C2m, C2t and M3p,
// zero rm, rht, mh, mt, mr and h1i and [0, 0] bounds, so they stay exactly
// 0 and add nothing to the row maxima.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 8;          // lanes per block (CTA_LANES in the wrapper)
constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr int NSNAP = 7;       // snapshot leaves (SNAP_LEAVES in the wrapper)
constexpr float RBIG = 3.4e38f;
constexpr unsigned ALL = (1u << TB) - 1u;
static_assert(TB % 4 == 0, "vectors are moved as float4");

struct Params {
  const float* __restrict__ x0b;
  const float* __restrict__ z2refb;
  const float* __restrict__ z2b0;
  const float* __restrict__ z30;
  const float* __restrict__ lm0;
  const float* __restrict__ lht0;
  const float* __restrict__ c2m;  // [Z][Z], dv2m @ c2m
  const float* __restrict__ c2t;  // [Z][Z], dv2t @ c2t
  const float* __restrict__ m3p;  // [Z][Z], dq3 @ m3p
  const float* __restrict__ rows[8];  // rm, rht, mh, mt, mr, h1i, lb, ub
  float* out[5];                      // z1, z2b, z3, lm, lht
  int* k;
  int* done;
  float* res[3];                      // r_pf, r_z2, r_z3
  float* snap;  // exact-k: per lane [z2b | z3 | lm | lht | v2m | v2t | q3]
  int Z;
  float tol;
  int k_max, check_every, exact_k;
};

// Shared memory. The product inputs are read by every thread; the state
// columns are each read and written by their own thread only.
struct Shared {
  float* d2m;  // [Z][TB]  product inputs
  float* d2t;
  float* dq3;
  float* st[9];  // [Z][TB] state: z2b, z3, lm, lht, v2m, v2t, q3, z1, x0
  float* red;    // [Z / 32][3][TB] warp maxima of r_pf, r_z2, r_z3
};
// indices into Shared::st; the first NSNAP are the snapshot leaves
enum { Z2B, Z3, LM, LHT, V2M, V2T, Q3, Z1, X0 };

struct Col {
  int j, lane0, Z;
  int nr, t0, t1;  // the rows the products read (see Rows above)
  float rm, rht, mh, mt, mr, sg, h1i, lb, ub;
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

// acc[b] = sum_{i0 <= i < i1} v[i][b] m[i][j]: v in shared memory as
// [rows][TB], m row-major with leading dimension ld, read from L2.
__device__ __forceinline__ void product(const float* v,
                                        const float* __restrict__ m, int ld,
                                        int i0, int i1, int j,
                                        float (&acc)[TB]) {
#pragma unroll
  for (int b = 0; b < TB; ++b) acc[b] = 0.0f;
  const float* col = m + j;
#pragma unroll 8
  for (int i = i0; i < i1; ++i) {
    const float w = __ldg(col + static_cast<size_t>(i) * ld);
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

// The maxima of v[b] over the warp, written to red[warp][slot][b] by the
// warp's first thread.
__device__ __forceinline__ void warp_max(float (&v)[TB], float* red, int j,
                                         int slot) {
#pragma unroll
  for (int b = 0; b < TB; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[b] = fmaxf(v[b], __shfl_xor_sync(0xffffffffu, v[b], off));
  }
  if ((j & 31) == 0) store(red + ((j >> 5) * 3 + slot) * TB, v);
}

// One iteration of column j for the block's TB lanes. Lanes in `frozen`
// keep all their state; lanes in `fresh` take z2refb and 0 as the
// accumulators (their first iteration). Thread 0 records the residuals of
// the lanes in `rmask` in lres. Returns the lanes whose three residuals
// meet tol (identical in every thread of the block).
__device__ __forceinline__ unsigned iterate(const Params& p, const Shared& s,
                                            const Col& c, unsigned frozen,
                                            unsigned fresh, unsigned rmask,
                                            float (&lres)[3][TB]) {
  const int o = c.j * TB;  // this thread's column in every buffer
  float z1[TB], z2n[TB];
  // 1. P1: z1 = clip(-q1 h1i); the deltas of the z2 product's inputs
  {
    float z2b[TB], z3[TB], lm[TB], lht[TB], x0[TB], vm[TB], vt[TB];
    float dm[TB], dt[TB], z1s[TB];
    load(z2b, s.st[Z2B] + o);
    load(z3, s.st[Z3] + o);
    load(lm, s.st[LM] + o);
    load(lht, s.st[LHT] + o);
    load(x0, s.st[X0] + o);
    load(vm, s.st[V2M] + o);
    load(vt, s.st[V2T] + o);
    load(z1s, s.st[Z1] + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float s_ht = c.rht * (c.mt * z2b[b] - x0[b]) + lht[b];
      const float q1 = -(c.rm * (z2b[b] + z3[b]) + lm[b]) + c.sg * s_ht;
      z1[b] = fminf(fmaxf(-q1 * c.h1i, c.lb), c.ub);
      const float v2m = c.rm * (z3[b] - z1[b]) + lm[b];
      const float v2t = c.mt * (c.rht * (-z1[b]) + lht[b]);
      dm[b] = v2m - vm[b];
      dt[b] = v2t - vt[b];
      if (!bit(frozen, b)) {
        vm[b] = v2m;
        vt[b] = v2t;
        z1s[b] = z1[b];
      }
    }
    store(s.d2m + o, dm);
    store(s.d2t + o, dt);
    store(s.st[V2M] + o, vm);
    store(s.st[V2T] + o, vt);
    store(s.st[Z1] + o, z1s);
  }
  __syncthreads();
  // 2. P2: z2bn = z2acc + dv2m @ C2m + dv2t @ C2t; q3 and its delta
  {
    float a1[TB], a2[TB], z2b[TB], lm[TB], q3p[TB], dq[TB], az[TB];
    product(s.d2m, p.c2m, c.Z, 0, c.nr, c.j, a1);
    product(s.d2t, p.c2t, c.Z, c.t0, c.t1, c.j, a2);
    load(z2b, s.st[Z2B] + o);
    load(lm, s.st[LM] + o);
    load(q3p, s.st[Q3] + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float acc =
          bit(fresh, b)
              ? __ldg(p.z2refb + static_cast<size_t>(c.lane0 + b) * c.Z + c.j)
              : z2b[b];
      z2n[b] = (acc + a1[b]) + a2[b];
      const float q3 = c.rm * (z2n[b] - z1[b]) + lm[b];
      dq[b] = q3 - q3p[b];
      az[b] = fabsf((z2n[b] - z2b[b]) * c.mr);
      if (!bit(frozen, b)) {
        q3p[b] = q3;
        z2b[b] = z2n[b];
      }
    }
    store(s.dq3 + o, dq);
    store(s.st[Q3] + o, q3p);
    store(s.st[Z2B] + o, z2b);
    warp_max(az, s.red, c.j, 1);
  }
  __syncthreads();
  // 3. P3: z3n = z3acc + dq3 @ M3p; residual rows and dual ascent
  {
    float a3[TB], z3[TB], lm[TB], lht[TB], x0[TB], pf[TB], az[TB];
    product(s.dq3, p.m3p, c.Z, 0, c.nr, c.j, a3);
    load(z3, s.st[Z3] + o);
    load(lm, s.st[LM] + o);
    load(lht, s.st[LHT] + o);
    load(x0, s.st[X0] + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float acc = bit(fresh, b) ? 0.0f : z3[b];
      const float z3n = acc + a3[b];
      const float midR = z2n[b] + z3n - z1[b];
      const float htR = c.mh * z1[b] - x0[b] + c.mt * (z2n[b] - z1[b]);
      pf[b] = fmaxf(fabsf(midR * c.mr), fabsf(htR));
      az[b] = fabsf((z3n - z3[b]) * c.mr);
      if (!bit(frozen, b)) {
        z3[b] = z3n;
        lm[b] = lm[b] + c.rm * midR;
        lht[b] = lht[b] + c.rht * htR;
      }
    }
    store(s.st[Z3] + o, z3);
    store(s.st[LM] + o, lm);
    store(s.st[LHT] + o, lht);
    warp_max(pf, s.red, c.j, 0);
    warp_max(az, s.red, c.j, 2);
  }
  __syncthreads();
  // 4. the residuals of each lane, and the lanes that meet tol
  float rs[3][TB];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int b = 0; b < TB; ++b) rs[q][b] = 0.0f;
  for (int w = 0; w < (c.Z >> 5); ++w) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float m[TB];
      load(m, s.red + (w * 3 + q) * TB);
#pragma unroll
      for (int b = 0; b < TB; ++b) rs[q][b] = fmaxf(rs[q][b], m[b]);
    }
  }
  unsigned conv = 0;
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    if (rs[0][b] <= p.tol && rs[1][b] <= p.tol && rs[2][b] <= p.tol)
      conv |= 1u << b;
    if (c.j == 0 && bit(rmask, b)) {
#pragma unroll
      for (int q = 0; q < 3; ++q) lres[q][b] = rs[q][b];
    }
  }
  return conv;
}

// Copy this thread's columns of the seven snapshot leaves between shared
// memory and the per-lane [z2b | z3 | lm | lht | v2m | v2t | q3] layout in
// global memory, for the lanes in `lanes`. TO_GLOBAL selects the direction.
template <bool TO_GLOBAL>
__device__ __forceinline__ void snapshot(const Shared& s, const Col& c,
                                         float* snap, unsigned lanes) {
  const int W = NSNAP * c.Z;
#pragma unroll
  for (int l = 0; l < NSNAP; ++l) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (!bit(lanes, b)) continue;
      float* g = snap + static_cast<size_t>(c.lane0 + b) * W + l * c.Z + c.j;
      float* sh = s.st[l] + c.j * TB + b;
      if (TO_GLOBAL)
        *g = *sh;
      else
        *sh = *g;
    }
  }
}

__global__ void __launch_bounds__(MAX_COLS) fused_eadmm_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sn_k[TB];       // exact-k: each lane's window start
  __shared__ float lres[3][TB];  // thread 0's residuals of each lane
  __shared__ int bounds[3];      // nr, t0, t1
  const int Z = p.Z;
  const int j = threadIdx.x;
  Shared s;
  {
    float* a = smem;
    float** bufs[3] = {&s.d2m, &s.d2t, &s.dq3};
    for (int l = 0; l < 3; ++l, a += Z * TB) *bufs[l] = a;
    for (int l = 0; l < 9; ++l, a += Z * TB) s.st[l] = a;
    s.red = a;
  }
  Col c;
  c.j = j;
  c.Z = Z;
  c.lane0 = blockIdx.x * TB;
  c.rm = p.rows[0][j];
  c.rht = p.rows[1][j];
  c.mh = p.rows[2][j];
  c.mt = p.rows[3][j];
  c.mr = p.rows[4][j];
  c.sg = c.mh - c.mt;
  c.h1i = p.rows[5][j];
  c.lb = p.rows[6][j];
  c.ub = p.rows[7][j];
  const int o = j * TB;
  if (j == 0) {
    bounds[0] = 0;
    bounds[1] = Z;
    bounds[2] = 0;
  }
  __syncthreads();
  if (c.mr != 0.0f) atomicMax(&bounds[0], j + 1);
  if (c.mt != 0.0f) {
    atomicMin(&bounds[1], j);
    atomicMax(&bounds[2], j + 1);
  }
  __syncthreads();
  c.nr = bounds[0];
  c.t0 = bounds[1];
  c.t1 = bounds[2];

  {
    // state: z2b0, z30, lm0, lht0, zero previous inputs, zero z1, x0b
    const float* src[9] = {p.z2b0, p.z30,   p.lm0,   p.lht0, nullptr,
                           nullptr, nullptr, nullptr, p.x0b};
#pragma unroll
    for (int l = 0; l < 9; ++l) {
      float v[TB];
#pragma unroll
      for (int b = 0; b < TB; ++b)
        v[b] = src[l] ? src[l][static_cast<size_t>(c.lane0 + b) * Z + j]
                      : 0.0f;
      store(s.st[l] + o, v);
    }
  }
  if (j == 0) {
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int q = 0; q < 3; ++q) lres[q][b] = RBIG;
  }
  unsigned done = 0;
  int k[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) k[b] = 0;
  const int C = p.check_every;

  if (C > 1 && p.exact_k) {
    // free-run windows of C iterations; snapshot every still-active lane
    // at each window start; a lane is done once the window's last
    // iteration meets tol. Windows may overshoot k_max: the replay budget
    // cuts each lane off at exactly k_max.
    for (int it = 0; it < p.k_max && done != ALL; it += C) {
      snapshot<true>(s, c, p.snap, ~done & ALL);
      if (j == 0) {
#pragma unroll
        for (int b = 0; b < TB; ++b)
          if (!bit(done, b)) sn_k[b] = it;
      }
      for (int f = 0; f < C - 1; ++f)
        iterate(p, s, c, 0u, (it == 0 && f == 0) ? ALL : 0u, 0u, lres);
      done |= iterate(p, s, c, 0u, 0u, 0u, lres);
    }
    __syncthreads();  // the window starts, written by thread 0
    // replay each lane's last window from its snapshot with per-iteration
    // checks: k counts on from the window start
    snapshot<false>(s, c, p.snap, ALL);
    {
      const float zero[TB] = {};
      store(s.st[Z1] + o, zero);
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
      const unsigned conv = iterate(p, s, c, frozen, w == 0 ? first : 0u,
                                    ~frozen & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(frozen, b)) ++k[b];
      convd |= conv & ~frozen;
    }
    done = convd;
  } else if (C > 1) {
    // free-run: C-1 plain iterations, then one tested iteration; every
    // lane keeps iterating until the block's lanes are all done, k is
    // recorded at check granularity, and a done lane's residuals stay at
    // its exit
    for (int it = 0; it < p.k_max && done != ALL;) {
      const int n_fast = min(C - 1, p.k_max - 1 - it);
      for (int f = 0; f < n_fast; ++f)
        iterate(p, s, c, 0u, (it == 0 && f == 0) ? ALL : 0u, 0u, lres);
      const unsigned conv = iterate(p, s, c, 0u,
                                    (it == 0 && n_fast == 0) ? ALL : 0u,
                                    ~done & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(done, b)) k[b] += n_fast + 1;
      done |= conv;
      it += n_fast + 1;
    }
  } else {
    // checked: exit tests every iteration; a converged lane freezes
    for (int it = 0; it < p.k_max && done != ALL; ++it) {
      const unsigned conv = iterate(p, s, c, done, it == 0 ? ALL : 0u,
                                    ~done & ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!bit(done, b)) ++k[b];
      done |= conv;
    }
  }

  {
    const int leaves[5] = {Z1, Z2B, Z3, LM, LHT};
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      float v[TB];
      load(v, s.st[leaves[l]] + o);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        p.out[l][static_cast<size_t>(c.lane0 + b) * Z + j] = v[b];
    }
  }
  if (j == 0) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      p.k[c.lane0 + b] = k[b];
      p.done[c.lane0 + b] = bit(done, b) ? 1 : 0;
#pragma unroll
      for (int q = 0; q < 3; ++q) p.res[q][c.lane0 + b] = lres[q][b];
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t). The geometry comes from the wrapper
// (kernels/fused_eadmm.py launch_geometry) and is checked here again.
// Returns the CUDA error of the launch, as an int.
extern "C" int fused_eadmm_launch(
    const float* x0b, const float* z2refb, const float* z2b0,
    const float* z30, const float* lm0, const float* lht0, const float* c2m,
    const float* c2t, const float* m3p, const float* rm, const float* rht,
    const float* mh, const float* mt, const float* mr, const float* h1i,
    const float* lb, const float* ub, float* z1, float* z2b, float* z3,
    float* lm, float* lht, int* k, int* done, float* rpf, float* rz2,
    float* rz3, float* snap, int B, int Z, int blocks, int threads,
    int smem, float tol, int k_max, int check_every, int exact_k,
    void* stream) {
  const long need = 4L * TB * (12L * Z + 3L * (Z / 32));
  const bool exact = check_every > 1 && exact_k;
  if (Z <= 0 || Z % 32 != 0 || Z > MAX_COLS || B % TB != 0 ||
      blocks != B / TB || threads != Z || smem != need || check_every < 1 ||
      k_max < 1 || (exact && B > 0 && snap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_eadmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Params p{x0b, z2refb, z2b0, z30, lm0, lht0, c2m, c2t, m3p,
           {rm, rht, mh, mt, mr, h1i, lb, ub},
           {z1, z2b, z3, lm, lht}, k, done, {rpf, rz2, rz3}, snap,
           Z, tol, k_max, check_every, exact_k};
  fused_eadmm_kernel<<<blocks, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
