// Fused delta-form box-ADMM on NVIDIA Hopper (sm_90a), written by hand: the
// one-column-per-thread kernel that csrc/fused_admm.cu took the place of,
// kept unchanged as the variant tools/ab_kernels.py times that kernel
// against and holds it to bit for bit. kernels/fused_admm.py does not launch
// it.
//
// Replaces the Pallas TPU kernel
// spcies_tpu/kernels/fused_admm.py::_fused_admm_kernel. It computes what
// that kernel computes, mode for mode (checked, free-run, exact-k with
// window replay, fixed_iters; over-relaxation; bf16 delta products): for
// every lane of the batch, the whole ADMM loop
//
//     zr     = alpha z + (1 - alpha) v_prev          (z when alpha == 1)
//     v      = clip(zr + rho_i lam, LB, UB)
//     lam   += rho (zr - v)
//     r_p    = max_j |z - v|,  r_d = max_j |v - v_prev|
//     dq     = rho (zr - 2 v + v_prev)
//     z_next = z + dq @ M                           (M = M_q^T, padded)
//
// until the lane meets tol or k_max. The wrapper and the plain PyTorch
// version of every mode are in kernels/fused_admm.py.
//
// Layout. One thread block per tile of TB lanes; one thread per column j of
// the padded decision vector (nzp threads: a multiple of 32, at most 512).
// Thread j keeps z_next, v and lam of column j for the block's TB lanes in
// registers (and, in exact-k mode, the three window snapshots). Per
// iteration:
//   1. thread j forms v, lam and dq of its column for the TB lanes;
//   2. it stores dq to shared memory as [nzp][TB]; in a checked iteration
//      the row maxima go through warp shuffles, then shared memory across
//      warps (both buffers double-buffered by iteration parity, so one
//      __syncthreads per iteration suffices);
//   3. thread j forms z_next[b][j] = z[b][j] + sum_i dq[b][i] M[i][j],
//      reading row i of M at column j (the 32 threads of a warp read 32
//      consecutive floats) and dq[.][i] as broadcast reads of shared memory.
// Blocks share nothing: the TPU's sequential grid carried nothing between
// tiles either. Loop control is uniform across a block because every
// thread reads the same row maxima.
//
// Bound. Every block re-reads all of M (nzp^2 * 4 bytes, 256 KiB at the
// N=30 headline where nzp = 256) from L2 on every iteration, for 2 TB FLOP
// per 4 bytes read: (B / TB) * k * nzp^2 * 4 bytes in all, about 1 GiB per
// iteration of a B = 32768 batch. That L2 traffic, not the FMAs, limits
// this first kernel. M (256 KiB) stays resident in the 50 MB L2, so none of
// it comes from HBM after the first touch. A larger TB divides the traffic
// but costs registers (exact-k carries 6 TB state values per thread).
// Holding M in shared memory (bf16, or split across a 2-block cluster),
// wgmma and TMA are left for later work.
//
// Arithmetic. fp32 FMAs on the CUDA cores, no TF32. The library is built
// with -fmad=false, so the element-wise steps round exactly as PyTorch's
// separate operations do; the product uses explicit fmaf. Only the order
// of the product's sum differs from a cuBLAS or CPU matmul.
//
// Padding. Pad columns carry zero rows and columns of M, [0, 0] bounds and
// zero state, so they stay exactly 0 and add nothing to the row maxima.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 8;          // lanes per block (CTA_LANES in the wrapper)
constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr float RBIG = 3.4e38f;
static_assert(TB % 4 == 0, "dq rows are moved as float4");

struct Params {
  const float* __restrict__ z1;
  const float* __restrict__ v0;
  const float* __restrict__ lam0;
  const float* __restrict__ mq;  // [nzp][nzp], row-major, dq @ mq
  const float* __restrict__ lb;
  const float* __restrict__ ub;
  float* z;
  float* v;
  float* lam;
  int* k;
  int* done;
  float* rp;
  float* rd;
  int nzp;
  float rho, rho_i, alpha, beta;  // beta = 1 - alpha, rounded on the host
  int relax;                      // alpha != 1
  float tol_p, tol_d;
  int k_max, check_every, fixed_iters, exact_k, bf16;
};

// Column j of the block's TB lanes.
struct Column {
  float z[TB];  // the prepared iterate z_next
  float v[TB];
  float lam[TB];
};

struct Scratch {
  float* dq;   // [2][nzp][TB]
  float* red;  // [2][warps][TB][2]
  int nzp, warps;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool all_of(const bool (&d)[TB]) {
  bool all = true;
#pragma unroll
  for (int b = 0; b < TB; ++b) all = all && d[b];
  return all;
}

// One iteration of column j for the block's TB lanes: reads st, writes the
// new z_next, v and lam into out. With CHECK, rpo/rdo receive each lane's
// residual row maxima (identical in every thread of the block).
template <bool CHECK>
__device__ __forceinline__ void iterate(const Params& p, const Scratch& s,
                                        int& parity, int j, float lbj,
                                        float ubj, const Column& st,
                                        Column& out, float (&rpo)[TB],
                                        float (&rdo)[TB]) {
  float* dq_s = s.dq + parity * s.nzp * TB;
  float* red = s.red + parity * s.warps * TB * 2;
  float dq[TB], ap[TB], ad[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    const float zc = st.z[b];
    const float vp = st.v[b];
    const float zr = p.relax ? p.alpha * zc + p.beta * vp : zc;
    const float y = zr + p.rho_i * st.lam[b];
    const float vn = fminf(fmaxf(y, lbj), ubj);
    out.lam[b] = st.lam[b] + p.rho * (zr - vn);
    out.v[b] = vn;
    const float d = p.rho * ((zr - 2.0f * vn) + vp);
    dq[b] = p.bf16 ? round_bf16(d) : d;
    if (CHECK) {
      ap[b] = fabsf(zc - vn);
      ad[b] = fabsf(vn - vp);
    }
  }
  float4* dst = reinterpret_cast<float4*>(dq_s + j * TB);
#pragma unroll
  for (int q = 0; q < TB / 4; ++q)
    dst[q] = make_float4(dq[4 * q], dq[4 * q + 1], dq[4 * q + 2],
                         dq[4 * q + 3]);
  if (CHECK) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ap[b] = fmaxf(ap[b], __shfl_xor_sync(0xffffffffu, ap[b], off));
        ad[b] = fmaxf(ad[b], __shfl_xor_sync(0xffffffffu, ad[b], off));
      }
    }
    if ((j & 31) == 0) {
      float* w = red + (j >> 5) * TB * 2;
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        w[2 * b] = ap[b];
        w[2 * b + 1] = ad[b];
      }
    }
  }
  __syncthreads();
  if (CHECK) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      rpo[b] = 0.0f;
      rdo[b] = 0.0f;
    }
    for (int w = 0; w < s.warps; ++w) {
      const float* r = red + w * TB * 2;
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        rpo[b] = fmaxf(rpo[b], r[2 * b]);
        rdo[b] = fmaxf(rdo[b], r[2 * b + 1]);
      }
    }
  }
  float acc[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) acc[b] = 0.0f;
  const float* col = p.mq + j;
  const int nzp = s.nzp;
#pragma unroll 4
  for (int i = 0; i < nzp; ++i) {
    float m = __ldg(col + i * nzp);
    if (p.bf16) m = round_bf16(m);
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
#pragma unroll
  for (int b = 0; b < TB; ++b) out.z[b] = st.z[b] + acc[b];
  parity ^= 1;
}

__device__ __forceinline__ bool converged(const Params& p, float r_p,
                                          float r_d) {
  return r_p <= p.tol_p && r_d <= p.tol_d;
}

__global__ void __launch_bounds__(MAX_COLS)
    fused_admm_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int nzp = p.nzp;
  const int j = threadIdx.x;
  const Scratch s{smem, smem + 2 * nzp * TB, nzp, nzp >> 5};
  const size_t base = static_cast<size_t>(blockIdx.x) * TB * nzp + j;
  const float lbj = p.lb[j];
  const float ubj = p.ub[j];
  int parity = 0;

  Column st, nw;
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    st.z[b] = p.z1[base + b * nzp];
    st.v[b] = p.v0[base + b * nzp];
    st.lam[b] = p.lam0[base + b * nzp];
  }
  bool done[TB];
  int k[TB];
  float rp[TB], rd[TB], r_p[TB], r_d[TB], zout[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    done[b] = false;
    k[b] = 0;
    rp[b] = RBIG;
    rd[b] = RBIG;
  }
  const int C = p.check_every;

  if (p.fixed_iters > 0) {
    // exactly fixed_iters plain iterations, no exit tests
    for (int it = 0; it < p.fixed_iters; ++it) {
      iterate<false>(p, s, parity, j, lbj, ubj, st, nw, r_p, r_d);
      st = nw;
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      zout[b] = st.z[b];
      k[b] = p.fixed_iters;
      done[b] = true;
    }
  } else if (C > 1 && p.exact_k) {
    // free-run windows of C iterations; snapshot every still-active lane
    // at each window start, so the window a lane converges in can be
    // replayed with per-iteration checks once the tile has drained.
    // Windows may overshoot k_max: the replay budget cuts each lane off
    // at exactly k_max.
    Column sn = st;
    int kws[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) kws[b] = 0;
    for (int it = 0; it < p.k_max && !all_of(done); it += C) {
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        if (!done[b]) {
          sn.z[b] = st.z[b];
          sn.v[b] = st.v[b];
          sn.lam[b] = st.lam[b];
          kws[b] = it;
        }
      }
      for (int f = 0; f < C - 1; ++f) {
        iterate<false>(p, s, parity, j, lbj, ubj, st, nw, r_p, r_d);
        st = nw;
      }
      iterate<true>(p, s, parity, j, lbj, ubj, st, nw, r_p, r_d);
      st = nw;
#pragma unroll
      for (int b = 0; b < TB; ++b)
        done[b] = done[b] || converged(p, r_p[b], r_d[b]);
    }
    // replay from the snapshots: k counts on from the window start
    int budget[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      budget[b] = min(C, p.k_max - kws[b]);
      done[b] = false;
      k[b] = kws[b];
      zout[b] = sn.z[b];
    }
    st = sn;
    for (int w = 0; w < C; ++w) {
      bool any = false;
#pragma unroll
      for (int b = 0; b < TB; ++b) any = any || (!done[b] && w < budget[b]);
      if (!any) break;
      iterate<true>(p, s, parity, j, lbj, ubj, st, nw, r_p, r_d);
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        if (!done[b] && w < budget[b]) {
          zout[b] = st.z[b];
          st.z[b] = nw.z[b];
          st.v[b] = nw.v[b];
          st.lam[b] = nw.lam[b];
          ++k[b];
          rp[b] = r_p[b];
          rd[b] = r_d[b];
          done[b] = converged(p, r_p[b], r_d[b]);
        }
      }
    }
  } else if (C > 1) {
    // free-run: C-1 plain iterations, then one checked iteration; every
    // lane keeps iterating until the block's lanes are all done, and k
    // is recorded at check granularity
    for (int it = 0; it < p.k_max && !all_of(done);) {
      const int n_fast = min(C - 1, p.k_max - 1 - it);
      for (int f = 0; f < n_fast; ++f) {
        iterate<false>(p, s, parity, j, lbj, ubj, st, nw, r_p, r_d);
        st = nw;
      }
      iterate<true>(p, s, parity, j, lbj, ubj, st, nw, r_p, r_d);
      st = nw;
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        if (!done[b]) {
          k[b] += n_fast + 1;
          rp[b] = r_p[b];
          rd[b] = r_d[b];
          done[b] = converged(p, r_p[b], r_d[b]);
        }
      }
      it += n_fast + 1;
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) zout[b] = st.z[b];
  } else {
    // checked: exit tests every iteration; a converged lane freezes and
    // keeps the z it consumed at exit
#pragma unroll
    for (int b = 0; b < TB; ++b) zout[b] = st.z[b];
    for (int it = 0; it < p.k_max && !all_of(done); ++it) {
      iterate<true>(p, s, parity, j, lbj, ubj, st, nw, r_p, r_d);
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        if (!done[b]) {
          zout[b] = st.z[b];
          st.z[b] = nw.z[b];
          st.v[b] = nw.v[b];
          st.lam[b] = nw.lam[b];
          ++k[b];
          rp[b] = r_p[b];
          rd[b] = r_d[b];
          done[b] = converged(p, r_p[b], r_d[b]);
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < TB; ++b) {
    p.z[base + b * nzp] = zout[b];
    p.v[base + b * nzp] = st.v[b];
    p.lam[base + b * nzp] = st.lam[b];
  }
  if (j == 0) {
    const int lane0 = blockIdx.x * TB;
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      p.k[lane0 + b] = k[b];
      p.done[lane0 + b] = done[b] ? 1 : 0;
      p.rp[lane0 + b] = rp[b];
      p.rd[lane0 + b] = rd[b];
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t). The geometry comes from the wrapper
// (kernels/fused_admm.py launch_geometry) and is checked here again.
// Returns cudaGetLastError() after the launch, as an int.
extern "C" int fused_admm_launch(
    const float* z1, const float* v0, const float* lam0, const float* mq,
    const float* lb, const float* ub, float* z, float* v, float* lam, int* k,
    int* done, float* rp, float* rd, int B, int nzp, int blocks, int threads,
    int smem, float rho, float rho_i, float alpha, float beta, int relax,
    float tol_p, float tol_d, int k_max, int check_every, int fixed_iters,
    int exact_k, int bf16, void* stream) {
  const int warps = nzp / 32;
  const long need = 4L * (2L * nzp * TB + 2L * warps * TB * 2);
  if (nzp <= 0 || nzp % 32 != 0 || nzp > MAX_COLS || B % TB != 0 ||
      blocks != B / TB || threads != nzp || smem != need || check_every < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Params p{z1,    v0,    lam0,    mq,     lb,     ub,          z,
           v,     lam,   k,       done,   rp,     rd,          nzp,
           rho,   rho_i, alpha,   beta,   relax,  tol_p,       tol_d,
           k_max, check_every, fixed_iters, exact_k, bf16};
  fused_admm_kernel<<<blocks, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
