// Fused delta-form box-ADMM in the bf16 mode on the tensor cores of NVIDIA
// Hopper (sm_90a), written by hand: a variant that tools/ab_kernels.py times
// and holds against the plain bf16 version. kernels/fused_admm.py does not
// launch it: its sums round otherwise than an fmaf chain, which under the
// bf16 rounding of dq moves k on most lanes (k agreement 0.20 with the plain
// version on an H100 against a bar of 0.9985, PERF.md), so the bf16 mode runs
// on the CUDA cores of csrc/fused_admm.cu.
//
// It computes the loop of csrc/fused_admm.cu with dq and M in bf16 and the
// sum in fp32: mma.sync.m16n8k16. M^T in bf16 (128 KiB at nzp = 256, the
// widest it takes) is copied once into shared memory by cp.async and stays
// for the block's whole loop: no L2 read is left inside the iteration. A
// block is 8 warps and 16 MT lanes (MT = 1 or 2); warp w owns the 8-column
// tiles w, w + 8, ... and keeps z, v, lam of its MT x 4 accumulator fragments
// in registers, so the element-wise half runs in the fragment layout and
// only dq (bf16, [lane][k], double-buffered) and the warps' row maxima pass
// through shared memory: one barrier an iteration, two at a checked one. The
// mode loops are those of csrc/tile_product.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_product.cuh"

namespace {

constexpr int NSNAP = 3;  // snapshot leaves: z, v, lam
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* __restrict__ z1;
  const float* __restrict__ v0;
  const float* __restrict__ lam0;
  const __nv_bfloat16* __restrict__ mt;  // M^T in bf16, [nzp][nzp]
  const float* __restrict__ lb;
  const float* __restrict__ ub;
  float* z;
  float* v;
  float* lam;
  int* k;
  int* done;
  float* rp;
  float* rd;
  float* snap;  // exact-k: per lane [z | v | lam]
  int nzp;
  float rho, rho_i, alpha, beta;  // beta = 1 - alpha, rounded on the host
  int relax;                      // alpha != 1
  float tol_p, tol_d;
  int k_max, check_every, fixed_iters, exact_k;
};

using tp::bit;
using tp::Keeper;

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_MAX_COLS = 256;
constexpr int TC_NT = TC_MAX_COLS / 8 / TC_WARPS;  // 8-column tiles a warp
constexpr int TC_PAD = 8;  // bf16 entries of padding a row: no bank conflicts

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A thread's entries of the block's [L][nzp] state, in the accumulator
// layout of m16n8: element e of fragment (mt, i) is row 16 mt + gq + 8 (e /
// 2), column 8 (warp + 8 i) + 2 tq + e % 2, with gq = lane / 4, tq = lane % 4.
template <int MT>
struct TcEngine {
  static constexpr int L = 16 * MT;
  const Params& p;
  __nv_bfloat16 *ms, *dqs;  // M^T [nzp][ld]; dq [2][L][ld]
  float* red;               // [warps][2][L]
  unsigned* ctrl;
  int *sn_k, *orig;
  int tid, warp, gq, tq, nzp, ld, nt, lane0, parity;
  float z[MT][TC_NT][4], v[MT][TC_NT][4], lam[MT][TC_NT][4];
  float lb[TC_NT][2], ub[TC_NT][2];
  Keeper kp;

  __device__ __forceinline__ int row(int mt, int e) const {
    return 16 * mt + gq + 8 * (e >> 1);
  }
  __device__ __forceinline__ int col(int i, int e) const {
    return 8 * (warp + TC_WARPS * i) + 2 * tq + (e & 1);
  }
  // the warp's i-th tile lies inside the width
  __device__ __forceinline__ bool has(int i) const {
    return warp + TC_WARPS * i < nt;
  }

  __device__ __forceinline__ TcEngine(const Params& p_, unsigned char* smem)
      : p(p_) {
    tid = threadIdx.x;
    warp = tid >> 5;
    gq = (tid & 31) >> 2;
    tq = tid & 3;
    nzp = p.nzp;
    ld = nzp + TC_PAD;
    nt = nzp / 8;
    lane0 = blockIdx.x * L;
    parity = 0;
    ms = reinterpret_cast<__nv_bfloat16*>(smem);
    dqs = ms + nzp * ld;
    red = reinterpret_cast<float*>(dqs + 2 * L * ld);
    ctrl = reinterpret_cast<unsigned*>(red + TC_WARPS * 2 * L);
    sn_k = reinterpret_cast<int*>(ctrl + 4);
    orig = sn_k + L;
    // M^T into shared memory, once: 16 bytes a copy
    const int per_row = nzp / 8;
    for (int i = tid; i < nzp * per_row; i += TC_THREADS) {
      const int r = i / per_row, c = (i - r * per_row) * 8;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       tp::smem_addr(ms + r * ld + c)),
                   "l"(p.mt + static_cast<size_t>(r) * nzp + c)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < TC_NT; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        lb[i][e] = has(i) ? p.lb[col(i, e)] : 0.0f;
        ub[i][e] = has(i) ? p.ub[col(i, e)] : 0.0f;
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < TC_NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const size_t g =
              static_cast<size_t>(lane0 + row(mt, e)) * nzp + col(i, e);
          z[mt][i][e] = has(i) ? p.z1[g] : 0.0f;
          v[mt][i][e] = has(i) ? p.v0[g] : 0.0f;
          lam[mt][i][e] = has(i) ? p.lam0[g] : 0.0f;
        }
      }
    }
    if (tid < L) {
      sn_k[tid] = 0;
      orig[tid] = tid;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  template <bool CHECK>
  __device__ __forceinline__ unsigned iterate(unsigned frozen, unsigned,
                                              unsigned last, bool stop,
                                              unsigned rmask, int kinc) {
    __nv_bfloat16* dq = dqs + parity * L * ld;
    parity ^= 1;
    float ap[MT][2], ad[MT][2];  // rows gq and gq + 8 of each m tile
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ap[mt][0] = ap[mt][1] = ad[mt][0] = ad[mt][1] = 0.0f;
#pragma unroll
      for (int i = 0; i < TC_NT; ++i) {
        if (!has(i)) continue;
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float zc = z[mt][i][e], vp = v[mt][i][e];
          const float zr = p.relax ? p.alpha * zc + p.beta * vp : zc;
          const float y = zr + p.rho_i * lam[mt][i][e];
          const float vn = fminf(fmaxf(y, lb[i][e & 1]), ub[i][e & 1]);
          const float ln = lam[mt][i][e] + p.rho * (zr - vn);
          d[e] = p.rho * ((zr - 2.0f * vn) + vp);
          if (CHECK) {
            ap[mt][e >> 1] = fmaxf(ap[mt][e >> 1], fabsf(zc - vn));
            ad[mt][e >> 1] = fmaxf(ad[mt][e >> 1], fabsf(vn - vp));
          }
          if (!bit(frozen, row(mt, e))) {
            v[mt][i][e] = vn;
            lam[mt][i][e] = ln;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(dq + row(mt, 2 * h) * ld +
                                             col(i, 0)) =
              __floats2bfloat162_rn(d[2 * h], d[2 * h + 1]);
      }
    }
    if (CHECK) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            ap[mt][h] = fmaxf(ap[mt][h], __shfl_xor_sync(FULL, ap[mt][h], off));
            ad[mt][h] = fmaxf(ad[mt][h], __shfl_xor_sync(FULL, ad[mt][h], off));
          }
          if (tq == 0) {
            red[(warp * 2 + 0) * L + 16 * mt + gq + 8 * h] = ap[mt][h];
            red[(warp * 2 + 1) * L + 16 * mt + gq + 8 * h] = ad[mt][h];
          }
        }
      }
    }
    __syncthreads();
    if (CHECK && tid < 32) {
      float r_p = 0.0f, r_d = 0.0f;
      if (tid < L) {
        r_p = tp::lane_max<L>(red, TC_WARPS, 0, tid);
        r_d = tp::lane_max<L>(red, TC_WARPS, 1, tid);
      }
      const unsigned m =
          kp.keep(tid, L, r_p, r_d, p.tol_p, p.tol_d, rmask, kinc);
      if (tid == 0) ctrl[0] = m;
    }
    float acc[MT][TC_NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < TC_NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.0f;
      }
    }
    for (int k0 = 0; k0 < nzp; k0 += 16) {
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* base = dq + (16 * mt + gq) * ld + k0 + 2 * tq;
        a[mt][0] = *reinterpret_cast<const unsigned*>(base);
        a[mt][1] = *reinterpret_cast<const unsigned*>(base + 8 * ld);
        a[mt][2] = *reinterpret_cast<const unsigned*>(base + 8);
        a[mt][3] = *reinterpret_cast<const unsigned*>(base + 8 * ld + 8);
      }
#pragma unroll
      for (int i = 0; i < TC_NT; ++i) {
        if (!has(i)) continue;
        const __nv_bfloat16* mb =
            ms + (8 * (warp + TC_WARPS * i) + gq) * ld + k0 + 2 * tq;
        const unsigned b0 = *reinterpret_cast<const unsigned*>(mb);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(mb + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][i], a[mt], b0, b1);
      }
    }
    unsigned conv = 0;
    if (CHECK) {
      __syncthreads();
      conv = ctrl[0];
    }
    const unsigned skip = frozen | last | (stop ? conv : 0u);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < TC_NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!bit(skip, row(mt, e)))
            z[mt][i][e] = z[mt][i][e] + acc[mt][i][e];
      }
    }
    return conv;
  }

  // the state lives in registers in the fragment layout: lanes keep their
  // slots
  __device__ __forceinline__ unsigned compact(unsigned done) { return done; }

  // This thread's entries of z, v and lam to or from the per-lane
  // [z | v | lam] layout in global memory, for the lanes in `lanes`.
  template <bool TO_GLOBAL>
  __device__ __forceinline__ void snapshot(unsigned lanes) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < TC_NT; ++i) {
        if (!has(i)) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!bit(lanes, row(mt, e))) continue;
          float* g = p.snap +
                     static_cast<size_t>(lane0 + row(mt, e)) * NSNAP * nzp +
                     col(i, e);
          if (TO_GLOBAL) {
            g[0] = z[mt][i][e];
            g[nzp] = v[mt][i][e];
            g[2 * nzp] = lam[mt][i][e];
          } else {
            z[mt][i][e] = g[0];
            v[mt][i][e] = g[nzp];
            lam[mt][i][e] = g[2 * nzp];
          }
        }
      }
    }
  }
};

template <int MT>
__global__ void __launch_bounds__(TC_THREADS) fused_admm_tc_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  constexpr int L = 16 * MT;
  TcEngine<MT> e(p, smem_tc);
  const unsigned done = tp::run_modes<L>(e, p.k_max, p.check_every,
                                          p.exact_k, p.fixed_iters);
  const int nzp = p.nzp;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < TC_NT; ++i) {
      if (!e.has(i)) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t g =
            static_cast<size_t>(e.lane0 + e.row(mt, q)) * nzp + e.col(i, q);
        p.z[g] = e.z[mt][i][q];
        p.v[g] = e.v[mt][i][q];
        p.lam[g] = e.lam[mt][i][q];
      }
    }
  }
  if (e.tid < L) {
    const int lane = e.lane0 + e.tid;
    p.k[lane] = e.kp.k;
    p.done[lane] = bit(done, e.tid) ? 1 : 0;
    p.rp[lane] = e.kp.rp;
    p.rd[lane] = e.kp.rd;
  }
}

}  // namespace

// Dynamic shared bytes at `lanes` lanes a block: M^T [nzp][nzp + pad] and dq
// [2][lanes][nzp + pad] in bf16, the warps' row maxima, the masks, the window
// starts and the slots' lanes.
extern "C" long fused_admm_tc_smem(int nzp, int lanes) {
  return 2L * (nzp + TC_PAD) * (nzp + 2L * lanes) +
         4L * (TC_WARPS * 2L * lanes + 4 + 2 * lanes);
}

// Launch on `stream` (a cudaStream_t) with 16 or 32 lanes a block, 256
// threads and fused_admm_tc_smem bytes. Returns the CUDA error of the launch,
// as an int.
extern "C" int fused_admm_tc_launch(
    const float* z1, const float* v0, const float* lam0, const void* mt,
    const float* lb, const float* ub, float* z, float* v, float* lam, int* k,
    int* done, float* rp, float* rd, float* snap, int B, int nzp, int lanes,
    float rho, float rho_i, float alpha, float beta, int relax, float tol_p,
    float tol_d, int k_max, int check_every, int fixed_iters, int exact_k,
    void* stream) {
  const bool exact = check_every > 1 && exact_k && fixed_iters == 0;
  if (nzp <= 0 || nzp % 32 != 0 || nzp > TC_MAX_COLS ||
      (lanes != 16 && lanes != 32) || B % lanes != 0 || check_every < 1 ||
      mt == nullptr || (exact && B > 0 && snap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Params p{z1,  v0,  lam0,  static_cast<const __nv_bfloat16*>(mt),
           lb,  ub,  z,     v,
           lam, k,   done,  rp,
           rd,  snap, nzp,  rho,
           rho_i, alpha, beta, relax,
           tol_p, tol_d, k_max, check_every,
           fixed_iters, exact_k};
  void (*kernel)(Params) =
      lanes == 16 ? fused_admm_tc_kernel<1> : fused_admm_tc_kernel<2>;
  const int smem = static_cast<int>(fused_admm_tc_smem(nzp, lanes));
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B / lanes, TC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
