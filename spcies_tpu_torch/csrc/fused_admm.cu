// Fused delta-form box-ADMM on NVIDIA Hopper (sm_90a), written by hand.
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
// fused_admm_kernel<L> runs every mode, the bf16 mode included (see
// Arithmetic). One thread block per L = 8, 16 or 32 lanes (the wrapper picks
// L by the batch and the width), one thread per column j of the padded
// decision vector (nzp threads: a multiple of 32, at most 512). z, v, lam and
// dq of the block's lanes lie in shared memory as [nzp][L] (the layouts of
// csrc/tile_product.cuh). The wide build (fused_admm_wide_kernel<L>, its
// engine WideEngine: 512 threads, 8 or 16 lanes a block) takes 512 to 1024
// columns: thread t owns columns t and t + 512 in steps 1 and 3 (WIDE_CPT),
// its product tiles are wide enough that 512 threads cover the block's
// columns (8 x 2 at 8 lanes, 8 x 4 at 16), and its slabs of M are 16 rows
// where shared memory leaves room for them and 8 where it does not (at 1024
// columns and 8 lanes, z, v, lam and dq take 147,456 bytes). The other
// builds' code is not touched by it. An iteration is
//   1. thread j forms v, lam and dq of column j (of each of its columns) for
//      the L lanes, 8 at a time; at a checked iteration the residuals'
//      maxima go through warp shuffles to shared memory;
//   2. the product stage of csrc/tile_product.cuh: a thread owns 8 lanes x
//      4 columns (8 x 1 at L = 8: tp::tile_cols), M's rows come through a
//      shared-memory ring filled by asynchronous copies (TMA); groups of 8
//      lanes that are done are skipped, and in exact-k's windows the lanes
//      still running are compacted into the first groups and the tiles
//      narrow, so that a block's cost follows its live lanes; after the
//      stage's first barrier, thread t < L (lane t's keeper: its k and
//      residuals live in that thread's registers) takes lane t's maxima over
//      the warps and warp 0 publishes the mask of converged lanes;
//   3. the tile's owner adds acc to z, except on lanes that are frozen or
//      end here: a lane's z stays the one it consumed at exit, which is the
//      checked and exact-k modes' output, so no copy of it is kept.
// An iteration has one __syncthreads a slab of M (slabs of 32 rows up to
// 256 columns, of 16 above: 8 or 30 at nzp = 256 or 480) and one after step
// 3. Loop control is uniform: every thread reads the same masks. Exact-k
// snapshots (z, v, lam at each window start of every lane not yet done) go
// to global scratch, each thread writing and reading back its own column. In
// plain free-run each group of 8 lanes freezes once its 8 lanes are done, as
// a tile of tile_b = 8 does, while the block runs on.
//
// Bound. 2 nz^2 FLOP an iteration and lane on the CUDA cores; L2 traffic is
// (B / L) k nzp^2 4 bytes, a quarter of the 8-lane kernel's at L = 32.
//
// Arithmetic. fp32 FMAs, no TF32; the library is built with -fmad=false, so
// the element-wise steps round exactly as PyTorch's separate operations do;
// the product is an explicit fmaf chain over the rows in ascending order, so
// the results are the same bits for every L, in the wide build as in the
// others, and the same as the one-column-per-thread kernel's
// (csrc/variants/fused_admm_parent.cu). In the
// bf16 mode the same chain runs on dq rounded to bf16 where it is formed and
// on M rounded to bf16 once a launch, by round_matrix_kernel into scratch,
// before the loop's kernel starts. A kernel that multiplies on the tensor
// cores (csrc/variants/fused_admm_tc.cu) sums otherwise, misses the k
// agreement bar with the plain version and is not launched.
//
// Padding. Pad columns carry zero rows and columns of M, [0, 0] bounds and
// zero state, so they stay exactly 0 and add nothing to the row maxima.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_product.cuh"

namespace {

constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr int NARROW = 256;    // up to this width a build of its own
constexpr int WIDE_CPT = 2;    // the wide build: columns a thread ...
constexpr int WIDE_THREADS = MAX_COLS;                   // ... its threads
constexpr int WIDE_COLS = WIDE_CPT * WIDE_THREADS;       // ... its widest
constexpr int WIDE_SLAB = 8;   // rows a slab where 16 leave no room
constexpr long SMEM_MAX = 232448;  // dynamic shared bytes a block can have
constexpr int NSNAP = 3;       // snapshot leaves: z, v, lam
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* __restrict__ z1;
  const float* __restrict__ v0;
  const float* __restrict__ lam0;
  const float* __restrict__ mq;  // [nzp][nzp], row-major, dq @ mq; in the
                                 // bf16 mode the rounded copy
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
  int k_max, check_every, fixed_iters, exact_k, bf16;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

using tp::bit;
using tp::Keeper;

__device__ __forceinline__ void write_lane(const Params& p, const Keeper& kp,
                                           int lane, bool done) {
  p.k[lane] = kp.k;
  p.done[lane] = done ? 1 : 0;
  p.rp[lane] = kp.rp;
  p.rd[lane] = kp.rd;
}

template <int L, int TC, int SR>
struct Engine {
  static constexpr int G = L / 8;
  static constexpr unsigned ALL = L == 32 ? FULL : (1u << L) - 1u;
  const Params& p;
  float *z, *v, *lam, *dq, *red;
  unsigned* ctrl;
  int *sn_k, *orig;
  tp::Ring ring;
  int tid, nzp, warps, lane0;
  float lbj, ubj;
  Keeper kp;

  __device__ __forceinline__ Engine(const Params& p_, float* smem)
      : p(p_) {
    tid = threadIdx.x;
    nzp = p.nzp;
    warps = nzp >> 5;
    lane0 = blockIdx.x * L;
    float* a = smem + tp::ring_bytes(nzp, SR) / 4;
    z = a;
    v = z + nzp * L;
    lam = v + nzp * L;
    dq = lam + nzp * L;
    red = dq + nzp * (L + tp::DQ_PAD);
    ctrl = reinterpret_cast<unsigned*>(red + warps * 2 * L);
    sn_k = reinterpret_cast<int*>(ctrl + 4);
    orig = sn_k + L;
    lbj = p.lb[tid];
    ubj = p.ub[tid];
    tp::ring_init<SR>(ring, smem, p.mq, nzp, nzp, 0, 0, tid, nzp);
  }

  template <bool CHECK>
  TP_ITERATE unsigned iterate(unsigned frozen, unsigned idle, unsigned last,
                              bool stop, unsigned rmask, int kinc) {
    const int j = tid;
    // groups of 8 lanes with nothing left to do are skipped
    const unsigned dead = tp::whole_groups<L>(frozen | idle);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float zc[8], vp[8], lm[8], d[8], ap[8], ad[8];
      tp::ld8<L>(zc, z, j, g);
      tp::ld8<L>(vp, v, j, g);
      tp::ld8<L>(lm, lam, j, g);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const float zr = p.relax ? p.alpha * zc[b] + p.beta * vp[b] : zc[b];
        const float y = zr + p.rho_i * lm[b];
        const float vn = fminf(fmaxf(y, lbj), ubj);
        const float ln = lm[b] + p.rho * (zr - vn);
        const float dd = p.rho * ((zr - 2.0f * vn) + vp[b]);
        d[b] = p.bf16 ? round_bf16(dd) : dd;
        if (CHECK) {
          ap[b] = fabsf(zc[b] - vn);
          ad[b] = fabsf(vn - vp[b]);
        }
        if (!bit(frozen, g * 8 + b)) {
          vp[b] = vn;
          lm[b] = ln;
        }
      }
      tp::st8_dq<L>(dq, j, g, d);
      tp::st8<L>(v, j, g, vp);
      tp::st8<L>(lam, j, g, lm);
      if (CHECK) {
        tp::warp_max<L>(ap, red, j, 0, g);
        tp::warp_max<L>(ad, red, j, 1, g);
      }
    }
    // the product's tiles: once the live groups are the block's first half
    // or quarter (the exact-k windows keep them first), narrower tiles give
    // every thread work again
    const int nl = max(1, G - __popc(dead) / 8);
    const bool packed = dead == (ALL & ~((1u << (8 * nl - 1) << 1) - 1u));
    if constexpr (TC >= 4 && G >= 4) {
      if (packed && 4 * nl <= G)
        return finish<TC / 4, CHECK>(dead, frozen, last, stop, rmask, kinc);
    }
    if constexpr (TC >= 2 && G >= 2) {
      if (packed && 2 * nl <= G)
        return finish<TC / 2, CHECK>(dead, frozen, last, stop, rmask, kinc);
    }
    return finish<TC, CHECK>(dead, frozen, last, stop, rmask, kinc);
  }

  // The iteration's second half with tiles of 8 lanes x TCX columns: the
  // product, the keeper's part after its first barrier, and z += acc.
  template <int TCX, bool CHECK>
  __device__ __forceinline__ unsigned finish(unsigned dead, unsigned frozen,
                                             unsigned last, bool stop,
                                             unsigned rmask, int kinc) {
    const tp::Tile<L, TCX> tile(tid, nzp);
    float acc[TCX][8];
#pragma unroll
    for (int q = 0; q < TCX; ++q) {
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[q][b] = 0.0f;
    }
    const bool live = tile.active && !bit(dead, 8 * tile.lg);
    tp::product<L, TCX, SR>(ring, dq, tile, acc, live, tid, nzp, CHECK, [&]() {
      if (CHECK && tid < 32) {
        float r_p = 0.0f, r_d = 0.0f;
        if (tid < L) {
          r_p = tp::lane_max<L>(red, warps, 0, tid);
          r_d = tp::lane_max<L>(red, warps, 1, tid);
        }
        const unsigned m =
            kp.keep(tid, L, r_p, r_d, p.tol_p, p.tol_d, rmask, kinc);
        if (tid == 0) ctrl[0] = m;
      }
    });
    if (live) {
      unsigned skip = (frozen | last) >> (tile.lg * 8);
      if (CHECK && stop) skip |= ctrl[0] >> (tile.lg * 8);
#pragma unroll
      for (int q = 0; q < TCX; ++q) {
        float zc[8];
        tp::ld8<L>(zc, z, tile.col(q), tile.lg);
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (!bit(skip, b)) zc[b] = zc[b] + acc[q][b];
        tp::st8<L>(z, tile.col(q), tile.lg, zc);
      }
    }
    __syncthreads();
    return CHECK ? ctrl[0] : 0u;
  }

  __device__ __forceinline__ unsigned compact(unsigned done) {
    float* const leaves[NSNAP] = {z, v, lam};
    return tp::compact_lanes<L>(done, leaves, orig, tid);
  }

  // Copy this thread's column of z, v and lam between shared memory and the
  // per-lane [z | v | lam] layout in global memory, for the slots in
  // `lanes` (slot b holds lane orig[b]). TO_GLOBAL selects the direction.
  template <bool TO_GLOBAL>
  __device__ __forceinline__ void snapshot(unsigned lanes) {
    float* const leaves[NSNAP] = {z, v, lam};
#pragma unroll
    for (int l = 0; l < NSNAP; ++l) {
      for (int b = 0; b < L; ++b) {
        if (!bit(lanes, b)) continue;
        float* g = p.snap +
                   (static_cast<size_t>(lane0 + orig[b]) * NSNAP + l) * nzp +
                   tid;
        float& sh = tp::at<L>(leaves[l], tid, b);
        if (TO_GLOBAL)
          *g = sh;
        else
          sh = *g;
      }
    }
  }
};

// The wide build's engine: Engine's state, product and keepers (its
// constructor lays out shared memory and gives thread t column t's bounds),
// with WIDE_CPT columns a thread, t + c WIDE_THREADS, in the element-wise
// half, the compaction and the snapshots, and the residuals' maxima over
// WIDE_THREADS / 32 warps. Needs nzp >= WIDE_THREADS.
template <int L, int TC, int SR>
struct WideEngine : Engine<L, TC, SR> {
  using Base = Engine<L, TC, SR>;
  using Base::ALL;
  using Base::G;
  using Base::dq;
  using Base::lam;
  using Base::lane0;
  using Base::nzp;
  using Base::orig;
  using Base::p;
  using Base::red;
  using Base::tid;
  using Base::v;
  using Base::z;
  float lb2, ub2;  // the second column's bounds

  __device__ __forceinline__ WideEngine(const Params& p_, float* smem)
      : Base(p_, smem) {
    this->warps = WIDE_THREADS >> 5;
    const int j = col(1);
    lb2 = j < nzp ? p.lb[j] : 0.0f;
    ub2 = j < nzp ? p.ub[j] : 0.0f;
  }

  // The thread's c-th column (nzp or more: none).
  __device__ __forceinline__ int col(int c) const {
    return tid + c * WIDE_THREADS;
  }

  template <bool CHECK>
  TP_ITERATE unsigned iterate(unsigned frozen, unsigned idle, unsigned last,
                              bool stop, unsigned rmask, int kinc) {
    // groups of 8 lanes with nothing left to do are skipped
    const unsigned dead = tp::whole_groups<L>(frozen | idle);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      // the residuals' maxima over the thread's columns
      float ap[8], ad[8];
#pragma unroll
      for (int c = 0; c < WIDE_CPT; ++c) {
        const int j = col(c);
        if (j >= nzp) break;
        const float lbj = c == 0 ? this->lbj : lb2;
        const float ubj = c == 0 ? this->ubj : ub2;
        float zc[8], vp[8], lm[8], d[8];
        tp::ld8<L>(zc, z, j, g);
        tp::ld8<L>(vp, v, j, g);
        tp::ld8<L>(lm, lam, j, g);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const float zr =
              p.relax ? p.alpha * zc[b] + p.beta * vp[b] : zc[b];
          const float y = zr + p.rho_i * lm[b];
          const float vn = fminf(fmaxf(y, lbj), ubj);
          const float ln = lm[b] + p.rho * (zr - vn);
          const float dd = p.rho * ((zr - 2.0f * vn) + vp[b]);
          d[b] = p.bf16 ? round_bf16(dd) : dd;
          if (CHECK) {
            const float a = fabsf(zc[b] - vn), e = fabsf(vn - vp[b]);
            ap[b] = c == 0 ? a : fmaxf(ap[b], a);
            ad[b] = c == 0 ? e : fmaxf(ad[b], e);
          }
          if (!bit(frozen, g * 8 + b)) {
            vp[b] = vn;
            lm[b] = ln;
          }
        }
        tp::st8_dq<L>(dq, j, g, d);
        tp::st8<L>(v, j, g, vp);
        tp::st8<L>(lam, j, g, lm);
      }
      if (CHECK) {
        tp::warp_max<L>(ap, red, tid, 0, g);
        tp::warp_max<L>(ad, red, tid, 1, g);
      }
    }
    // narrower tiles once the live groups are the block's first half
    // (Engine::iterate)
    const int nl = max(1, G - __popc(dead) / 8);
    const bool packed = dead == (ALL & ~((1u << (8 * nl - 1) << 1) - 1u));
    if constexpr (TC >= 2 && G >= 2) {
      if (packed && 2 * nl <= G)
        return this->template finish<TC / 2, CHECK>(dead, frozen, last,
                                                     stop, rmask, kinc);
    }
    return this->template finish<TC, CHECK>(dead, frozen, last, stop, rmask,
                                            kinc);
  }

  // tp::compact_lanes over each of the thread's columns.
  __device__ __forceinline__ unsigned compact(unsigned done) {
    float* const leaves[NSNAP] = {z, v, lam};
    const unsigned live = ~done & ALL;
    const int n = __popc(live);
    if (__popc(tp::whole_groups<L>(done)) / 8 == (L - n) / 8) return done;
#pragma unroll
    for (int l = 0; l < NSNAP; ++l) {
#pragma unroll
      for (int c = 0; c < WIDE_CPT; ++c) {
        const int j = col(c);
        if (j >= nzp) break;
        int to = 0;
        for (int s = 0; s < L; ++s) {
          if (!bit(live, s)) continue;
          if (s != to)
            tp::at<L>(leaves[l], j, to) = tp::at<L>(leaves[l], j, s);
          ++to;
        }
      }
    }
    if (tid == 0) {
      int to = 0;
      for (int s = 0; s < L; ++s) {
        if (!bit(live, s)) continue;
        orig[to++] = orig[s];
      }
    }
    __syncthreads();
    return n == 32 ? 0u : ALL & ~((1u << n) - 1u);
  }

  // Engine::snapshot over each of the thread's columns.
  template <bool TO_GLOBAL>
  __device__ __forceinline__ void snapshot(unsigned lanes) {
    float* const leaves[NSNAP] = {z, v, lam};
#pragma unroll
    for (int l = 0; l < NSNAP; ++l) {
#pragma unroll
      for (int c = 0; c < WIDE_CPT; ++c) {
        const int j = col(c);
        if (j >= nzp) break;
        for (int b = 0; b < L; ++b) {
          if (!bit(lanes, b)) continue;
          float* g =
              p.snap +
              (static_cast<size_t>(lane0 + orig[b]) * NSNAP + l) * nzp + j;
          float& sh = tp::at<L>(leaves[l], j, b);
          if (TO_GLOBAL)
            *g = sh;
          else
            sh = *g;
        }
      }
    }
  }
};

template <int L, int TC, int MAXT, int SR>
__global__ void __launch_bounds__(MAXT) fused_admm_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  Engine<L, TC, SR> e(p, smem);
  const int j = e.tid;
  const int nzp = p.nzp;
  for (int b = 0; b < L; ++b) {
    const size_t g = static_cast<size_t>(e.lane0 + b) * nzp + j;
    tp::at<L>(e.z, j, b) = p.z1[g];
    tp::at<L>(e.v, j, b) = p.v0[g];
    tp::at<L>(e.lam, j, b) = p.lam0[g];
  }
  if (j < L) {
    e.sn_k[j] = 0;
    e.orig[j] = j;
  }
  __syncthreads();
  const unsigned done = tp::run_modes<L>(e, p.k_max, p.check_every,
                                          p.exact_k, p.fixed_iters);
  tp::ring_drain(e.ring);
  for (int b = 0; b < L; ++b) {
    const size_t g = static_cast<size_t>(e.lane0 + b) * nzp + j;
    p.z[g] = tp::at<L>(e.z, j, b);
    p.v[g] = tp::at<L>(e.v, j, b);
    p.lam[g] = tp::at<L>(e.lam, j, b);
  }
  if (j < L) write_lane(p, e.kp, e.lane0 + j, bit(done, j));
}

// fused_admm_kernel over WideEngine: each thread loads and stores its
// WIDE_CPT columns.
template <int L, int TC, int SR>
__global__ void __launch_bounds__(WIDE_THREADS)
    fused_admm_wide_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  WideEngine<L, TC, SR> e(p, smem);
  const int nzp = p.nzp;
#pragma unroll
  for (int c = 0; c < WIDE_CPT; ++c) {
    const int j = e.col(c);
    if (j >= nzp) break;
    for (int b = 0; b < L; ++b) {
      const size_t g = static_cast<size_t>(e.lane0 + b) * nzp + j;
      tp::at<L>(e.z, j, b) = p.z1[g];
      tp::at<L>(e.v, j, b) = p.v0[g];
      tp::at<L>(e.lam, j, b) = p.lam0[g];
    }
  }
  if (e.tid < L) {
    e.sn_k[e.tid] = 0;
    e.orig[e.tid] = e.tid;
  }
  __syncthreads();
  const unsigned done = tp::run_modes<L>(e, p.k_max, p.check_every,
                                          p.exact_k, p.fixed_iters);
  tp::ring_drain(e.ring);
#pragma unroll
  for (int c = 0; c < WIDE_CPT; ++c) {
    const int j = e.col(c);
    if (j >= nzp) break;
    for (int b = 0; b < L; ++b) {
      const size_t g = static_cast<size_t>(e.lane0 + b) * nzp + j;
      p.z[g] = tp::at<L>(e.z, j, b);
      p.v[g] = tp::at<L>(e.v, j, b);
      p.lam[g] = tp::at<L>(e.lam, j, b);
    }
  }
  if (e.tid < L) write_lane(p, e.kp, e.lane0 + e.tid, bit(done, e.tid));
}

// out = in rounded to bf16, entry by entry (the bf16 mode's M).
__global__ void round_matrix_kernel(const float* __restrict__ in,
                                    float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = round_bf16(in[i]);
}

// Dynamic shared bytes of a block: the ring of slabs of SR rows; z, v and
// lam as [nzp][L], dq with its padding; the warps' row maxima (nzp / 32
// warps); the masks, the window starts and the slots' lanes.
long smem_bytes(int nzp, int lanes, int sr) {
  return tp::ring_bytes(nzp, sr) +
         4L * (nzp * (4L * lanes + tp::DQ_PAD) + (nzp / 32) * 2L * lanes + 4 +
               2 * lanes);
}

// Rows a slab of the wide build: tp::SLAB where it fits, else WIDE_SLAB.
int wide_slab(int nzp, int lanes) {
  return smem_bytes(nzp, lanes, tp::SLAB) <= SMEM_MAX ? tp::SLAB : WIDE_SLAB;
}

template <int L>
int launch(const Params& p, int blocks, int threads, int smem, int wide,
           void* stream) {
  // up to NARROW columns a build with more registers a thread and deeper
  // slabs of M; the wide build's tiles are wide enough that its threads
  // cover (L / 8) nzp / TCW <= WIDE_THREADS tiles
  constexpr int TC = tp::tile_cols<L>();
  constexpr int TCW = TC > (L / 8) * WIDE_CPT ? TC : (L / 8) * WIDE_CPT;
  void (*kernel)(Params) = nullptr;
  if (!wide) {
    kernel = p.nzp <= NARROW
                 ? fused_admm_kernel<L, TC, NARROW, tp::SLAB_NARROW>
                 : fused_admm_kernel<L, TC, MAX_COLS, tp::SLAB>;
  } else {
    // 32 lanes a block never fit beside a wide block's state
    if constexpr (L <= 16)
      kernel = wide_slab(p.nzp, L) == tp::SLAB
                   ? fused_admm_wide_kernel<L, TCW, tp::SLAB>
                   : fused_admm_wide_kernel<L, TCW, WIDE_SLAB>;
  }
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

// Dynamic shared bytes at `lanes` lanes a block, of the wide build where
// `wide` is set (kernels/fused_admm.py computes the same).
extern "C" long fused_admm_smem(int nzp, int lanes, int wide) {
  return smem_bytes(nzp, lanes,
                    wide              ? wide_slab(nzp, lanes)
                    : nzp <= NARROW ? tp::SLAB_NARROW
                                    : tp::SLAB);
}

// Launch on `stream` (a cudaStream_t). The geometry comes from the wrapper
// (kernels/fused_admm.py launch_geometry) and is checked here again; `wide`
// selects the wide build (WIDE_THREADS threads, WIDE_THREADS to WIDE_COLS
// columns).
// `mq_round` is [nzp][nzp] of scratch for the bf16 mode's rounded M (unused
// otherwise). Returns the CUDA error of the launch, as an int.
extern "C" int fused_admm_launch(
    const float* z1, const float* v0, const float* lam0, const float* mq,
    const float* lb, const float* ub, float* z, float* v, float* lam, int* k,
    int* done, float* rp, float* rd, float* snap, float* mq_round, int B,
    int nzp, int lanes, int wide, int blocks, int threads, int smem,
    float rho, float rho_i, float alpha, float beta, int relax, float tol_p,
    float tol_d, int k_max, int check_every, int fixed_iters, int exact_k,
    int bf16, void* stream) {
  const bool exact = check_every > 1 && exact_k && fixed_iters == 0;
  if (nzp <= 0 || nzp % 32 != 0 ||
      (wide ? nzp < WIDE_THREADS || nzp > WIDE_COLS : nzp > MAX_COLS) ||
      (lanes != 8 && lanes != 16 && lanes != 32) || B % lanes != 0 ||
      blocks != B / lanes || threads != (wide ? WIDE_THREADS : nzp) ||
      smem != fused_admm_smem(nzp, lanes, wide) || smem > SMEM_MAX ||
      check_every < 1 ||
      (exact && B > 0 && snap == nullptr) || (bf16 && mq_round == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (bf16) {
    const int n = nzp * nzp;
    round_matrix_kernel<<<(n + 255) / 256, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(mq, mq_round, n);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    mq = mq_round;
  }
  Params p{z1,    v0,    lam0,  mq,    lb,    ub,    z,
           v,     lam,   k,     done,  rp,    rd,    snap,
           nzp,   rho,   rho_i, alpha, beta,  relax, tol_p,
           tol_d, k_max, check_every,  fixed_iters,  exact_k, bf16};
  switch (lanes) {
    case 8:
      return launch<8>(p, blocks, threads, smem, wide, stream);
    case 16:
      return launch<16>(p, blocks, threads, smem, wide, stream);
    default:
      return launch<32>(p, blocks, threads, smem, wide, stream);
  }
}
