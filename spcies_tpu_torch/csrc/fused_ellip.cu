// Fused ellipMPC-ADMM on NVIDIA Hopper (sm_90a), written by hand, on the
// product stage csrc/tile_product.cuh.
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
// PyTorch version of every mode are in kernels/fused_ellip.py. The
// one-column-per-thread kernel this design replaced is
// csrc/variants/fused_ellip_parent.cu (tools/ab_kernels.py holds every
// build to it, bit for bit).
//
// Layout. A block of nzp threads (one per padded column, a multiple of 32,
// at most 512; 256 at N=30) holds L = 8, 16 or 32 lanes
// (kernels/fused_ellip.py launch_plan); z, v and lam [nzp][L] and dq
// [nzp][L + 4] lie in shared memory (the layouts of csrc/tile_product.cuh).
// An iteration is
//   1. the warp that holds the slab (the adapter keeps it inside one warp:
//      t0 % 32 + n <= 32; at N=30 columns 234..239 of warp 7) stages
//      y - c' of its columns in its rows of dq, and its thread t takes lane
//      t's ball: the n squares added in slab order, one after the other, as
//      the plain version adds them, the norm and the scale, into shared
//      memory. The parent did this with every thread of the warp summing
//      its column of all lanes from shuffled squares, a way that cost K5
//      and K6 a quarter or more of an iteration on an H100 (PERF.md);
//   2. thread j forms v, lam and dq of column j for the L lanes, 8 at a
//      time (the slab columns from their lanes' scales); at a checked
//      iteration the slab columns stage their differences z' - v' and
//      v' - v'_prev, the slab warp's thread t maps lane t's through pinvh
//      (n terms a column in slab order, each product and sum rounded on its
//      own) and folds the maxima into its warp's row maxima;
//   3. the product stage: a thread owns 8 lanes x 4 columns of z (8 x 1 at
//      L = 8); M2's t0 + n real rows (240 of 256 at N=30) come through the
//      shared-memory ring filled by TMA; after its first barrier thread
//      t < L (lane t's keeper) takes lane t's row maxima and warp 0
//      publishes the converged lanes;
//   4. the tile's owner adds acc to z, except on lanes that are frozen or
//      end here: a lane's z stays the one it consumed at exit, the checked
//      and exact-k modes' output, so no copy of the consumed z is kept.
// An iteration has one barrier a slab and one after step 4. Each L has its
// own build (Build below: rows a slab, blocks an SM).
//
// Plain free-run and the checked mode refill (csrc/tile_product.cuh,
// Refill): persistent blocks whose 8-lane slots take the next group of 8
// lanes from a queue once their group has ended. Exact-k, the main path,
// keeps its block of L lanes, compacts the lanes still running and narrows
// the tiles; fixed_iters keeps its block of L lanes.
//
// Bound. 2 (t0 + n)^2 FLOP an iteration and lane (the real columns of the
// product); each block re-reads M2's real rows from L2 once an iteration
// for its L lanes. The product must stay full fp32 (the JAX kernel pins it
// to HIGHEST: a truncated M2 shifts the fixed point of degenerate
// ellipsoids), so no bf16 or TF32 path.
//
// Arithmetic. fp32 on the CUDA cores, no TF32. The library is built with
// -fmad=false, so the element-wise steps (sqrtf and the division included)
// round as PyTorch's separate operations do; the product is an explicit
// fmaf chain over the rows in ascending order, as in the parent, so every
// build gives the parent's bits.
//
// Exact-k snapshots. At each window start z, v and lam of every lane not
// yet done go to global scratch (each thread writes, and later reads back,
// only its own column), and the window start to shared memory; the replay
// runs each lane's last window with the checked semantics and the budget
// min(C, k_max - kws).
//
// Padding. Pad columns carry zero rows and columns of M2, [0, 0] bounds
// and c' = 0, so they stay exactly 0 and add nothing to the row maxima.

#include <cuda_runtime.h>

#include "tile_product.cuh"

// rows a slab of M2 and blocks an SM of each build up to NARROW columns
// (kernels/fused_ellip.py BUILDS); a timing script may set others
#ifndef EL_SLAB_8
#define EL_SLAB_8 16
#endif
#ifndef EL_BLOCKS_8
#define EL_BLOCKS_8 2
#endif
#ifndef EL_SLAB_16
#define EL_SLAB_16 16
#endif
#ifndef EL_BLOCKS_16
#define EL_BLOCKS_16 2
#endif
#ifndef EL_SLAB_32
#define EL_SLAB_32 32
#endif
#ifndef EL_BLOCKS_32
#define EL_BLOCKS_32 1
#endif

namespace {

constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr int NARROW = 320;    // up to this width the builds of Build<L>
constexpr int WIDE_SLAB = 16;  // rows a slab above NARROW (8 and 16 lanes)
constexpr int NSNAP = 3;       // snapshot leaves (SNAP_LEAVES in the wrapper)

template <int L>
struct Build;
template <>
struct Build<8> {
  static constexpr int SR = EL_SLAB_8, MINB = EL_BLOCKS_8;
};
template <>
struct Build<16> {
  static constexpr int SR = EL_SLAB_16, MINB = EL_BLOCKS_16;
};
template <>
struct Build<32> {
  static constexpr int SR = EL_SLAB_32, MINB = EL_BLOCKS_32;
};

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
  float* snap;   // exact-k: per lane [z | v | lam]
  int* queue;    // refill: [0] the next group, [1 + b] block b's
                 // iterations; zeroed by the wrapper
  int n_groups;  // B / 8
  int nzp, t0, n;
  float rho, rho_i, r_ball, tol_p, tol_d;
  int k_max, check_every, fixed_iters, exact_k;
};

using tp::bit;

// The block: the stage's engine over the leaves z, v, lam, and what thread
// j knows of its column (in the wide build's CPT = 2, WideEngine sets up
// the block and each of a thread's columns instead).
template <int L, int TC, int SR, int CPT = 1>
struct Engine : tp::TileEngine<L, TC, SR, NSNAP, CPT> {
  static constexpr int G = L / 8;
  static constexpr int RS = L + tp::DQ_PAD;  // row stride of dq and rst
  const Params& p;
  float *z, *v, *lam;
  float* ball;  // [L]: each lane's scale of y - c' on the slab
  float* rst;   // [2][n][RS]: the slab's z' - v' and v' - v'_prev
  float* pin;   // [n][n]: pinvh
  int jj;       // this column's place in the slab
  bool slab;    // a slab column
  bool slab_warp;  // in the warp that holds the slab (warp-uniform)
  float lbj, ubj, cj;

  __device__ __forceinline__ Engine(const Params& p_, float* smem) : p(p_) {
    if constexpr (CPT == 1) {
      const int j = threadIdx.x;
      const int P = p.nzp;
      this->tid = j;
      this->T = P;
      this->P = P;
      this->rwarps = P >> 5;
      this->lane0 = blockIdx.x * L;
      this->tol_p = p.tol_p;
      this->tol_d = p.tol_d;
      float* a = smem + tp::ring_bytes(P, SR) / 4;
      z = a;
      v = z + P * L;
      lam = v + P * L;
      this->dq = lam + P * L;
      this->red = this->dq + P * RS;
      this->ctrl =
          reinterpret_cast<unsigned*>(this->red + this->rwarps * 2 * L);
      this->sn_k = reinterpret_cast<int*>(this->ctrl + 4);
      this->orig = this->sn_k + L;
      ball = reinterpret_cast<float*>(this->orig + L);
      rst = ball + L;
      pin = rst + 2 * p.n * RS;
      // z is the leaf the product adds to; the snapshot is [z | v | lam]
      this->leaf[0] = tp::Leaf{z, p.z1, p.z, P, 0};
      this->leaf[1] = tp::Leaf{v, p.v0, p.v, P, P};
      this->leaf[2] = tp::Leaf{lam, p.lam0, p.lam, P, 2 * P};
      this->snap = p.snap;
      this->snap_width = NSNAP * P;
      this->out = tp::LaneOut{p.k, p.done, p.rp, p.rd};
      jj = j - p.t0;
      slab = jj >= 0 && jj < p.n;
      slab_warp = (j >> 5) == (p.t0 >> 5);
      lbj = p.lb[j];
      ubj = p.ub[j];
      cj = p.c[j];
      // pinvh, published by the barrier after the lanes are read in
      for (int i = j; i < p.n * p.n; i += P) pin[i] = p.pinvh[i];
      // the product's rows: the real ones, [0, t0 + n)
      const int nr = p.t0 + p.n;
      tp::ring_init<SR>(this->ring, smem, p.m2, P, nr, nr, nr, j, P);
    }
  }

  // One iteration (tp::run_modes, tp::run_refill). Lanes in `frozen` keep
  // all their state; what `idle` lanes hold is never read again, and a group
  // of 8 lanes that are all frozen or idle is skipped; the lanes in `last`
  // (and, with stop, the lanes that converge here) keep the z they consumed.
  // With CHECK, the keepers of the lanes in rmask record their residuals
  // and count kinc iterations, and the lanes whose residuals meet tol are
  // returned (identical in every thread of the block).
  template <bool CHECK>
  TP_ITERATE unsigned iterate(unsigned frozen, unsigned idle, unsigned last,
                              bool stop, unsigned rmask, int kinc) {
    const int j = this->tid;
    this->tic();
    const unsigned dead = tp::whole_groups<L>(frozen | idle);
    if (slab_warp) ball_scales(dead);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float zc[8], vp[8], lm[8], d[8], ap[8], ad[8];
      tp::ld8<L>(zc, z, j, g);
      tp::ld8<L>(vp, v, j, g);
      tp::ld8<L>(lm, lam, j, g);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const float y = zc[b] + p.rho_i * lm[b];
        const float vn = slab ? cj + ball[8 * g + b] * (y - cj)
                              : fminf(fmaxf(y, lbj), ubj);
        const float ln = lm[b] + p.rho * (zc[b] - vn);
        d[b] = p.rho * ((zc[b] - 2.0f * vn) + vp[b]);
        if (CHECK) {
          ap[b] = zc[b] - vn;
          ad[b] = vn - vp[b];
        }
        if (!bit(frozen, g * 8 + b)) {
          vp[b] = vn;
          lm[b] = ln;
        }
      }
      tp::st8_dq<L>(this->dq, j, g, d);
      tp::st8<L>(v, j, g, vp);
      tp::st8<L>(lam, j, g, lm);
      if (CHECK) {
        if (slab) {
          // mapped back and folded into the maxima below, lane by lane
          tp::st8_dq<L>(rst, jj, g, ap);
          tp::st8_dq<L>(rst + p.n * RS, jj, g, ad);
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          ap[b] = slab ? 0.0f : fabsf(ap[b]);
          ad[b] = slab ? 0.0f : fabsf(ad[b]);
        }
        tp::warp_max<L>(ap, this->red, j, 0, g);
        tp::warp_max<L>(ad, this->red, j, 1, g);
      }
    }
    if (CHECK && slab_warp) slab_residuals(dead);
    return this->template product_half<CHECK>(dead, frozen, last, stop,
                                              rmask, kinc);
  }

  // The slab warp's ball, one lane a thread: the warp stages y - c' of its
  // columns in its rows of dq; thread t then adds lane t's n squares in slab
  // order, one after the other, and leaves min(1, r / max(norm, 1e-30)) in
  // ball[t].
  __device__ __forceinline__ void ball_scales(unsigned dead) {
    const int j = this->tid;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float zc[8], lm[8], yc[8];
      tp::ld8<L>(zc, z, j, g);
      tp::ld8<L>(lm, lam, j, g);
#pragma unroll
      for (int b = 0; b < 8; ++b) yc[b] = (zc[b] + p.rho_i * lm[b]) - cj;
      tp::st8_dq<L>(this->dq, j, g, yc);
    }
    __syncwarp();
    const int t = j & 31;
    if (t < L && !bit(dead, t)) {
      const float* col = this->dq + p.t0 * RS + t;
      float q = 0.0f;
      for (int i = 0; i < p.n; ++i) {
        const float x = col[i * RS];
        const float sq = x * x;
        q = q + sq;
      }
      const float nrm = sqrtf(q);
      ball[t] = fminf(1.0f, p.r_ball / fmaxf(nrm, 1e-30f));
    }
    __syncwarp();
  }

  // At a checked iteration, the slab warp's thread t maps lane t's staged
  // differences back to the original coordinates (column jj of d_slab @
  // pinvh: n terms in slab order, each product and sum rounded on its own)
  // and folds the maxima of their magnitudes into the warp's row maxima,
  // where the slab columns put 0.
  __device__ __forceinline__ void slab_residuals(unsigned dead) {
    __syncwarp();
    const int t = this->tid & 31;
    if (t < L && !bit(dead, t)) {
      const int n = p.n;
      const float* a = rst + t;
      const float* d = rst + n * RS + t;
      float mp = 0.0f, md = 0.0f;
      for (int c = 0; c < n; ++c) {
        float bp = 0.0f, bd = 0.0f;
        for (int i = 0; i < n; ++i) {
          const float w = pin[i * n + c];
          bp = bp + a[i * RS] * w;
          bd = bd + d[i * RS] * w;
        }
        mp = fmaxf(mp, fabsf(bp));
        md = fmaxf(md, fabsf(bd));
      }
      float* r = this->red + ((this->tid >> 5) * 2) * L + t;
      r[0] = fmaxf(r[0], mp);
      r[L] = fmaxf(r[L], md);
    }
  }
};

}  // namespace

#if !WIDE_PART
namespace {

template <int L, int TC, int MAXT, int MINB, int SR, bool REFILL>
__global__ void __launch_bounds__(MAXT, MINB) fused_ellip_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  Engine<L, TC, SR> e(p, smem);
  tp::run_lanes<L, REFILL>(e, p.k_max, p.check_every, p.exact_k, p.n_groups,
                           p.queue, p.fixed_iters);
}

// Rows a slab of the build that runs P threads at `lanes` lanes.
int slab_rows(int P, int lanes) {
  if (P > NARROW) return WIDE_SLAB;
  return lanes == 8 ? Build<8>::SR : lanes == 16 ? Build<16>::SR
                                                 : Build<32>::SR;
}

template <int L, bool REFILL>
int launch(const Params& p, int blocks, int threads, int smem, void* stream) {
  // up to NARROW columns the build of Build<L>; wider, one block of up to
  // MAX_COLS threads an SM (not at 32 lanes: its state does not fit)
  constexpr int TC = tp::tile_cols<L>();
  void (*kernel)(Params) = nullptr;
  if (threads <= NARROW)
    kernel = fused_ellip_kernel<L, TC, NARROW, Build<L>::MINB, Build<L>::SR,
                                REFILL>;
  else if constexpr (L < 32)
    kernel = fused_ellip_kernel<L, TC, MAX_COLS, 1, WIDE_SLAB, REFILL>;
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

// Dynamic shared bytes at `lanes` lanes a block for a slab of n columns
// (kernels/fused_ellip.py shared_bytes computes the same): the ring of M2's
// slabs, z, v and lam as [P][lanes], dq with its padding, the warps' row
// maxima, the masks, the window starts, the slots' lanes, the lanes' ball
// scales, the slab's staged differences and pinvh.
extern "C" long fused_ellip_smem(int P, int n, int lanes) {
  return tp::ring_bytes(P, slab_rows(P, lanes)) +
         4L * (P * (4L * lanes + tp::DQ_PAD) + (P / 32) * 2L * lanes + 4 +
               3L * lanes + 2L * n * (lanes + tp::DQ_PAD) + n * n);
}

// Launch on `stream` (a cudaStream_t). The geometry comes from the wrapper
// (kernels/fused_ellip.py launch_plan) and is checked here again: with
// refill (plain free-run and the checked mode) any number of persistent
// blocks up to one per L lanes, and `queue` 1 + blocks int32 zeros; else
// B / lanes blocks. Returns the CUDA error of the launch, as an int.
extern "C" int fused_ellip_launch(
    const float* z1, const float* v0, const float* lam0, const float* m2,
    const float* pinvh, const float* lb, const float* ub, const float* c,
    float* z, float* v, float* lam, int* k, int* done, float* rp, float* rd,
    float* snap, int* queue, int B, int nzp, int t0, int n, int lanes,
    int blocks, int threads, int smem, float rho, float rho_i, float r_ball,
    float tol_p, float tol_d, int k_max, int check_every, int fixed_iters,
    int exact_k, void* stream) {
  const bool fixed = fixed_iters > 0;
  const bool exact = check_every > 1 && exact_k && !fixed;
  const bool refill = TP_REFILL && !exact && !fixed;
  const int groups = B / 8, slots = lanes / 8;
  if (nzp <= 0 || nzp % 32 != 0 || nzp > MAX_COLS ||
      (lanes != 8 && lanes != 16 && lanes != 32) ||
      (lanes == 32 && nzp > NARROW) || B % 8 != 0 || threads != nzp ||
      n < 1 || n > 32 || t0 < 0 || t0 + n > nzp || t0 % 32 + n > 32 ||
      smem != fused_ellip_smem(nzp, n, lanes) || check_every < 1 ||
      k_max < 1 || (exact && B > 0 && snap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (refill ? (blocks < 1 || blocks > (groups + slots - 1) / slots ||
                queue == nullptr)
             : (B % lanes != 0 || blocks != B / lanes))
    return B == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Params p{z1,    v0,     lam0,  m2,          pinvh,       lb,
           ub,    c,      z,     v,           lam,         k,
           done,  rp,     rd,    snap,        queue,       groups,
           nzp,   t0,     n,     rho,         rho_i,       r_ball,
           tol_p, tol_d,  k_max, check_every, fixed_iters, exact_k};
  switch (lanes * 2 + (refill ? 1 : 0)) {
    case 16:
      return launch<8, false>(p, blocks, threads, smem, stream);
    case 17:
      return launch<8, true>(p, blocks, threads, smem, stream);
    case 32:
      return launch<16, false>(p, blocks, threads, smem, stream);
    case 33:
      return launch<16, true>(p, blocks, threads, smem, stream);
    case 64:
      return launch<32, false>(p, blocks, threads, smem, stream);
    default:
      return launch<32, true>(p, blocks, threads, smem, stream);
  }
}
#endif  // !WIDE_PART


#if WIDE_PART
// The wide build, a translation unit of its own (-DWIDE_PART=1;
// kernels/_build.py compiles the narrow builds above with -DWIDE_PART=0
// from exactly their text).
//
// Past MAX_COLS columns, up to tp::WIDE_COLS = 1024: fused_ellip_wide_kernel
// runs WideEngine, the narrow Engine on tp::WIDE_THREADS = 512 threads of
// tp::WIDE_CPT = 2 columns (t and t + 512, as the wide builds of K1, K5 and
// K7), at 16 or 8 lanes a block (kernels/stage.py WIDE_BUILDS). z, v and
// lam lie [P][L] in shared memory and dq [P][L + 4], with 16-row slabs of
// M2 at 16 lanes (up to 544 columns) and 8-row slabs at 8 (up to 1024);
// where the three leaves do not fit at 16 lanes (576 columns and more), v
// and lam lie in the block's global scratch in the same layout, 8-row slabs
// (the global leaves: only each column's own thread touches them, so they
// need no barrier, and the L2 bytes of M2 a lane halve against 8 lanes).
// M2's real rows, [0, t0 + n), come through the stage's TMA ring; the
// product's tiles are 8 lanes x TCW columns, TCW = max(TC, 2 L / 8), so
// that (L / 8) P / TCW <= 512 tiles cover the block's columns. The slab,
// columns t0 .. t0+n-1 inside one warp of columns, lies in one half of the
// threads' columns (past 512 columns the second: t0 = 514 at N=65, 1018 at
// N=128): its warp, the threads (t0 % 512) / 32 on their column of half
// t0 / 512, stages y - c' and its thread t takes lane t's ball, the squares
// added in slab order, and at a checked iteration maps lane t's slab
// differences back through pinvh and folds them into its warp's row maxima
// after the maxima over the thread's two columns, as the narrow build does.
// The modes are the stage's (tp::run_lanes): refill in the checked mode,
// plain free-run and exact-k (tp::run_refill_exact), fixed_iters in static
// blocks of L lanes; so every build gives the narrow builds' bits. The
// build before this one ran the first wide layout, at 8 lanes a block,
// with its state in global memory and M2 read from L2.

namespace {

// Dynamic shared bytes of a block at `lanes` lanes, slabs of `sr` rows and
// `leaves` leaves in shared memory, for a slab of n columns: the ring of
// M2's slabs, the leaves as [P][lanes], dq with its padding, the 16 warps'
// row maxima, the masks, the window starts, the slots' lanes, the lanes'
// ball scales, the slab's staged differences and pinvh.
long wide_bytes(int P, int n, int lanes, int sr, int leaves) {
  return tp::ring_bytes(P, sr) +
         4L * (leaves * P * lanes + P * (lanes + tp::DQ_PAD) +
               (tp::WIDE_THREADS / 32) * 2L * lanes + 4 + 3L * lanes +
               2L * n * (lanes + tp::DQ_PAD) + n * n);
}

// Whether v and lam go to global scratch: where the three leaves do not fit.
bool wide_global(int P, int n, int lanes) {
  return wide_bytes(P, n, lanes, tp::wide_slab(lanes), 3) > tp::SMEM_MAX;
}

// The wide kernels' parameters: the narrow ones, exact-k's window starts
// and links for refill, and the blocks' scratch of the global leaves.
struct WideParams : Params {
  int* wk;         // [B] window starts, [B / 8] links
  float* scratch;  // [blocks][2][P][L]: v, then lam
};

template <int L, int TC, int SR, bool GL>
struct WideEngine : Engine<L, TC, SR, tp::WIDE_CPT> {
  using Base = Engine<L, TC, SR, tp::WIDE_CPT>;
  using Base::ball;
  using Base::cj;
  using Base::G;
  using Base::jj;
  using Base::lam;
  using Base::lbj;
  using Base::p;
  using Base::pin;
  using Base::RS;
  using Base::rst;
  using Base::slab;
  using Base::slab_warp;
  using Base::ubj;
  using Base::v;
  using Base::z;
  float lb2, ub2, c2;  // the second column's
  int hs;              // the half of a thread's columns that holds the slab

  // The block as the narrow Engine sets it up, on blockDim.x threads: the
  // row maxima of its warps after dq, with GL v and lam in the block's rows
  // of `scratch` and dq right after z; slab, jj and slab_warp of the
  // thread's column of half hs.
  __device__ __forceinline__ WideEngine(const WideParams& p_, float* smem)
      : Base(p_, smem) {
    const int j = threadIdx.x;
    const int P = p.nzp, T = blockDim.x;
    this->tid = j;
    this->T = T;
    this->P = P;
    this->rwarps = T >> 5;
    this->lane0 = blockIdx.x * L;
    this->tol_p = p.tol_p;
    this->tol_d = p.tol_d;
    z = smem + tp::ring_bytes(P, SR) / 4;
    if constexpr (GL) {
      v = p_.scratch + static_cast<size_t>(blockIdx.x) * 2 * P * L;
      lam = v + P * L;
      this->dq = z + P * L;
    } else {
      v = z + P * L;
      lam = v + P * L;
      this->dq = lam + P * L;
    }
    this->red = this->dq + P * RS;
    this->ctrl =
        reinterpret_cast<unsigned*>(this->red + this->rwarps * 2 * L);
    this->sn_k = reinterpret_cast<int*>(this->ctrl + 4);
    this->orig = this->sn_k + L;
    ball = reinterpret_cast<float*>(this->orig + L);
    rst = ball + L;
    pin = rst + 2 * p.n * RS;
    this->leaf[0] = tp::Leaf{z, p.z1, p.z, P, 0};
    this->leaf[1] = tp::Leaf{v, p.v0, p.v, P, P};
    this->leaf[2] = tp::Leaf{lam, p.lam0, p.lam, P, 2 * P};
    this->snap = p.snap;
    this->snap_width = NSNAP * P;
    this->out = tp::LaneOut{p.k, p.done, p.rp, p.rd};
    hs = p.t0 / T;
    jj = this->row(hs) - p.t0;
    slab = jj >= 0 && jj < p.n;
    slab_warp = (j >> 5) == ((p.t0 % T) >> 5);
    const int j2 = this->row(1);
    lbj = j < P ? p.lb[j] : 0.0f;
    ubj = j < P ? p.ub[j] : 0.0f;
    cj = j < P ? p.c[j] : 0.0f;
    lb2 = j2 < P ? p.lb[j2] : 0.0f;
    ub2 = j2 < P ? p.ub[j2] : 0.0f;
    c2 = j2 < P ? p.c[j2] : 0.0f;
    // pinvh, published by the barrier after the lanes are read in
    for (int i = j; i < p.n * p.n; i += T) pin[i] = p.pinvh[i];
    // the product's rows: the real ones, [0, t0 + n)
    const int nr = p.t0 + p.n;
    tp::ring_init<SR>(this->ring, smem, p.m2, P, nr, nr, nr, j, T);
  }

  // Engine::iterate over the thread's columns: the residuals' maxima over
  // both columns (the slab column's put 0), then over the warp, then the
  // slab warp's mapped slab differences.
  template <bool CHECK>
  TP_ITERATE unsigned iterate(unsigned frozen, unsigned idle, unsigned last,
                              bool stop, unsigned rmask, int kinc) {
    this->tic();
    const unsigned dead = tp::whole_groups<L>(frozen | idle);
    const int P = p.nzp;
    if (slab_warp) ball_scales(dead);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float ap[8], ad[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) ap[b] = ad[b] = 0.0f;
#pragma unroll
      for (int c = 0; c < tp::WIDE_CPT; ++c) {
        const int j = this->row(c);
        if (j >= P) break;
        const float lb = c == 0 ? lbj : lb2;
        const float ub = c == 0 ? ubj : ub2;
        const float cc = c == 0 ? cj : c2;
        const bool sl = slab && c == hs;
        float zc[8], vp[8], lm[8], d[8], dp[8], dd[8];
        tp::ld8<L>(zc, z, j, g);
        tp::ld8<L>(vp, v, j, g);
        tp::ld8<L>(lm, lam, j, g);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const float y = zc[b] + p.rho_i * lm[b];
          const float vn = sl ? cc + ball[8 * g + b] * (y - cc)
                              : fminf(fmaxf(y, lb), ub);
          const float ln = lm[b] + p.rho * (zc[b] - vn);
          d[b] = p.rho * ((zc[b] - 2.0f * vn) + vp[b]);
          if (CHECK) {
            dp[b] = zc[b] - vn;
            dd[b] = vn - vp[b];
          }
          if (!bit(frozen, g * 8 + b)) {
            vp[b] = vn;
            lm[b] = ln;
          }
        }
        tp::st8_dq<L>(this->dq, j, g, d);
        tp::st8<L>(v, j, g, vp);
        tp::st8<L>(lam, j, g, lm);
        if (CHECK) {
          if (sl) {
            // mapped back and folded into the maxima below, lane by lane
            tp::st8_dq<L>(rst, jj, g, dp);
            tp::st8_dq<L>(rst + p.n * RS, jj, g, dd);
          } else {
#pragma unroll
            for (int b = 0; b < 8; ++b) {
              ap[b] = fmaxf(ap[b], fabsf(dp[b]));
              ad[b] = fmaxf(ad[b], fabsf(dd[b]));
            }
          }
        }
      }
      if (CHECK) {
        tp::warp_max<L>(ap, this->red, this->tid, 0, g);
        tp::warp_max<L>(ad, this->red, this->tid, 1, g);
      }
    }
    if (CHECK && slab_warp) this->slab_residuals(dead);
    return this->template product_half<CHECK>(dead, frozen, last, stop,
                                              rmask, kinc);
  }

  // Engine::ball_scales on the thread's column of half hs.
  __device__ __forceinline__ void ball_scales(unsigned dead) {
    const int j = this->row(hs);
    const float cc = hs == 0 ? cj : c2;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float zc[8], lm[8], yc[8];
      tp::ld8<L>(zc, z, j, g);
      tp::ld8<L>(lm, lam, j, g);
#pragma unroll
      for (int b = 0; b < 8; ++b) yc[b] = (zc[b] + p.rho_i * lm[b]) - cc;
      tp::st8_dq<L>(this->dq, j, g, yc);
    }
    __syncwarp();
    const int t = this->tid & 31;
    if (t < L && !bit(dead, t)) {
      const float* col = this->dq + p.t0 * RS + t;
      float q = 0.0f;
      for (int i = 0; i < p.n; ++i) {
        const float x = col[i * RS];
        const float sq = x * x;
        q = q + sq;
      }
      const float nrm = sqrtf(q);
      ball[t] = fminf(1.0f, p.r_ball / fmaxf(nrm, 1e-30f));
    }
    __syncwarp();
  }
};

template <int L, int TC, int SR, bool GL, bool REFILL, bool EXACT>
__global__ void __launch_bounds__(tp::WIDE_THREADS, 1)
    fused_ellip_wide_kernel(WideParams p) {
  extern __shared__ __align__(16) float smem[];
  WideEngine<L, TC, SR, GL> e(p, smem);
  tp::run_lanes<L, REFILL, EXACT>(e, p.k_max, p.check_every, p.exact_k,
                                  p.n_groups, p.queue, p.fixed_iters, p.wk);
}

template <int L, bool GL, bool REFILL, bool EXACT>
int wide_launch(const WideParams& p, int blocks, int smem, void* stream) {
  constexpr int SR = GL ? tp::WIDE_SLAB_8 : tp::wide_slab(L);
  void (*kernel)(WideParams) =
      fused_ellip_wide_kernel<L, tp::wide_tc<L>(), SR, GL, REFILL, EXACT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, tp::WIDE_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The build of a mode: static blocks (no refill: every mode, fixed_iters
// among them, through run_modes), refill in exact-k, refill in the checked
// mode and plain free-run.
template <int L, bool GL>
int wide_lanes(const WideParams& p, bool refill, bool exact, int blocks,
               int smem, void* stream) {
  if (!refill)
    return wide_launch<L, GL, false, false>(p, blocks, smem, stream);
  if (exact) return wide_launch<L, GL, true, true>(p, blocks, smem, stream);
  return wide_launch<L, GL, true, false>(p, blocks, smem, stream);
}

}  // namespace

// Dynamic shared bytes of a block of the wide build at `lanes` lanes for a
// slab of n columns (kernels/fused_ellip.py shared_bytes(P, n, lanes,
// wide=True) computes the same): wide_bytes with the three leaves, or with
// z alone and 8-row slabs where v and lam go to global scratch.
extern "C" long fused_ellip_wide_smem(int P, int n, int lanes) {
  return wide_global(P, n, lanes)
             ? wide_bytes(P, n, lanes, tp::WIDE_SLAB_8, 1)
             : wide_bytes(P, n, lanes, tp::wide_slab(lanes), 3);
}

// Launch the wide build on `stream`: the arguments of fused_ellip_launch,
// the window starts and links of exact-k with refill (`wk`, B + B / 8
// int32) and the global leaves (`scratch`, blocks x 2 nzp lanes floats
// where wide_global, else unused) after the queue, and `refill` after the
// lanes, with `threads` tp::WIDE_THREADS, `lanes` 8 or 16 and nzp up to
// tp::WIDE_COLS. With refill (every mode but fixed_iters) any number of
// persistent blocks up to one per L lanes; else B / lanes blocks. The
// geometry comes from the wrapper (kernels/fused_ellip.py launch_plan with
// wide=True) and is checked here again. Returns the CUDA error of the
// launch, as an int.
extern "C" int fused_ellip_wide_launch(
    const float* z1, const float* v0, const float* lam0, const float* m2,
    const float* pinvh, const float* lb, const float* ub, const float* c,
    float* z, float* v, float* lam, int* k, int* done, float* rp, float* rd,
    float* snap, int* queue, int* wk, float* scratch, int B, int nzp, int t0,
    int n, int lanes, int refill, int blocks, int threads, int smem,
    float rho, float rho_i, float r_ball, float tol_p, float tol_d,
    int k_max, int check_every, int fixed_iters, int exact_k,
    void* stream) {
  const bool fixed = fixed_iters > 0;
  const bool exact = check_every > 1 && exact_k && !fixed;
  const int groups = B / 8, slots = lanes / 8;
  if (nzp <= 0 || nzp % 32 != 0 || nzp > tp::WIDE_COLS ||
      (lanes != 8 && lanes != 16) || B % 8 != 0 ||
      threads != tp::WIDE_THREADS || n < 1 || n > 32 || t0 < 0 ||
      t0 + n > nzp || t0 % 32 + n > 32 ||
      smem != fused_ellip_wide_smem(nzp, n, lanes) || smem > tp::SMEM_MAX ||
      check_every < 1 || k_max < 1 || (refill && fixed) ||
      (lanes == 8 && wide_global(nzp, n, lanes)) ||
      (exact && B > 0 && snap == nullptr) ||
      (B > 0 && wide_global(nzp, n, lanes) && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (refill ? (blocks < 1 || blocks > (groups + slots - 1) / slots ||
                queue == nullptr || (exact && wk == nullptr))
             : (B % lanes != 0 || blocks != B / lanes))
    return B == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  WideParams p{};
  static_cast<Params&>(p) =
      Params{z1,    v0,     lam0,  m2,          pinvh,       lb,
             ub,    c,      z,     v,           lam,         k,
             done,  rp,     rd,    snap,        queue,       groups,
             nzp,   t0,     n,     rho,         rho_i,       r_ball,
             tol_p, tol_d,  k_max, check_every, fixed_iters, exact_k};
  p.wk = wk;
  p.scratch = scratch;
  if (lanes == 8)
    return wide_lanes<8, false>(p, refill, exact, blocks, smem, stream);
  if (wide_global(nzp, n, lanes))
    return wide_lanes<16, true>(p, refill, exact, blocks, smem, stream);
  return wide_lanes<16, false>(p, refill, exact, blocks, smem, stream);
}

#endif  // WIDE_PART
