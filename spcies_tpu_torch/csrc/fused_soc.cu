// Fused slack-SOC split ADMM for ellipMPC-ADMM-soc on NVIDIA Hopper
// (sm_90a), written by hand, on the product stage csrc/tile_product.cuh.
//
// Replaces the Pallas TPU kernel
// spcies_tpu/kernels/fused_soc.py::_fused_soc_kernel. It computes what that
// kernel computes, mode for mode (checked, free-run, exact-k with window
// replay): for every lane of the batch, in the layout [z (dim_p) | s (32)],
// the whole split loop
//
//     w      = aux + iscale lm
//     zs     = clip(w, LB, UB)                       on the z slab
//     zs     = SOC projection of w                   on the s slab
//              (nrm = sqrt(max(sum(w_s^2) - s0^2, 0)): inside -> w,
//               apex -> 0, else s0 -> (s0 + nrm)/2, tail -> tail (s0 +
//               nrm) / (2 max(nrm, 1e-30)))
//     lm'    = lm + scale (aux - zs)
//     dq     = (lm' - lm) - scale (zs - zs_old)      (the JAX kernel's order)
//     aux   += dq @ M1'
//     r_p    = max|aux - zs|, r_d = max|zs - zs_old|
//
// until the lane meets tol or k_max. The wrapper and the plain PyTorch
// version of every mode are in kernels/fused_soc.py. The one-column-per-
// thread kernel this design replaced is csrc/variants/fused_soc_parent.cu
// (tools/ab_kernels.py holds every build to it, bit for bit).
//
// Layout. A block of P = dim_p + 32 threads (288 at N=30), one per column,
// holds L = 8, 16 or 32 lanes (kernels/fused_soc.py pick_lanes); aux, zs
// and lm [P][L] and dq [P][L + 4] lie in shared memory (the layouts of
// csrc/tile_product.cuh). An iteration is
//   1. thread j forms zs, lm and dq of column j for the L lanes, 8 at a
//      time. The s slab is exactly the last warp. It stages w of its
//      columns in its rows of dq, and its thread t takes lane t's cone: the
//      squares of the cone's n + 1 entries added in column order, one after
//      the other, as the plain version adds them (a butterfly sum changes
//      the sum and missed the k bar), the norm and the tail's scale; then
//      each thread finishes its column from its lanes' results. Done as the
//      parent does it, each thread its column of all L lanes with the
//      squares broadcast by shuffles, the warp's four groups of serial sums
//      took 25 % of a 32-lane iteration, against 13 % (PERF.md;
//      SOC_SPREAD_CONE 0 builds it for a timing script);
//   2. the product stage: a thread owns 8 lanes x 4 columns of aux (8 x 1 at
//      L = 8); dq is exactly 0 on the pad columns (iscale = 0 there), so
//      only M1''s real rows come through the shared-memory ring filled by
//      TMA: those below the z slab's last real column and the s slab's first
//      n + 1 (248 of 288 at N=30), found from iscale by each block; after its
//      first barrier thread t < L (lane t's keeper) takes lane t's row
//      maxima and warp 0 publishes the converged lanes;
//   3. the tile's owner adds acc to aux, except on lanes that are frozen or
//      end here: a lane's aux stays the one it consumed at exit, the checked
//      and exact-k modes' output, so no copy of the consumed aux is kept.
// An iteration has one barrier a slab and one after step 3 (the parent: one
// barrier an iteration, dq and the row maxima double-buffered, two blocks
// an SM at 96 registers). Each L has its own build (Build below: rows a
// slab, blocks an SM).
//
// Plain free-run and the checked mode refill (csrc/tile_product.cuh,
// Refill): persistent blocks whose 8-lane slots take the next group of 8
// lanes from a queue once their group has ended. Exact-k keeps its block of
// L lanes, compacts the lanes still running and narrows the tiles.
//
// Bound. 2 (dim + n + 1)^2 FLOP an iteration and lane; each block re-reads
// M1''s real rows from L2 once an iteration for its L lanes.
//
// Arithmetic. fp32 on the CUDA cores, no TF32. The library is built with
// -fmad=false, so the element-wise steps (sqrtf and the division included)
// round as PyTorch's separate operations do; the product is an explicit
// fmaf chain over the rows in ascending order, as in the parent, so every
// build gives the parent's bits.
//
// Exact-k snapshots. At each window start aux, zs and lm of every lane not
// yet done go to global scratch (each thread writes, and later reads back,
// only its own column), and the window start to shared memory; the replay
// runs each lane's last window with the checked semantics and the budget
// min(C, k_max - kws).
//
// Padding. Pad columns carry zero rows and columns of M1', [0, 0] bounds on
// the z slab and iscale = 0, so they stay exactly 0 and add nothing to the
// row maxima.

#if !WIDE_PART
#include <cuda_runtime.h>

#include "tile_product.cuh"

// 1: the s warp stages its w through shared memory and each of its threads
// takes one lane's cone (its sum of squares, norm and scale); 0: each thread
// takes its column of every lane, the squares broadcast by shuffles
#ifndef SOC_SPREAD_CONE
#define SOC_SPREAD_CONE 1
#endif

// rows a slab of M1' and blocks an SM of each build up to NARROW columns
// (kernels/fused_soc.py BUILDS); a timing script may set others
#ifndef SOC_SLAB_8
#define SOC_SLAB_8 16
#endif
#ifndef SOC_BLOCKS_8
#define SOC_BLOCKS_8 2
#endif
#ifndef SOC_SLAB_16
#define SOC_SLAB_16 8
#endif
#ifndef SOC_BLOCKS_16
#define SOC_BLOCKS_16 2
#endif
#ifndef SOC_SLAB_32
#define SOC_SLAB_32 32
#endif
#ifndef SOC_BLOCKS_32
#define SOC_BLOCKS_32 1
#endif

namespace {

constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr int NARROW = 320;    // up to this width the builds of Build<L>
constexpr int WIDE_SLAB = 16;  // rows a slab above NARROW (8 and 16 lanes)
constexpr int NSNAP = 3;       // snapshot leaves (SNAP_LEAVES in the wrapper)
constexpr unsigned FULL = 0xffffffffu;

template <int L>
struct Build;
template <>
struct Build<8> {
  static constexpr int SR = SOC_SLAB_8, MINB = SOC_BLOCKS_8;
};
template <>
struct Build<16> {
  static constexpr int SR = SOC_SLAB_16, MINB = SOC_BLOCKS_16;
};
template <>
struct Build<32> {
  static constexpr int SR = SOC_SLAB_32, MINB = SOC_BLOCKS_32;
};

struct Params {
  const float* __restrict__ aux1;
  const float* __restrict__ zs0;
  const float* __restrict__ lm0;
  const float* __restrict__ m1p;     // [P][P], row-major, dq @ m1p
  const float* __restrict__ lb;      // [dim_p]
  const float* __restrict__ ub;      // [dim_p]
  const float* __restrict__ scale;   // [P]: sigma | rho
  const float* __restrict__ iscale;  // [P]: 1/sigma | 1/rho, 0 on pads
  float* zs;
  float* lm;
  float* aux;
  int* k;
  int* done;
  float* rp;
  float* rd;
  float* snap;   // exact-k: per lane [aux | zs | lm]
  int* queue;    // refill: [0] the next group, [1 + b] block b's
                 // iterations; zeroed by the wrapper
  int n_groups;  // B / 8
  int P, dim_p;
  float tol_p, tol_d;
  int k_max, check_every, exact_k;
};

using tp::bit;

// The block: the stage's engine over the leaves aux, zs, lm, and what
// thread j knows of its column.
template <int L, int TC, int SR>
struct Engine : tp::TileEngine<L, TC, SR, NSNAP> {
  static constexpr int G = L / 8;
  const Params& p;
  float *aux, *zs, *lm;
  float* cone_lane;  // [3][L]: each lane's s0 out, tail scale, case
  int n_s;  // the cone's entries, s_end - dim_p
  float lb, ub, scale, iscale;

  __device__ __forceinline__ Engine(const Params& p_, float* smem,
                                    int* bounds)
      : p(p_) {
    const int j = threadIdx.x;
    const int P = p.P;
    this->tid = j;
    this->T = P;
    this->P = P;
    this->rwarps = P >> 5;
    this->lane0 = blockIdx.x * L;
    this->tol_p = p.tol_p;
    this->tol_d = p.tol_d;
    float* a = smem + tp::ring_bytes(P, SR) / 4;
    aux = a;
    zs = aux + P * L;
    lm = zs + P * L;
    this->dq = lm + P * L;
    this->red = this->dq + P * (L + tp::DQ_PAD);
    this->ctrl = reinterpret_cast<unsigned*>(this->red + this->rwarps * 2 * L);
    this->sn_k = reinterpret_cast<int*>(this->ctrl + 4);
    this->orig = this->sn_k + L;
    cone_lane = reinterpret_cast<float*>(this->orig + L);
    // aux is the leaf the product adds to; the snapshot is [aux | zs | lm]
    this->leaf[0] = tp::Leaf{aux, p.aux1, p.aux, P, 0};
    this->leaf[1] = tp::Leaf{zs, p.zs0, p.zs, P, P};
    this->leaf[2] = tp::Leaf{lm, p.lm0, p.lm, P, 2 * P};
    this->snap = p.snap;
    this->snap_width = NSNAP * P;
    this->out = tp::LaneOut{p.k, p.done, p.rp, p.rd};
    scale = p.scale[j];
    iscale = p.iscale[j];
    lb = j < p.dim_p ? p.lb[j] : 0.0f;
    ub = j < p.dim_p ? p.ub[j] : 0.0f;
    // the product's row ranges: [0, z_end) and [dim_p, s_end)
    if (j == 0) {
      bounds[0] = 0;
      bounds[1] = p.dim_p;
    }
    __syncthreads();
    if (iscale != 0.0f) atomicMax(&bounds[j < p.dim_p ? 0 : 1], j + 1);
    __syncthreads();
    n_s = bounds[1] - p.dim_p;
    tp::ring_init<SR>(this->ring, smem, p.m1p, P, bounds[0], p.dim_p,
                      bounds[1], j, P);
  }

  // One iteration (tp::run_modes, tp::run_refill). Lanes in `frozen` keep
  // all their state; what `idle` lanes hold is never read again, and a group
  // of 8 lanes that are all frozen or idle is skipped; the lanes in `last`
  // (and, with stop, the lanes that converge here) keep the aux they
  // consumed. With CHECK, the keepers of the lanes in rmask record their
  // residuals and count kinc iterations, and the lanes whose residuals meet
  // tol are returned (identical in every thread of the block).
  template <bool CHECK>
  TP_ITERATE unsigned iterate(unsigned frozen, unsigned idle, unsigned last,
                              bool stop, unsigned rmask, int kinc) {
    const int j = this->tid;
    this->tic();
    const unsigned dead = tp::whole_groups<L>(frozen | idle);
    const bool s_slab = j >= p.dim_p;
    if (SOC_SPREAD_CONE && s_slab) spread_cone(dead);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float ax[8], zo[8], lo[8], zn[8];
      tp::ld8<L>(ax, aux, j, g);
      tp::ld8<L>(zo, zs, j, g);
      tp::ld8<L>(lo, lm, j, g);
      if (!s_slab) {
#pragma unroll
        for (int b = 0; b < 8; ++b)
          zn[b] = fminf(fmaxf(ax[b] + iscale * lo[b], lb), ub);
      } else if (SOC_SPREAD_CONE) {
        // each lane's case from spread_cone, on w staged in this row
        float w[8];
        tp::ld8_dq<L>(w, this->dq, j, g);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int lane = 8 * g + b;
          const float c = cone_lane[2 * L + lane];
          if (j == p.dim_p)
            zn[b] = cone_lane[lane];
          else
            zn[b] = c == 0.0f ? w[b]
                              : (c == 1.0f ? 0.0f : w[b] * cone_lane[L + lane]);
        }
      } else {
        // the s slab, one warp: SOC over [s0 | tail]; the squares of the
        // cone's n_s entries broadcast in turn and added in column order
        float w[8], sq[8], ss[8];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          w[b] = ax[b] + iscale * lo[b];
          sq[b] = w[b] * w[b];
          ss[b] = 0.0f;
        }
        for (int i = 0; i < n_s; ++i) {
#pragma unroll
          for (int b = 0; b < 8; ++b)
            ss[b] = ss[b] + __shfl_sync(FULL, sq[b], i);
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const float s0 = __shfl_sync(FULL, w[b], 0);
          const float nrm = sqrtf(fmaxf(ss[b] - s0 * s0, 0.0f));
          const bool inside = nrm <= s0;
          const bool apex = !inside && nrm <= -s0;
          const float coef = 0.5f * (s0 + nrm);
          if (j == p.dim_p)
            zn[b] = inside ? s0 : (apex ? 0.0f : coef);
          else
            zn[b] = inside ? w[b]
                           : (apex ? 0.0f : w[b] * (coef / fmaxf(nrm, 1e-30f)));
        }
      }
      float d[8], ap[8], ad[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const float lmn = lo[b] + scale * (ax[b] - zn[b]);
        const float dd = zn[b] - zo[b];
        d[b] = (lmn - lo[b]) - scale * dd;
        if (CHECK) {
          ap[b] = fabsf(ax[b] - zn[b]);
          ad[b] = fabsf(dd);
        }
        if (!bit(frozen, g * 8 + b)) {
          lo[b] = lmn;
          zo[b] = zn[b];
        }
      }
      tp::st8_dq<L>(this->dq, j, g, d);
      tp::st8<L>(zs, j, g, zo);
      tp::st8<L>(lm, j, g, lo);
      if (CHECK) {
        tp::warp_max<L>(ap, this->red, j, 0, g);
        tp::warp_max<L>(ad, this->red, j, 1, g);
      }
    }
    return this->template product_half<CHECK>(dead, frozen, last, stop,
                                              rmask, kinc);
  }

  // The s warp's cone, one lane a thread: the warp stages w = aux + iscale
  // lm of its columns in its rows of dq; thread t then adds lane t's squares
  // in column order, one after the other, and leaves the lane's s0 out, the
  // tail's scale coef / max(nrm, 1e-30) and its case (0 inside, 1 apex, 2
  // projected) in cone_lane.
  __device__ __forceinline__ void spread_cone(unsigned dead) {
    const int j = this->tid;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float ax[8], lo[8], w[8];
      tp::ld8<L>(ax, aux, j, g);
      tp::ld8<L>(lo, lm, j, g);
#pragma unroll
      for (int b = 0; b < 8; ++b) w[b] = ax[b] + iscale * lo[b];
      tp::st8_dq<L>(this->dq, j, g, w);
    }
    __syncwarp();
    const int t = j - p.dim_p;
    if (t < L && !bit(dead, t)) {
      const float* col = this->dq + p.dim_p * (L + tp::DQ_PAD) + t;
      const float s0 = col[0];
      float ss = 0.0f;
      for (int i = 0; i < n_s; ++i) {
        const float x = col[i * (L + tp::DQ_PAD)];
        const float sq = x * x;
        ss = ss + sq;
      }
      const float nrm = sqrtf(fmaxf(ss - s0 * s0, 0.0f));
      const bool inside = nrm <= s0;
      const bool apex = !inside && nrm <= -s0;
      const float coef = 0.5f * (s0 + nrm);
      cone_lane[t] = inside ? s0 : (apex ? 0.0f : coef);
      cone_lane[L + t] = coef / fmaxf(nrm, 1e-30f);
      cone_lane[2 * L + t] = inside ? 0.0f : (apex ? 1.0f : 2.0f);
    }
    __syncwarp();
  }
};

template <int L, int TC, int MAXT, int MINB, int SR, bool REFILL>
__global__ void __launch_bounds__(MAXT, MINB) fused_soc_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int bounds[2];  // z_end, s_end
  Engine<L, TC, SR> e(p, smem, bounds);
  tp::run_lanes<L, REFILL>(e, p.k_max, p.check_every, p.exact_k, p.n_groups,
                           p.queue);
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
    kernel = fused_soc_kernel<L, TC, NARROW, Build<L>::MINB, Build<L>::SR,
                              REFILL>;
  else if constexpr (L < 32)
    kernel = fused_soc_kernel<L, TC, MAX_COLS, 1, WIDE_SLAB, REFILL>;
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

// Dynamic shared bytes at `lanes` lanes a block (kernels/fused_soc.py
// shared_bytes computes the same): the ring of M1''s slabs, aux, zs and lm
// as [P][lanes], dq with its padding, the warps' row maxima, the masks, the
// window starts, the slots' lanes and the lanes' cones.
extern "C" long fused_soc_smem(int P, int lanes) {
  return tp::ring_bytes(P, slab_rows(P, lanes)) +
         4L * (P * (4L * lanes + tp::DQ_PAD) + (P / 32) * 2L * lanes + 4 +
               5L * lanes);
}

// Launch on `stream` (a cudaStream_t). The geometry comes from the wrapper
// (kernels/fused_soc.py launch_plan) and is checked here again: with refill
// (every mode but exact-k) any number of persistent blocks up to one per L
// lanes, and `queue` 1 + blocks int32 zeros; else B / lanes blocks. Returns
// the CUDA error of the launch, as an int.
extern "C" int fused_soc_launch(
    const float* aux1, const float* zs0, const float* lm0, const float* m1p,
    const float* lb, const float* ub, const float* scale,
    const float* iscale, float* zs, float* lm, float* aux, int* k,
    int* done, float* rp, float* rd, float* snap, int* queue, int B, int P,
    int dim_p, int lanes, int blocks, int threads, int smem, float tol_p,
    float tol_d, int k_max, int check_every, int exact_k, void* stream) {
  const bool exact = check_every > 1 && exact_k;
  const bool refill = TP_REFILL && !exact;
  const int groups = B / 8, slots = lanes / 8;
  if (P <= 0 || P % 32 != 0 || P > MAX_COLS || dim_p % 32 != 0 ||
      P - dim_p != 32 || (lanes != 8 && lanes != 16 && lanes != 32) ||
      (lanes == 32 && P > NARROW) || B % 8 != 0 || threads != P ||
      smem != fused_soc_smem(P, lanes) || check_every < 1 || k_max < 1 ||
      (exact && B > 0 && snap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (refill ? (blocks < 1 || blocks > (groups + slots - 1) / slots ||
                queue == nullptr)
             : (B % lanes != 0 || blocks != B / lanes))
    return B == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Params p{aux1,  zs0,    lm0,   m1p,  lb,    ub,    scale, iscale,
           zs,    lm,     aux,   k,    done,  rp,    rd,    snap,
           queue, groups, P,     dim_p, tol_p, tol_d, k_max, check_every,
           exact_k};
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
// kernels/_build.py compiles the narrow builds above with
// -DWIDE_PART=0 from exactly their earlier text).

#include <cuda_runtime.h>

#include "wide_cols.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---- the wide build ---------------------------------------------------------
//
// Past MAX_COLS columns, up to wc::COLS = 1024: fused_soc_wide_kernel runs
// 512 threads of two columns, t and t + 512, at 8 lanes a block, on the
// first layout (csrc/variants/fused_soc_parent.cu: one column a thread, M1'
// read from L2) with each thread taking two columns (csrc/wide_cols.cuh),
// so it gives this kernel's bits. The s slab is the last warp of columns,
// P - 32 .. P - 1: past 512 columns threads 480-511 own it as their second
// column, and its cone's sums stay shuffles within that warp, the squares
// added in column order. The state (aux, zs, lm and the consumed aux) lives
// in global memory that only its thread touches; shared memory holds dq
// ([2][P][8], by parity) and the row maxima. No refill: plain free-run
// drains each block, one group of 8 lanes.

using wc::TB;

// The element-wise half of the first layout's iteration for column j (the
// thread's column of half h): the clip on the z slab, the SOC on the s slab.
struct SocOp {
  float lb[wc::CPT], ub[wc::CPT], scale[wc::CPT], iscale[wc::CPT];
  int dim_p, n_s;

  template <bool CHECK>
  __device__ __forceinline__ void ew(const wc::Box& x, int h, int j,
                                     unsigned frozen, float* dq_s,
                                     float (&ap)[TB], float (&ad)[TB]) {
    float* st_aux = wc::box_leaf(x, wc::BX);
    float* st_zs = wc::box_leaf(x, wc::BA);
    float* st_lm = wc::box_leaf(x, wc::BB);
    const int o = j * TB;
    float aux[TB], zs[TB], lm[TB], zn[TB];
    wc::load(aux, st_aux + o);
    wc::load(zs, st_zs + o);
    wc::load(lm, st_lm + o);
    if (j < dim_p) {
#pragma unroll
      for (int b = 0; b < TB; ++b)
        zn[b] = fminf(fmaxf(aux[b] + iscale[h] * lm[b], lb[h]), ub[h]);
    } else {
      // the s slab, one warp: SOC over [s0 | tail]; the squares of the
      // cone's n_s entries broadcast in turn and added in column order
      float w[TB], sq[TB], ss[TB];
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        w[b] = aux[b] + iscale[h] * lm[b];
        sq[b] = w[b] * w[b];
        ss[b] = 0.0f;
      }
      for (int i = 0; i < n_s; ++i) {
#pragma unroll
        for (int b = 0; b < TB; ++b)
          ss[b] = ss[b] + __shfl_sync(FULL, sq[b], i);
      }
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const float s0 = __shfl_sync(FULL, w[b], 0);
        const float nrm = sqrtf(fmaxf(ss[b] - s0 * s0, 0.0f));
        const bool inside = nrm <= s0;
        const bool apex = !inside && nrm <= -s0;
        const float coef = 0.5f * (s0 + nrm);
        if (j == dim_p)
          zn[b] = inside ? s0 : (apex ? 0.0f : coef);
        else
          zn[b] = inside ? w[b]
                         : (apex ? 0.0f : w[b] * (coef / fmaxf(nrm, 1e-30f)));
      }
    }
    float dq[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float lmn = lm[b] + scale[h] * (aux[b] - zn[b]);
      const float dd = zn[b] - zs[b];
      dq[b] = (lmn - lm[b]) - scale[h] * dd;
      if (CHECK) {
        ap[b] = fmaxf(ap[b], fabsf(aux[b] - zn[b]));
        ad[b] = fmaxf(ad[b], fabsf(dd));
      }
      if (!wc::bit(frozen, b)) {
        lm[b] = lmn;
        zs[b] = zn[b];
      }
    }
    wc::store(dq_s + o, dq);
    wc::store(st_zs + o, zs);
    wc::store(st_lm + o, lm);
  }
};

__global__ void __launch_bounds__(wc::THREADS, 1)
    fused_soc_wide_kernel(wc::Box x, SocOp op, const float* lb,
                          const float* ub, const float* scale,
                          const float* iscale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int bounds[2];  // z_end, s_end
  const int dim_p = op.dim_p;
  x.dq = smem;
  x.red = smem + 2 * x.P * TB;
  if (threadIdx.x == 0) {
    bounds[0] = 0;
    bounds[1] = dim_p;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < wc::CPT; ++h) {
    const int j = wc::col(h, x.P);
    op.lb[h] = j >= 0 && j < dim_p ? lb[j] : 0.0f;
    op.ub[h] = j >= 0 && j < dim_p ? ub[j] : 0.0f;
    op.scale[h] = j < 0 ? 0.0f : scale[j];
    op.iscale[h] = j < 0 ? 0.0f : iscale[j];
    if (j >= 0 && op.iscale[h] != 0.0f)
      atomicMax(&bounds[j < dim_p ? 0 : 1], j + 1);
  }
  __syncthreads();
  x.r0 = 0;
  x.r1 = bounds[0];
  x.r2 = dim_p;
  x.r3 = bounds[1];
  op.n_s = bounds[1] - dim_p;
  wc::box_run<8>(x, op);
}

}  // namespace

// Dynamic shared bytes of a block of the wide build (kernels/fused_soc.py
// shared_bytes(P, wide=True) computes the same): dq as [2][P][8] and the
// warps' row maxima.
extern "C" long fused_soc_wide_smem(int P) { return wc::box_smem(P); }

// Launch the wide build on `stream`: the arguments of fused_soc_launch but
// the refill queue and the lanes, and `state`, the blocks' global state
// ([B / 8][4][P][8] floats). The geometry comes from the wrapper
// (kernels/fused_soc.py launch_plan with wide=True) and is checked here
// again. Returns the CUDA error of the launch, as an int.
extern "C" int fused_soc_wide_launch(
    const float* aux1, const float* zs0, const float* lm0, const float* m1p,
    const float* lb, const float* ub, const float* scale,
    const float* iscale, float* zs, float* lm, float* aux, int* k,
    int* done, float* rp, float* rd, float* snap, float* state, int B,
    int P, int dim_p, int blocks, int threads, int smem, float tol_p,
    float tol_d, int k_max, int check_every, int exact_k, void* stream) {
  const bool exact = check_every > 1 && exact_k;
  if (P <= 0 || P % 32 != 0 || P > wc::COLS || dim_p % 32 != 0 ||
      P - dim_p != 32 || B % TB != 0 || blocks != B / TB ||
      threads != wc::THREADS || smem != wc::box_smem(P) ||
      check_every < 1 || k_max < 1 ||
      (B > 0 && (state == nullptr || (exact && snap == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_soc_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wc::Box x{};
  x.st = state;
  x.m = m1p;
  x.in[0] = aux1;
  x.in[1] = zs0;
  x.in[2] = lm0;
  x.out[0] = aux;
  x.out[1] = zs;
  x.out[2] = lm;
  x.k = k;
  x.done = done;
  x.rp = rp;
  x.rd = rd;
  x.snap = snap;
  x.P = P;
  x.tol_p = tol_p;
  x.tol_d = tol_d;
  x.k_max = k_max;
  x.check_every = check_every;
  x.fixed_iters = 0;
  x.exact_k = exact_k;
  SocOp op{};
  op.dim_p = dim_p;
  fused_soc_wide_kernel<<<blocks, wc::THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x, op, lb, ub, scale, iscale);
  return static_cast<int>(cudaGetLastError());
}

#endif  // WIDE_PART
