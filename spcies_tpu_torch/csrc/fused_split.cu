// Fused two-block split (S)ADMM for HMPC-ADMM-split and HMPC-SADMM-split on
// NVIDIA Hopper (sm_90a), written by hand, on the product stage
// csrc/tile_product.cuh.
//
// Replaces the Pallas TPU kernel
// spcies_tpu/kernels/fused_split.py::_fused_split_kernel. It computes what
// that kernel computes, mode for mode (checked, free-run, exact-k with
// window replay): for every lane of the batch, in the layout [z (dim_p) |
// s], the whole split loop
//
//     lm_h   = lm + alpha scale (aux - zs_old)      (SADMM: the half-step
//                                                    with the previous (z,
//                                                    s), code_HMPC_ADMM_
//                                                    split_C.c:215-225)
//     w      = aux + iscale lm_h
//     zs     = clip(w, lb, ub)                      on the head columns
//     zs     = SOC, or diamond (a=+1 at lby, then a=-1 at uby), of each
//              cone's (y0, y1, y2)                  on the cone lanes
//     lm'    = lm_h + alpha scale (aux - zs)
//     dq     = (lm' - lm) - scale (zs - zs_old)      (the JAX kernel's order)
//     aux   += dq @ M1'
//     r_p    = max|aux - zs|, r_d = max|zs - zs_old|
//
// until the lane meets tol or k_max (alpha = 1 for ADMM). The wrapper and
// the plain PyTorch version of every mode are in kernels/fused_split.py.
// The one-column-per-thread kernel this design replaced is
// csrc/variants/fused_split_parent.cu (tools/ab_kernels.py holds every build
// to it, bit for bit).
//
// Layout. A block of P threads (320 at N=30: z 258 -> 288, one warp of 8
// cones) holds L = 8, 16 or 32 lanes (kernels/stage.py plan); the leaves
// aux, zs and lm [P][L] and dq [P][L + 4] lie in shared memory (the layouts
// of csrc/tile_product.cuh), on the stage's engine tp::TileEngine. An
// iteration is
//   1. thread j forms zs, lm and dq of column j for the L lanes, 8 at a
//      time: SADMM's half-step, the clip on the head columns (the harmonic
//      references free at +-3e38, the s slab's box rows in output mode) and
//      alpha in the dual update. The cones lie in whole warps from column
//      cone0, g <= 10 a warp, cone c's y0, y1, y2 at lanes c, g + c, 2g + c.
//      A cone warp leaves w in its rows of dq, and after a barrier every
//      thread of the block projects (cone, lane) pairs there, one a thread,
//      in _proj_ssoc_seg's blended form, as csrc/fused_hmpc.cu does; after a
//      second barrier the cone warps go on from the result (SP_SPREAD_CONES
//      0 builds the parent's way, each lane of a cone reading its cone's
//      entries by shuffles, for a timing script);
//   2. the product stage: a thread owns 8 lanes x 4 columns of aux (8 x 1
//      at L = 8), M1''s real rows come through the shared-memory ring
//      filled by TMA: dq is exactly 0 on the pad columns (iscale = 0 there),
//      so the product reads only the rows below the z slab's last real
//      column and from dim_p to the s slab's last real column (282 of 320 at
//      N=30), found from iscale by each block before its loop. After the
//      ring's first barrier thread t < L (lane t's keeper) takes lane t's
//      row maxima and warp 0 publishes the converged lanes;
//   3. the tile's owner adds acc to aux, except on lanes that are frozen or
//      end here: a lane's aux stays the one it consumed at exit, the checked
//      and exact-k modes' output, so no copy of the consumed aux is kept.
// Each L has its own build (Build below: rows a slab, blocks an SM).
//
// Refill in every mode (csrc/tile_product.cuh, Refill): persistent blocks
// whose 8-lane slots take the next group of 8 lanes from a queue once
// their group has ended. Exact-k opts in to the stage's run_refill_exact:
// windows with snapshots at each window start, then each block's replay of
// the groups it ran, in one launch. Built without refill (the wrapper's
// plan asks for it, for a check of bits), a block keeps its L lanes and
// exact-k compacts the lanes still running.
//
// Bound. 2 (dim + n_s)^2 FLOP an iteration and lane on the CUDA cores; each
// block re-reads M1''s real rows (282 x 320 at N=30, 361 KB) from L2 once
// an iteration for its L lanes.
//
// Arithmetic. fp32 on the CUDA cores, no TF32. The library is built with
// -fmad=false, so the element-wise steps (sqrtf and the division included)
// round as PyTorch's separate operations do; the product is an explicit
// fmaf chain over the rows in ascending order (the z rows, then the s rows),
// as in the parent, and a cone's projection takes the same values in the
// same order wherever it runs, so every build gives the parent's bits.
//
// Exact-k snapshots. At each window start aux, zs and lm of every lane not
// yet done go to global scratch (each thread writes, and later reads back,
// only its own rows), and the window start to global memory (with refill)
// or shared memory; the replay runs each lane's last window with the
// checked semantics and the budget min(C, k_max - kws).
//
// Padding. Pad columns carry zero rows and columns of M1', [0, 0] bounds
// and iscale = 0, so they stay exactly 0 (a pad cone slot projects a zero
// triple onto zero) and add nothing to the row maxima.

#include <cuda_runtime.h>

#include "tile_product.cuh"

// 1: the cones' projections are spread over the block's threads, one (cone,
// lane) a thread; 0: each cone warp projects its own cones, lane by lane
#ifndef SP_SPREAD_CONES
#define SP_SPREAD_CONES 1
#endif

// rows a slab of M1' and blocks an SM of each build up to NARROW columns
// (kernels/fused_split.py BUILDS); a timing script may set others
#ifndef SP_SLAB_8
#define SP_SLAB_8 16
#endif
#ifndef SP_BLOCKS_8
#define SP_BLOCKS_8 2
#endif
#ifndef SP_SLAB_16
#define SP_SLAB_16 8
#endif
#ifndef SP_BLOCKS_16
#define SP_BLOCKS_16 2
#endif
#ifndef SP_SLAB_32
#define SP_SLAB_32 16
#endif
#ifndef SP_BLOCKS_32
#define SP_BLOCKS_32 1
#endif

namespace {

constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr int NARROW = 320;    // up to this width the builds of Build<L>
constexpr int WIDE_SLAB = 16;  // rows a slab above NARROW (8 and 16 lanes)
constexpr int MAX_G = 10;      // cones a warp (MAX_CONES_PER_WARP)
constexpr int NSNAP = 3;       // snapshot leaves (SNAP_LEAVES in the wrapper)
constexpr unsigned FULL = 0xffffffffu;

template <int L>
struct Build;
template <>
struct Build<8> {
  static constexpr int SR = SP_SLAB_8, MINB = SP_BLOCKS_8;
};
template <>
struct Build<16> {
  static constexpr int SR = SP_SLAB_16, MINB = SP_BLOCKS_16;
};
template <>
struct Build<32> {
  static constexpr int SR = SP_SLAB_32, MINB = SP_BLOCKS_32;
};

struct Params {
  const float* __restrict__ aux1;
  const float* __restrict__ zs0;
  const float* __restrict__ lm0;
  const float* __restrict__ m1p;     // [P][P], row-major, dq @ m1p
  const float* __restrict__ lb;      // [P]: clip bounds, a cone's lby
  const float* __restrict__ ub;      // [P]: clip bounds, a cone's uby
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
  int* wk;       // exact-k with refill: [B] window starts, [B / 8] links
  int n_groups;  // B / 8
  int P, dim_p, cone0, cone_g, symmetric, use_soc;
  float alpha, tol_p, tol_d;
  int k_max, check_every, exact_k;
};

using tp::bit;

// Projection onto {||(y1, y2)|| <= a (y0 - dd)}, a in {-1, +1}, in
// _proj_ssoc_seg's blended form (as csrc/fused_hmpc.cu).
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

// The block: the stage's engine over the leaves aux, zs, lm, and what thread
// j knows of its column (its first, j, in the wide build's CPT = 2: none
// past P; WideEngine then lays out what follows dq for its 16 warps).
template <int L, int TC, int SR, int CPT = 1>
struct Engine : tp::TileEngine<L, TC, SR, 3, CPT> {
  static constexpr int G = L / 8;
  const Params& p;
  float *aux, *zs, *lm;
  bool cone_warp;  // j in a warp of cones
  bool cone;       // j holds an entry of a cone (lane < 3g)
  int src, seg;    // the lane of its cone's y0; which entry it holds
  float lb, ub, scale, iscale, as;

  __device__ __forceinline__ Engine(const Params& p_, float* smem,
                                    int* bounds)
      : p(p_) {
    const int j = threadIdx.x;
    const int P = p.P;
    this->tid = j;
    this->T = blockDim.x;
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
    this->leaf[0] = tp::Leaf{aux, p.aux1, p.aux, P, 0};
    this->leaf[1] = tp::Leaf{zs, p.zs0, p.zs, P, P};
    this->leaf[2] = tp::Leaf{lm, p.lm0, p.lm, P, 2 * P};
    this->snap = p.snap;
    this->snap_width = NSNAP * P;
    this->out = tp::LaneOut{p.k, p.done, p.rp, p.rd};
    if constexpr (CPT == 1) {
      scale = p.scale[j];
      iscale = p.iscale[j];
      as = p.alpha * scale;
      lb = p.lb[j];
      ub = p.ub[j];
    } else {
      scale = j < P ? p.scale[j] : 0.0f;
      iscale = j < P ? p.iscale[j] : 0.0f;
      as = p.alpha * scale;
      lb = j < P ? p.lb[j] : 0.0f;
      ub = j < P ? p.ub[j] : 0.0f;
    }
    cone_warp = j >= p.cone0;
    const int lane = j & 31;
    cone = cone_warp && lane < 3 * p.cone_g;
    seg = lane / p.cone_g;
    src = lane % p.cone_g;
    // the product's row ranges: [0, z_end) and [dim_p, s_end)
    if (j == 0) {
      bounds[0] = 0;
      bounds[1] = p.dim_p;
    }
    __syncthreads();
    if constexpr (CPT == 1) {
      if (iscale != 0.0f) atomicMax(&bounds[j < p.dim_p ? 0 : 1], j + 1);
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int jc = this->row(c);
        if (jc < P && p.iscale[jc] != 0.0f)
          atomicMax(&bounds[jc < p.dim_p ? 0 : 1], jc + 1);
      }
    }
    __syncthreads();
    tp::ring_init<SR>(this->ring, smem, p.m1p, P, bounds[0], p.dim_p,
                      bounds[1], j, this->T);
  }

  // The half-step and w of column j for group g, from its aux, zs, lm.
  __device__ __forceinline__ void half(const float (&ax)[8],
                                       const float (&zo)[8],
                                       const float (&lo)[8], float (&lh)[8],
                                       float (&w)[8]) const {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      lh[b] = p.symmetric ? lo[b] + as * (ax[b] - zo[b]) : lo[b];
      w[b] = ax[b] + iscale * lh[b];
    }
  }

  // One iteration (tp::run_modes, tp::run_refill, tp::run_refill_exact).
  // Lanes in `frozen` keep all their state; what `idle` lanes hold is never
  // read again, and a group of 8 lanes that are all frozen or idle is
  // skipped; the lanes in `last` (and, with stop, the lanes that converge
  // here) keep the aux they consumed. With CHECK, the keepers of the lanes
  // in rmask record their residuals and count kinc iterations, and the
  // lanes whose residuals meet tol are returned (identical in every thread
  // of the block).
  template <bool CHECK>
  TP_ITERATE unsigned iterate(unsigned frozen, unsigned idle, unsigned last,
                              bool stop, unsigned rmask, int kinc) {
    const int j = this->tid;
    this->tic();
    const unsigned dead = tp::whole_groups<L>(frozen | idle);
    if (SP_SPREAD_CONES) {
      // the cone warps leave w in their rows of dq; every thread projects
      // (cone, lane) pairs there; the cone warps then go on from the result
      if (cone_warp) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (bit(dead, 8 * g)) continue;
          float ax[8], zo[8], lo[8], lh[8], w[8];
          tp::ld8<L>(ax, aux, j, g);
          tp::ld8<L>(zo, zs, j, g);
          tp::ld8<L>(lo, lm, j, g);
          half(ax, zo, lo, lh, w);
          tp::st8_dq<L>(this->dq, j, g, w);
        }
      }
      __syncthreads();
      project_cones(dead);
      __syncthreads();
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float ax[8], zo[8], lo[8], lh[8], w[8], zn[8];
      tp::ld8<L>(ax, aux, j, g);
      tp::ld8<L>(zo, zs, j, g);
      tp::ld8<L>(lo, lm, j, g);
      half(ax, zo, lo, lh, w);
      if (SP_SPREAD_CONES && cone_warp) {
        tp::ld8_dq<L>(zn, this->dq, j, g);   // projected, or w off a cone
        if (!cone) {
#pragma unroll
          for (int b = 0; b < 8; ++b) zn[b] = fminf(fmaxf(zn[b], lb), ub);
        }
      } else if (!SP_SPREAD_CONES && cone_warp) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          float y0 = __shfl_sync(FULL, w[b], src);
          float y1 = __shfl_sync(FULL, w[b], src + p.cone_g);
          float y2 = __shfl_sync(FULL, w[b], src + 2 * p.cone_g);
          project(y0, y1, y2, lb, ub);
          const float v = seg == 0 ? y0 : (seg == 1 ? y1 : y2);
          zn[b] = cone ? v : fminf(fmaxf(w[b], lb), ub);
        }
      } else {
#pragma unroll
        for (int b = 0; b < 8; ++b) zn[b] = fminf(fmaxf(w[b], lb), ub);
      }
      float d[8], ap[8], ad[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const float lmn = lh[b] + as * (ax[b] - zn[b]);
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

  // SOC, or the diamond with the cone's D-set bounds lb, ub
  __device__ __forceinline__ void project(float& y0, float& y1, float& y2,
                                          float lo_, float hi_) const {
    if (p.use_soc) {
      proj_ssoc(y0, y1, y2, 1.0f, 0.0f);
    } else {
      proj_ssoc(y0, y1, y2, 1.0f, lo_);
      proj_ssoc(y0, y1, y2, -1.0f, hi_);
    }
  }

  // Every (cone, lane) pair of the groups not in `dead`, one a thread: the
  // cone's (y0, y1, y2) in its three rows of dq, projected in place; the
  // bounds are those of the cone's y0 column, which its three columns
  // share.
  __device__ __forceinline__ void project_cones(unsigned dead) {
    const int slots = ((p.P - p.cone0) >> 5) * p.cone_g;
    for (int t = this->tid; t < slots * L; t += this->T) {
      const int b = t % L;
      if (bit(dead, b)) continue;
      const int c = t / L;
      const int c0 = p.cone0 + 32 * (c / p.cone_g) + c % p.cone_g;
      float* w0 = this->dq + c0 * (L + tp::DQ_PAD) + b;
      float* w1 = w0 + p.cone_g * (L + tp::DQ_PAD);
      float* w2 = w1 + p.cone_g * (L + tp::DQ_PAD);
      float y0 = *w0, y1 = *w1, y2 = *w2;
      project(y0, y1, y2, __ldg(p.lb + c0), __ldg(p.ub + c0));
      *w0 = y0;
      *w1 = y1;
      *w2 = y2;
    }
  }
};

}  // namespace

#if !WIDE_PART
namespace {

template <int L, int TC, int MAXT, int MINB, int SR, bool REFILL, bool EXACT>
__global__ void __launch_bounds__(MAXT, MINB) fused_split_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int bounds[2];  // z_end, s_end
  Engine<L, TC, SR> e(p, smem, bounds);
  tp::run_lanes<L, REFILL, EXACT>(e, p.k_max, p.check_every, p.exact_k,
                                  p.n_groups, p.queue, 0, p.wk);
}

// Rows a slab of the build that runs `width` threads at `lanes` lanes.
int slab_rows(int width, int lanes) {
  if (width > NARROW) return WIDE_SLAB;
  return lanes == 8 ? Build<8>::SR : lanes == 16 ? Build<16>::SR
                                                 : Build<32>::SR;
}

template <int L, bool REFILL, bool EXACT>
int launch(const Params& p, int blocks, int threads, int smem, void* stream) {
  // up to NARROW columns the build of Build<L>; wider, one block of up to
  // MAX_COLS threads an SM (not at 32 lanes: its state does not fit)
  constexpr int TC = tp::tile_cols<L>();
  void (*kernel)(Params) = nullptr;
  if (threads <= NARROW)
    kernel = fused_split_kernel<L, TC, NARROW, Build<L>::MINB, Build<L>::SR,
                                REFILL, EXACT>;
  else if constexpr (L < 32)
    kernel = fused_split_kernel<L, TC, MAX_COLS, 1, WIDE_SLAB, REFILL,
                                EXACT>;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The build of `lanes` lanes a block, with refill or without; exact-k
// refills through the stage's run_refill_exact.
template <int L>
int launch_lanes(const Params& p, bool refill, bool exact, int blocks,
                 int threads, int smem, void* stream) {
  if (!refill) return launch<L, false, false>(p, blocks, threads, smem, stream);
  if (exact) return launch<L, true, true>(p, blocks, threads, smem, stream);
  return launch<L, true, false>(p, blocks, threads, smem, stream);
}

}  // namespace

// Dynamic shared bytes at `lanes` lanes a block (kernels/fused_split.py
// shared_bytes computes the same): the ring of M1''s slabs, aux, zs and lm
// as [P][lanes], dq with its padding, the warps' row maxima, the masks, the
// window starts and the slots' lanes.
extern "C" long fused_split_smem(int P, int lanes) {
  return tp::ring_bytes(P, slab_rows(P, lanes)) +
         4L * (3L * P * lanes + P * (lanes + static_cast<long>(tp::DQ_PAD)) +
               (P / 32) * 2L * lanes + 4 + 2L * lanes);
}

// Launch on `stream` (a cudaStream_t). The geometry comes from the wrapper
// (kernels/fused_split.py launch_plan) and is checked here again: with
// refill any number of persistent blocks up to one per L lanes, and `queue`
// 1 + 3 blocks int32 zeros (and, in exact-k, `wk` B + B / 8 int32); else
// B / lanes blocks. Returns the CUDA error of the launch, as an int.
extern "C" int fused_split_launch(
    const float* aux1, const float* zs0, const float* lm0, const float* m1p,
    const float* lb, const float* ub, const float* scale,
    const float* iscale, float* zs, float* lm, float* aux, int* k,
    int* done, float* rp, float* rd, float* snap, int* queue, int* wk,
    int B, int P, int dim_p, int cone0, int cone_g, int symmetric,
    int use_soc, int lanes, int refill, int blocks, int threads, int smem,
    float alpha, float tol_p, float tol_d, int k_max, int check_every,
    int exact_k, void* stream) {
  const bool exact = check_every > 1 && exact_k;
  const int groups = B / 8, slots = lanes / 8;
  if (P <= 0 || P % 32 != 0 || P > MAX_COLS || dim_p <= 0 ||
      dim_p % 32 != 0 || cone0 < dim_p || cone0 % 32 != 0 || cone0 >= P ||
      cone_g < 1 || cone_g > MAX_G ||
      (lanes != 8 && lanes != 16 && lanes != 32) ||
      (lanes == 32 && P > NARROW) || B % 8 != 0 || threads != P ||
      smem != fused_split_smem(P, lanes) || check_every < 1 || k_max < 1 ||
      (exact && B > 0 && snap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (refill ? (blocks < 1 || blocks > (groups + slots - 1) / slots ||
                queue == nullptr || (exact && wk == nullptr))
             : (B % lanes != 0 || blocks != B / lanes))
    return B == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Params p{aux1,   zs0,    lm0,   m1p,   lb,      ub,     scale, iscale,
           zs,     lm,     aux,   k,     done,    rp,     rd,    snap,
           queue,  wk,     groups, P,    dim_p,   cone0,  cone_g,
           symmetric, use_soc, alpha, tol_p, tol_d, k_max, check_every,
           exact_k};
  switch (lanes) {
    case 8:
      return launch_lanes<8>(p, refill, exact, blocks, threads, smem, stream);
    case 16:
      return launch_lanes<16>(p, refill, exact, blocks, threads, smem,
                              stream);
    default:
      return launch_lanes<32>(p, refill, exact, blocks, threads, smem,
                              stream);
  }
}
#endif  // !WIDE_PART

#if WIDE_PART
// The wide build, a translation unit of its own (-DWIDE_PART=1;
// kernels/_build.py compiles the narrow builds above with -DWIDE_PART=0
// from exactly their text).
//
// Past MAX_COLS columns, up to tp::WIDE_COLS = 1024: fused_split_wide_kernel
// runs WideEngine, the narrow Engine on tp::WIDE_THREADS = 512 threads of
// tp::WIDE_CPT = 2 columns (t and t + 512, as K1's wide build in
// csrc/fused_admm.cu), at 16 or 8 lanes a block (kernels/stage.py
// WIDE_BUILDS). aux, zs and lm lie
// [P][L] in shared memory and dq [P][L + 4], with 16-row slabs of M1' at 16
// lanes (up to 544 columns) and 8-row slabs at 8 (up to 1024); where the
// three leaves do not fit at 16 lanes (576 columns and more), zs and lm lie
// in the block's global scratch in the same layout, 8-row slabs (the global
// leaves: only each column's own thread touches them, in the element-wise
// half and the moves of a lane group's state, so they need no barrier, and
// the L2 bytes of M1' a lane halve against 8 lanes). M1''s real rows come
// through the stage's TMA ring; the product's tiles are 8 lanes x TCW
// columns, TCW = max(TC, 2 L / 8), so that (L / 8) P / TCW <= 512 tiles
// cover the block's columns (narrower tiles
// once only the first group is live ask for fewer). An iteration is the
// narrow build's: the cone columns leave w in their rows of dq, every thread
// projects (cone, lane) pairs after a barrier (K6's spread cones), then each
// thread forms zs, lm and dq of each of its columns, the residuals' maxima
// over its columns and the block's 16 warps. The modes and refill in every
// mode are the stage's (tp::run_lanes), as the narrow builds run them, so
// every build gives the narrow builds' bits. The build before this one ran
// the first wide layout (8 lanes a block, M1' read from L2), with its
// state in global memory.

namespace {

// Dynamic shared bytes of a block at `lanes` lanes, slabs of `sr` rows and
// `leaves` leaves in shared memory: the ring of M1''s slabs, the leaves as
// [P][lanes], dq with its padding, the 16 warps' row maxima, the masks, the
// window starts and the slots' lanes.
long wide_bytes(int P, int lanes, int sr, int leaves) {
  return tp::ring_bytes(P, sr) +
         4L * (leaves * P * lanes + P * (lanes + tp::DQ_PAD) +
               (tp::WIDE_THREADS / 32) * 2L * lanes + 4 + 2L * lanes);
}

// Whether zs and lm go to global scratch: where the three leaves do not fit.
bool wide_global(int P, int lanes) {
  return wide_bytes(P, lanes, tp::wide_slab(lanes), 3) > tp::SMEM_MAX;
}

// The wide kernels' parameters: the narrow ones and the blocks' scratch of
// the global leaves ([blocks][2][P][L], zs then lm).
struct WideParams : Params {
  float* scratch;
};

template <int L, int TC, int SR, bool GL>
struct WideEngine : Engine<L, TC, SR, tp::WIDE_CPT> {
  using Base = Engine<L, TC, SR, tp::WIDE_CPT>;
  using Base::G;
  using Base::aux;
  using Base::lm;
  using Base::p;
  using Base::zs;
  float lb2, ub2, scale2, iscale2;  // the second column's

  // The row maxima of the block's warps after dq; with GL, zs and lm in the
  // block's rows of `scratch`, dq right after aux.
  __device__ __forceinline__ WideEngine(const WideParams& p_, float* smem,
                                        int* bounds)
      : Base(p_, smem, bounds) {
    const int P = p.P;
    if constexpr (GL) {
      zs = p_.scratch + static_cast<size_t>(blockIdx.x) * 2 * P * L;
      lm = zs + P * L;
      this->leaf[1].sh = zs;
      this->leaf[2].sh = lm;
      this->dq = aux + P * L;
    }
    this->rwarps = this->T >> 5;
    this->red = this->dq + P * (L + tp::DQ_PAD);
    this->ctrl = reinterpret_cast<unsigned*>(this->red + this->rwarps * 2 * L);
    this->sn_k = reinterpret_cast<int*>(this->ctrl + 4);
    this->orig = this->sn_k + L;
    const int j = this->row(1);
    const bool has = j < p.P;
    lb2 = has ? p.lb[j] : 0.0f;
    ub2 = has ? p.ub[j] : 0.0f;
    scale2 = has ? p.scale[j] : 0.0f;
    iscale2 = has ? p.iscale[j] : 0.0f;
  }

  // Engine::half for the thread's c-th column.
  __device__ __forceinline__ void half(int c, const float (&ax)[8],
                                       const float (&zo)[8],
                                       const float (&lo)[8], float (&lh)[8],
                                       float (&w)[8]) const {
    const float as = c == 0 ? this->as : p.alpha * scale2;
    const float is = c == 0 ? this->iscale : iscale2;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      lh[b] = p.symmetric ? lo[b] + as * (ax[b] - zo[b]) : lo[b];
      w[b] = ax[b] + is * lh[b];
    }
  }

  // Engine::iterate over the thread's columns.
  template <bool CHECK>
  TP_ITERATE unsigned iterate(unsigned frozen, unsigned idle, unsigned last,
                              bool stop, unsigned rmask, int kinc) {
    this->tic();
    const unsigned dead = tp::whole_groups<L>(frozen | idle);
    const int P = p.P;
    // the cone columns leave w in their rows of dq; every thread projects
    // (cone, lane) pairs there; the cone columns then go on from the result
#pragma unroll
    for (int c = 0; c < tp::WIDE_CPT; ++c) {
      const int j = this->row(c);
      if (j >= P) break;
      if (j < p.cone0) continue;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (bit(dead, 8 * g)) continue;
        float ax[8], zo[8], lo[8], lh[8], w[8];
        tp::ld8<L>(ax, aux, j, g);
        tp::ld8<L>(zo, zs, j, g);
        tp::ld8<L>(lo, lm, j, g);
        half(c, ax, zo, lo, lh, w);
        tp::st8_dq<L>(this->dq, j, g, w);
      }
    }
    __syncthreads();
    this->project_cones(dead);
    __syncthreads();
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
        const float lb = c == 0 ? this->lb : lb2;
        const float ub = c == 0 ? this->ub : ub2;
        const float scale = c == 0 ? this->scale : scale2;
        const float as = c == 0 ? this->as : p.alpha * scale2;
        const bool cone_warp = j >= p.cone0;
        const bool cone = cone_warp && (j & 31) < 3 * p.cone_g;
        float ax[8], zo[8], lo[8], lh[8], w[8], zn[8];
        tp::ld8<L>(ax, aux, j, g);
        tp::ld8<L>(zo, zs, j, g);
        tp::ld8<L>(lo, lm, j, g);
        half(c, ax, zo, lo, lh, w);
        if (cone_warp) {
          tp::ld8_dq<L>(zn, this->dq, j, g);   // projected, or w off a cone
          if (!cone) {
#pragma unroll
            for (int b = 0; b < 8; ++b) zn[b] = fminf(fmaxf(zn[b], lb), ub);
          }
        } else {
#pragma unroll
          for (int b = 0; b < 8; ++b) zn[b] = fminf(fmaxf(w[b], lb), ub);
        }
        float d[8];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const float lmn = lh[b] + as * (ax[b] - zn[b]);
          const float dd = zn[b] - zo[b];
          d[b] = (lmn - lo[b]) - scale * dd;
          if (CHECK) {
            ap[b] = fmaxf(ap[b], fabsf(ax[b] - zn[b]));
            ad[b] = fmaxf(ad[b], fabsf(dd));
          }
          if (!bit(frozen, g * 8 + b)) {
            lo[b] = lmn;
            zo[b] = zn[b];
          }
        }
        tp::st8_dq<L>(this->dq, j, g, d);
        tp::st8<L>(zs, j, g, zo);
        tp::st8<L>(lm, j, g, lo);
      }
      if (CHECK) {
        tp::warp_max<L>(ap, this->red, this->tid, 0, g);
        tp::warp_max<L>(ad, this->red, this->tid, 1, g);
      }
    }
    return this->template product_half<CHECK>(dead, frozen, last, stop,
                                              rmask, kinc);
  }
};

template <int L, int TC, int SR, bool GL, bool REFILL, bool EXACT>
__global__ void __launch_bounds__(tp::WIDE_THREADS, 1)
    fused_split_wide_kernel(WideParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int bounds[2];  // z_end, s_end
  WideEngine<L, TC, SR, GL> e(p, smem, bounds);
  tp::run_lanes<L, REFILL, EXACT>(e, p.k_max, p.check_every, p.exact_k,
                                  p.n_groups, p.queue, 0, p.wk);
}

template <int L, bool GL, bool REFILL, bool EXACT>
int wide_launch(const WideParams& p, int blocks, int smem, void* stream) {
  constexpr int SR = GL ? tp::WIDE_SLAB_8 : tp::wide_slab(L);
  void (*kernel)(WideParams) =
      fused_split_wide_kernel<L, tp::wide_tc<L>(), SR, GL, REFILL, EXACT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, tp::WIDE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

template <int L, bool GL>
int wide_lanes(const WideParams& p, bool refill, bool exact, int blocks,
               int smem, void* stream) {
  if (!refill)
    return wide_launch<L, GL, false, false>(p, blocks, smem, stream);
  if (exact) return wide_launch<L, GL, true, true>(p, blocks, smem, stream);
  return wide_launch<L, GL, true, false>(p, blocks, smem, stream);
}

}  // namespace

// Dynamic shared bytes of a block of the wide build at `lanes` lanes
// (kernels/fused_split.py shared_bytes(P, lanes, wide=True) computes the
// same): wide_bytes with the three leaves, or with aux alone and 8-row
// slabs where zs and lm go to global scratch.
extern "C" long fused_split_wide_smem(int P, int lanes) {
  return wide_global(P, lanes) ? wide_bytes(P, lanes, tp::WIDE_SLAB_8, 1)
                               : wide_bytes(P, lanes, tp::wide_slab(lanes), 3);
}

// Launch the wide build on `stream`: the arguments of fused_split_launch
// and `scratch`, the global leaves (blocks x 2 P lanes floats where
// wide_global, else unused), with `threads` tp::WIDE_THREADS, `lanes` 8 or 16
// and P up to tp::WIDE_COLS. The geometry comes from the wrapper
// (kernels/fused_split.py launch_plan with wide=True) and is checked here
// again. Returns the CUDA error of the launch, as an int.
extern "C" int fused_split_wide_launch(
    const float* aux1, const float* zs0, const float* lm0, const float* m1p,
    const float* lb, const float* ub, const float* scale,
    const float* iscale, float* zs, float* lm, float* aux, int* k,
    int* done, float* rp, float* rd, float* snap, int* queue, int* wk,
    float* scratch, int B, int P, int dim_p, int cone0, int cone_g,
    int symmetric,
    int use_soc, int lanes, int refill, int blocks, int threads, int smem,
    float alpha, float tol_p, float tol_d, int k_max, int check_every,
    int exact_k, void* stream) {
  const bool exact = check_every > 1 && exact_k;
  const int groups = B / 8, slots = lanes / 8;
  if (P <= 0 || P % 32 != 0 || P > tp::WIDE_COLS || dim_p <= 0 ||
      dim_p % 32 != 0 || cone0 < dim_p || cone0 % 32 != 0 || cone0 >= P ||
      cone_g < 1 || cone_g > MAX_G || (lanes != 8 && lanes != 16) ||
      B % 8 != 0 || threads != tp::WIDE_THREADS ||
      smem != fused_split_wide_smem(P, lanes) || smem > tp::SMEM_MAX ||
      check_every < 1 || k_max < 1 || (exact && B > 0 && snap == nullptr) ||
      (B > 0 && wide_global(P, lanes) && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (refill ? (blocks < 1 || blocks > (groups + slots - 1) / slots ||
                queue == nullptr || (exact && wk == nullptr))
             : (B % lanes != 0 || blocks != B / lanes))
    return B == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  WideParams p{};
  static_cast<Params&>(p) =
      Params{aux1,   zs0,    lm0,   m1p,   lb,      ub,     scale, iscale,
             zs,     lm,     aux,   k,     done,    rp,     rd,    snap,
             queue,  wk,     groups, P,    dim_p,   cone0,  cone_g,
             symmetric, use_soc, alpha, tol_p, tol_d, k_max, check_every,
             exact_k};
  p.scratch = scratch;
  if (lanes == 8)
    return wide_lanes<8, false>(p, refill, exact, blocks, smem, stream);
  if (wide_global(P, lanes))
    return wide_lanes<16, true>(p, refill, exact, blocks, smem, stream);
  return wide_lanes<16, false>(p, refill, exact, blocks, smem, stream);
}

#endif  // WIDE_PART
