// Fused single-split cone ADMM for HMPC-ADMM and ellipHMPC-ADMM on NVIDIA
// Hopper (sm_90a), written by hand, on the product stage
// csrc/tile_product.cuh.
//
// Replaces the Pallas TPU kernel
// spcies_tpu/kernels/fused_hmpc.py::_fused_hmpc_kernel (with its
// _proj_ssoc_seg). It computes what that kernel computes, mode for mode
// (checked, free-run, exact-k with window replay): for every lane of the
// batch, with z [dim_p] and s, lam [ns_p], the whole loop
//
//     czd  = z @ CT - d
//     y    = -czd - rho^-1 lam
//     s    = clip(y, lb, ub)                      on the box rows
//     s    = SOC, or diamond (a=+1 at lby, then a=-1 at uby), of each
//            cone's (y0, y1, y2)                  on the cone lanes
//     lam += rho (czd + s)
//     w    = rho (s - s_old) + rho (czd + s)
//     z   += w @ MC                               (MC = C M1')
//     r_p  = max|czd + s|, r_d = max|s - s_old|
//
// until the lane meets tol or k_max. The wrapper and the plain PyTorch
// version of every mode are in kernels/fused_hmpc.py. The one-column-per-
// thread kernel this design replaced is csrc/variants/fused_hmpc_parent.cu
// (tools/ab_kernels.py holds every build to it, bit for bit).
//
// Layout. A block of max(dim_p, ns_p) threads (288 at N=30) holds L = 8, 16
// or 32 lanes (kernels/fused_hmpc.py pick_lanes); z [dim_p][L], s and lam
// [ns_p][L] and w [ns_p][L + 4] lie in shared memory (the layouts of
// csrc/tile_product.cuh). An iteration is
//   1. thread j < ns_p forms czd, s, lam and w of column j for the L lanes,
//      8 at a time: czd as a chain over the rows of CT column j that can be
//      nonzero (one row on a box column, the harmonic rows on a cone
//      column; found once, CT read by __ldg), z read from shared memory.
//      The cones lie in whole warps from column cone0, g <= 10 a warp, cone
//      c's y0, y1, y2 at lanes c, g + c, 2g + c. A cone warp leaves y in its
//      rows of w, and after a barrier every thread of the block projects
//      (cone, lane) pairs there, one a thread, in _proj_ssoc_seg's blended
//      form; after a second barrier the cone warps go on from the result.
//      (The parent's way, each lane of a cone reading its cone's entries by
//      shuffles and projecting them itself, puts all L lanes' projections
//      on one warp while the others wait: at L = 32 it took 44 % of an
//      iteration, against 15 % spread (PERF.md); HM_SPREAD_CONES 0 builds
//      it for a timing script);
//   2. the product stage: a thread owns 8 lanes x 4 columns of z (8 x 1 at
//      L = 8), MC's real rows ([0, box_end) and [cone0, s_end), 258 of 288
//      at N=30) come through the shared-memory ring filled by TMA; after its
//      first barrier thread t < L (lane t's keeper) takes lane t's row
//      maxima and warp 0 publishes the converged lanes;
//   3. the tile's owner adds acc to z, except on lanes that are frozen or
//      end here: a lane's z stays the one it consumed at exit, the checked
//      and exact-k modes' output, so no copy of the consumed z is kept.
// The parent's two barriers an iteration (one after each half) give way to
// the ring's barrier a slab, which publishes w, the barrier after step 3,
// which orders z before the next czd, and the two around the projections.
// The parent ran three blocks an SM at 64 registers with about 1 KB of
// spills; here each L has its own build (Build below: rows a slab, blocks
// an SM).
//
// Plain free-run and the checked mode refill (csrc/tile_product.cuh,
// Refill): persistent blocks whose 8-lane slots take the next group of 8
// lanes from a queue once their group has ended, so a wide block does not
// run to its slowest group. Exact-k keeps its block of L lanes, compacts the
// lanes still running and narrows the tiles.
//
// Bound. 2 n_s dim FLOP an iteration and lane for w @ MC and 2 nnz(C) for
// z @ CT. Each block re-reads MC's real rows from L2 once an iteration for
// its L lanes.
//
// Arithmetic. fp32 on the CUDA cores, no TF32: z is an O(1) operand of the
// first product, where a truncated product would floor the residual near
// 1e-3 (the JAX kernel pins it to HIGHEST). The library is built with
// -fmad=false, so the element-wise steps (sqrtf and the division included)
// round as PyTorch's separate operations do; both products are explicit
// fmaf chains over the rows in ascending order, as in the parent, so every
// build gives the parent's bits.
//
// Exact-k snapshots. At each window start z, s and lam of every lane not
// yet done go to global scratch (each thread writes, and later reads back,
// only its own rows), and the window start to shared memory; the replay
// runs each lane's last window with the checked semantics and the budget
// min(C, k_max - kws).
//
// Padding. Pad columns carry zero rows and columns of CT and MC, d = 0 and
// [0, 0] bounds; a pad cone slot projects a zero triple onto zero. So pad
// state stays exactly 0 and adds nothing to the row maxima.

#if !WIDE_PART
#include <cuda_runtime.h>

#include "tile_product.cuh"

// 1: the cones' projections are spread over the block's threads, one (cone,
// lane) a thread; 0: each cone warp projects its own cones, lane by lane
#ifndef HM_SPREAD_CONES
#define HM_SPREAD_CONES 1
#endif

// rows a slab of MC and blocks an SM of each build up to NARROW columns
// (kernels/fused_hmpc.py BUILDS); a timing script may set others
#ifndef HM_SLAB_8
#define HM_SLAB_8 16
#endif
#ifndef HM_BLOCKS_8
#define HM_BLOCKS_8 2
#endif
#ifndef HM_SLAB_16
#define HM_SLAB_16 8
#endif
#ifndef HM_BLOCKS_16
#define HM_BLOCKS_16 2
#endif
#ifndef HM_SLAB_32
#define HM_SLAB_32 32
#endif
#ifndef HM_BLOCKS_32
#define HM_BLOCKS_32 1
#endif

namespace {

constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr int NARROW = 320;    // up to this width the builds of Build<L>
constexpr int WIDE_SLAB = 16;  // rows a slab above NARROW (8 and 16 lanes)
constexpr int MAX_G = 10;      // cones a warp (MAX_CONES_PER_WARP)
constexpr unsigned FULL = 0xffffffffu;

template <int L>
struct Build;
template <>
struct Build<8> {
  static constexpr int SR = HM_SLAB_8, MINB = HM_BLOCKS_8;
};
template <>
struct Build<16> {
  static constexpr int SR = HM_SLAB_16, MINB = HM_BLOCKS_16;
};
template <>
struct Build<32> {
  static constexpr int SR = HM_SLAB_32, MINB = HM_BLOCKS_32;
};

struct Params {
  const float* __restrict__ z1;
  const float* __restrict__ s0;
  const float* __restrict__ lam0;
  const float* __restrict__ ct;  // [dim_p][ns_p], row-major, z @ ct
  const float* __restrict__ mc;  // [ns_p][dim_p], row-major, w @ mc
  const float* __restrict__ d;   // [ns_p]
  const float* __restrict__ lb;  // [ns_p]: box bounds, a cone's lby
  const float* __restrict__ ub;  // [ns_p]: box bounds, a cone's uby
  float* z;
  float* s;
  float* lam;
  int* k;
  int* done;
  float* rp;
  float* rd;
  float* snap;  // exact-k: per lane [z (dim_p) | s (ns_p) | lam (ns_p)]
  int* queue;   // refill: [0] the next group, [1 + b] block b's
                // iterations; zeroed by the wrapper
  int n_groups;  // B / 8
  int dim_p, ns_p, cone0, cone_g, use_soc;
  float rho, rho_i, tol_p, tol_d;
  int k_max, check_every, exact_k;
};

using tp::bit;

// Projection onto {||(y1, y2)|| <= a (y0 - dd)}, a in {-1, +1}, in
// _proj_ssoc_seg's blended form.
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

// The block: the stage's engine over the leaves z, s, lam, and what thread
// j knows of its s column.
template <int L, int TC, int SR>
struct Engine : tp::TileEngine<L, TC, SR, 3> {
  static constexpr int G = L / 8;
  const Params& p;
  float *z, *s, *lam;
  bool has_s;      // j < ns_p
  bool cone_warp;  // j in a warp of cones
  bool cone;       // j holds an entry of a cone (lane < 3g)
  int src, seg;    // the lane of its cone's y0; which entry it holds
  int lo, hi;      // the rows of CT column j that can be nonzero
  float d, lb, ub;

  __device__ __forceinline__ Engine(const Params& p_, float* smem,
                                    int* bounds)
      : p(p_) {
    const int j = threadIdx.x;
    this->tid = j;
    this->T = blockDim.x;
    this->P = p.dim_p;
    this->rwarps = p.ns_p >> 5;
    this->lane0 = blockIdx.x * L;
    this->tol_p = p.tol_p;
    this->tol_d = p.tol_d;
    float* a = smem + tp::ring_bytes(p.dim_p, SR) / 4;
    z = a;
    s = z + p.dim_p * L;
    lam = s + p.ns_p * L;
    this->dq = lam + p.ns_p * L;
    this->red = this->dq + p.ns_p * (L + tp::DQ_PAD);
    this->ctrl = reinterpret_cast<unsigned*>(this->red + this->rwarps * 2 * L);
    this->sn_k = reinterpret_cast<int*>(this->ctrl + 4);
    this->orig = this->sn_k + L;
    this->leaf[0] = tp::Leaf{z, p.z1, p.z, p.dim_p, 0};
    this->leaf[1] = tp::Leaf{s, p.s0, p.s, p.ns_p, p.dim_p};
    this->leaf[2] = tp::Leaf{lam, p.lam0, p.lam, p.ns_p, p.dim_p + p.ns_p};
    this->snap = p.snap;
    this->snap_width = p.dim_p + 2 * p.ns_p;
    this->out = tp::LaneOut{p.k, p.done, p.rp, p.rd};
    has_s = j < p.ns_p;
    cone_warp = has_s && j >= p.cone0;
    const int lane = j & 31;
    cone = cone_warp && lane < 3 * p.cone_g;
    seg = lane / p.cone_g;
    src = lane % p.cone_g;
    d = has_s ? p.d[j] : 0.0f;
    lb = has_s ? p.lb[j] : 0.0f;
    ub = has_s ? p.ub[j] : 0.0f;
    lo = 0;
    hi = 0;
    if (has_s) {
      // the first and last nonzero of CT column j
      for (int i = 0; i < p.dim_p; ++i) {
        if (p.ct[static_cast<size_t>(i) * p.ns_p + j] != 0.0f) {
          if (hi == 0) lo = i;
          hi = i + 1;
        }
      }
    }
    // the product's row ranges: [0, box_end) and [cone0, s_end)
    if (j == 0) {
      bounds[0] = 0;
      bounds[1] = p.cone0;
    }
    __syncthreads();
    if (hi > lo) atomicMax(&bounds[j < p.cone0 ? 0 : 1], j + 1);
    __syncthreads();
    tp::ring_init<SR>(this->ring, smem, p.mc, p.dim_p, bounds[0], p.cone0,
                      bounds[1], j, this->T);
  }

  // One iteration (tp::run_modes, tp::run_refill). Lanes in `frozen` keep
  // all their state; what `idle` lanes hold is never read again, and a group
  // of 8 lanes that are all frozen or idle is skipped; the lanes in `last`
  // (and, with stop, the lanes that converge here) keep the z they
  // consumed. With CHECK, the keepers of the lanes in rmask record their
  // residuals and count kinc iterations, and the lanes whose residuals meet
  // tol are returned (identical in every thread of the block).
  template <bool CHECK>
  TP_ITERATE unsigned iterate(unsigned frozen, unsigned idle, unsigned last,
                              bool stop, unsigned rmask, int kinc) {
    const int j = this->tid;
    this->tic();
    const unsigned dead = tp::whole_groups<L>(frozen | idle);
    float czd[G][8];
    if (has_s) {
      // czd = z @ CT - d over CT column j's rows that can be nonzero
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int b = 0; b < 8; ++b) czd[g][b] = 0.0f;
      }
      for (int i = lo; i < hi; ++i) {
        const float ct = __ldg(p.ct + static_cast<size_t>(i) * p.ns_p + j);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (bit(dead, 8 * g)) continue;
          float zv[8];
          tp::ld8<L>(zv, z, i, g);
#pragma unroll
          for (int b = 0; b < 8; ++b) czd[g][b] = fmaf(zv[b], ct, czd[g][b]);
        }
      }
    }
    if (HM_SPREAD_CONES) {
      // the cone warps leave y in their rows of w; every thread projects
      // (cone, lane) pairs there; the cone warps then go on from the result
      if (cone_warp) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (bit(dead, 8 * g)) continue;
          float lm[8], y[8];
          tp::ld8<L>(lm, lam, j, g);
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            czd[g][b] = czd[g][b] - d;
            y[b] = -czd[g][b] - p.rho_i * lm[b];
          }
          tp::st8_dq<L>(this->dq, j, g, y);
        }
      }
      __syncthreads();
      project_cones(dead);
      __syncthreads();
    }
    if (has_s) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (bit(dead, 8 * g)) continue;
        if (HM_SPREAD_CONES && cone_warp) {
          float sn[8];
          tp::ld8_dq<L>(sn, this->dq, j, g);   // projected, or y off a cone
          if (!cone) {
#pragma unroll
            for (int b = 0; b < 8; ++b) sn[b] = fminf(fmaxf(sn[b], lb), ub);
          }
          update<CHECK>(g, j, czd[g], sn, frozen);
          continue;
        }
        float lm[8], y[8], sn[8];
        tp::ld8<L>(lm, lam, j, g);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          czd[g][b] = czd[g][b] - d;
          y[b] = -czd[g][b] - p.rho_i * lm[b];
        }
        if (!HM_SPREAD_CONES && cone_warp) {
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            float y0 = __shfl_sync(FULL, y[b], src);
            float y1 = __shfl_sync(FULL, y[b], src + p.cone_g);
            float y2 = __shfl_sync(FULL, y[b], src + 2 * p.cone_g);
            project(y0, y1, y2, lb, ub);
            const float v = seg == 0 ? y0 : (seg == 1 ? y1 : y2);
            sn[b] = cone ? v : fminf(fmaxf(y[b], lb), ub);
          }
        } else {
#pragma unroll
          for (int b = 0; b < 8; ++b) sn[b] = fminf(fmaxf(y[b], lb), ub);
        }
        update<CHECK>(g, j, czd[g], sn, frozen);
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
  // cone's (y0, y1, y2) in its three rows of w, projected in place; the
  // bounds are those of the cone's y0 column, which its three columns
  // share.
  __device__ __forceinline__ void project_cones(unsigned dead) {
    const int slots = ((p.ns_p - p.cone0) >> 5) * p.cone_g;
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

  // The rest of column j's half for group g, from its czd and s: lam, s,
  // w into the row of dq, the residuals' maxima.
  template <bool CHECK>
  __device__ __forceinline__ void update(int g, int j, const float (&cz)[8],
                                         const float (&sn)[8],
                                         unsigned frozen) {
    float lm[8], sv[8], w[8], ap[8], ad[8];
    tp::ld8<L>(lm, lam, j, g);
    tp::ld8<L>(sv, s, j, g);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float resid = cz[b] + sn[b];
      const float ds = sn[b] - sv[b];
      w[b] = p.rho * ds + p.rho * resid;
      if (CHECK) {
        ap[b] = fabsf(resid);
        ad[b] = fabsf(ds);
      }
      if (!bit(frozen, g * 8 + b)) {
        lm[b] = lm[b] + p.rho * resid;
        sv[b] = sn[b];
      }
    }
    tp::st8_dq<L>(this->dq, j, g, w);
    tp::st8<L>(s, j, g, sv);
    tp::st8<L>(lam, j, g, lm);
    if (CHECK) {
      tp::warp_max<L>(ap, this->red, j, 0, g);
      tp::warp_max<L>(ad, this->red, j, 1, g);
    }
  }
};

template <int L, int TC, int MAXT, int MINB, int SR, bool REFILL>
__global__ void __launch_bounds__(MAXT, MINB) fused_hmpc_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int bounds[2];  // box_end, s_end
  Engine<L, TC, SR> e(p, smem, bounds);
  tp::run_lanes<L, REFILL>(e, p.k_max, p.check_every, p.exact_k, p.n_groups,
                           p.queue);
}

// Rows a slab of the build that runs `width` threads at `lanes` lanes.
int slab_rows(int width, int lanes) {
  if (width > NARROW) return WIDE_SLAB;
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
    kernel = fused_hmpc_kernel<L, TC, NARROW, Build<L>::MINB, Build<L>::SR,
                               REFILL>;
  else if constexpr (L < 32)
    kernel = fused_hmpc_kernel<L, TC, MAX_COLS, 1, WIDE_SLAB, REFILL>;
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

// Dynamic shared bytes at `lanes` lanes a block (kernels/fused_hmpc.py
// shared_bytes computes the same): the ring of MC's slabs, z, s and lam as
// [rows][lanes], w with its padding, the warps' row maxima, the masks, the
// window starts and the slots' lanes.
extern "C" long fused_hmpc_smem(int dim_p, int ns_p, int lanes) {
  const int width = dim_p > ns_p ? dim_p : ns_p;
  return tp::ring_bytes(dim_p, slab_rows(width, lanes)) +
         4L * (dim_p * static_cast<long>(lanes) + 2L * ns_p * lanes +
               ns_p * (lanes + static_cast<long>(tp::DQ_PAD)) +
               (ns_p / 32) * 2L * lanes + 4 + 2L * lanes);
}

// Launch on `stream` (a cudaStream_t). The geometry comes from the wrapper
// (kernels/fused_hmpc.py launch_plan) and is checked here again: with refill
// (every mode but exact-k) any number of persistent blocks up to one per L
// lanes, and `queue` 1 + blocks int32 zeros; else B / lanes blocks. Returns
// the CUDA error of the launch, as an int.
extern "C" int fused_hmpc_launch(
    const float* z1, const float* s0, const float* lam0, const float* ct,
    const float* mc, const float* d, const float* lb, const float* ub,
    float* z, float* s, float* lam, int* k, int* done, float* rp, float* rd,
    float* snap, int* queue, int B, int dim_p, int ns_p, int cone0,
    int cone_g, int use_soc, int lanes, int blocks, int threads, int smem,
    float rho, float rho_i, float tol_p, float tol_d, int k_max,
    int check_every, int exact_k, void* stream) {
  const bool exact = check_every > 1 && exact_k;
  const bool refill = TP_REFILL && !exact;
  const int width = dim_p > ns_p ? dim_p : ns_p;
  const int groups = B / 8, slots = lanes / 8;
  if (dim_p <= 0 || dim_p % 32 != 0 || dim_p > MAX_COLS || ns_p <= 0 ||
      ns_p % 32 != 0 || ns_p > MAX_COLS || cone0 < 0 || cone0 % 32 != 0 ||
      cone0 >= ns_p || cone_g < 1 || cone_g > MAX_G ||
      (lanes != 8 && lanes != 16 && lanes != 32) ||
      (lanes == 32 && width > NARROW) || B % 8 != 0 || threads != width ||
      smem != fused_hmpc_smem(dim_p, ns_p, lanes) || check_every < 1 ||
      k_max < 1 || (exact && B > 0 && snap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (refill ? (blocks < 1 || blocks > (groups + slots - 1) / slots ||
                queue == nullptr)
             : (B % lanes != 0 || blocks != B / lanes))
    return B == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Params p{z1,    s0,     lam0,  ct,     mc,      d,     lb,    ub,
           z,     s,      lam,   k,      done,    rp,    rd,    snap,
           queue, groups, dim_p, ns_p,   cone0,   cone_g, use_soc,
           rho,   rho_i,  tol_p, tol_d,  k_max,   check_every, exact_k};
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

constexpr int MAX_G = 10;  // cones a warp (MAX_CONES_PER_WARP)
constexpr unsigned FULL = 0xffffffffu;
using wc::proj_ssoc;

// ---- the wide build ---------------------------------------------------------
//
// Past MAX_COLS columns of either width, up to wc::COLS = 1024:
// fused_hmpc_wide_kernel runs 512 threads, at 8 lanes a block, on the first
// layout (csrc/variants/fused_hmpc_parent.cu: one column a thread, CT and MC
// read from L2) with each thread taking two columns of each width, t and
// t + 512 (csrc/wide_cols.cuh): s columns t and t + 512 in czd's product
// and the element-wise half, z columns t and t + 512 in MC's product. The
// two widths may pass 512 at different N: each product's threads cover its
// own width. The cones keep their layout, whole warps from cone0, and a
// warp of cones (32 columns) lies in one half of a thread's s columns,
// whose 32 threads run its shuffles together. Shared memory holds what
// every thread reads: the prepared z (czd's input) and w (MC's input) as
// [columns][8], and the row maxima; the consumed z, s and lam live in
// global memory that only their thread touches. So the per-column sums are
// the first layout's and the kernel gives this kernel's bits. No refill:
// plain free-run drains each block, one group of 8 lanes.

using wc::TB;

struct HmpcWide {
  const float* __restrict__ z1;
  const float* __restrict__ s0;
  const float* __restrict__ lam0;
  const float* __restrict__ ct;  // [dim_p][ns_p], czd = z @ ct - d
  const float* __restrict__ mc;  // [ns_p][dim_p], z += w @ mc
  const float* __restrict__ d;
  const float* __restrict__ lb;
  const float* __restrict__ ub;
  float* z;
  float* s;
  float* lam;
  int* k;
  int* done;
  float* rp;
  float* rd;
  float* snap;   // exact-k: per lane [z (dim_p) | s (ns_p) | lam (ns_p)]
  float* state;  // [blocks][dim_p + 2 ns_p][8]: the consumed z, s, lam
  int dim_p, ns_p, cone0, cone_g, use_soc;
  float rho, rho_i, tol_p, tol_d;
  int k_max, check_every, exact_k;
};

// What a thread knows of its s columns (h = 0, 1) and of the block.
struct HmpcCols {
  float d[wc::CPT], lb[wc::CPT], ub[wc::CPT];
  int lo[wc::CPT], hi[wc::CPT];  // the rows of CT column j that can be
                                 // nonzero
  int box_end, s_end;            // MC rows read: [0, box_end), [cone0, s_end)
  float* zn;                     // shared: [dim_p][8], the prepared z
  float* w;                      // shared: [ns_p][8]
  float* red;                    // shared: [WARPS][2][8]
  float* zc;                     // global: [dim_p][8], the consumed z
  float* sv;                     // global: [ns_p][8]
  float* lam;                    // global: [ns_p][8]
};

// One iteration of the thread's columns for the block's 8 lanes, as the
// first layout's iterate: lanes in `frozen` keep all their state; with
// CHECK, returns the lanes whose residuals meet tol, and thread 0 records
// the residuals of the lanes in `rmask` in lres.
template <bool CHECK>
__device__ __forceinline__ unsigned hmpc_wide_iterate(
    const HmpcWide& p, const HmpcCols& c, unsigned frozen, unsigned rmask,
    float (&lres)[2][TB]) {
  float ap[TB], ad[TB];
  wc::zero(ap);
  wc::zero(ad);
#pragma unroll
  for (int h = 0; h < wc::CPT; ++h) {
    const int j = wc::col(h, p.ns_p);
    if (j < 0) break;
    const int o = j * TB;
    const int lane = j & 31;
    const bool cone_warp = j >= p.cone0;
    const bool cone = cone_warp && lane < 3 * p.cone_g;
    const int seg = lane / p.cone_g, src = lane % p.cone_g;
    float czd[TB], y[TB], sn[TB];
    wc::zero(czd);
    wc::product<8>(c.zn, p.ct, p.ns_p, c.lo[h], c.hi[h], j, czd);
    {
      float lam[TB];
      wc::load(lam, c.lam + o);
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        czd[b] = czd[b] - c.d[h];
        y[b] = -czd[b] - p.rho_i * lam[b];
      }
    }
    if (cone_warp) {
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        float y0 = __shfl_sync(FULL, y[b], src);
        float y1 = __shfl_sync(FULL, y[b], src + p.cone_g);
        float y2 = __shfl_sync(FULL, y[b], src + 2 * p.cone_g);
        if (p.use_soc) {
          proj_ssoc(y0, y1, y2, 1.0f, 0.0f);
        } else {
          proj_ssoc(y0, y1, y2, 1.0f, c.lb[h]);
          proj_ssoc(y0, y1, y2, -1.0f, c.ub[h]);
        }
        const float v = seg == 0 ? y0 : (seg == 1 ? y1 : y2);
        sn[b] = cone ? v : fminf(fmaxf(y[b], c.lb[h]), c.ub[h]);
      }
    } else {
#pragma unroll
      for (int b = 0; b < TB; ++b)
        sn[b] = fminf(fmaxf(y[b], c.lb[h]), c.ub[h]);
    }
    float sv[TB], lam[TB], w[TB], rp[TB], rd[TB];
    wc::load(sv, c.sv + o);
    wc::load(lam, c.lam + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float resid = czd[b] + sn[b];
      const float ds = sn[b] - sv[b];
      w[b] = p.rho * ds + p.rho * resid;
      rp[b] = resid;
      rd[b] = ds;
      if (!wc::bit(frozen, b)) {
        lam[b] = lam[b] + p.rho * resid;
        sv[b] = sn[b];
      }
    }
    wc::store(c.w + o, w);
    wc::store(c.sv + o, sv);
    wc::store(c.lam + o, lam);
    if (CHECK) {
      wc::max_abs(ap, rp);
      wc::max_abs(ad, rd);
    }
  }
  if (CHECK) {
    wc::warp_max<2>(ap, c.red, 0);
    wc::warp_max<2>(ad, c.red, 1);
  }
  __syncthreads();
  float acc[wc::CPT][TB];
  wc::zero(acc[0]);
  wc::zero(acc[1]);
  wc::product_cols<8>(c.w, p.mc, p.dim_p, 0, c.box_end, p.dim_p, acc);
  wc::product_cols<8>(c.w, p.mc, p.dim_p, p.cone0, c.s_end, p.dim_p, acc);
#pragma unroll
  for (int h = 0; h < wc::CPT; ++h) {
    const int j = wc::col(h, p.dim_p);
    if (j < 0) break;
    const int o = j * TB;
    float zn[TB], zc[TB];
    wc::load(zn, c.zn + o);
    wc::load(zc, c.zc + o);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (!wc::bit(frozen, b)) {
        zc[b] = zn[b];
        zn[b] = zn[b] + acc[h][b];
      }
    }
    wc::store(c.zn + o, zn);
    wc::store(c.zc + o, zc);
  }
  unsigned conv = 0;
  if (CHECK) {
    float rs[2][TB];
    wc::block_max<2>(c.red, 0, rs[0]);
    wc::block_max<2>(c.red, 1, rs[1]);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (rs[0][b] <= p.tol_p && rs[1][b] <= p.tol_d) conv |= 1u << b;
      if (threadIdx.x == 0 && wc::bit(rmask, b)) {
        lres[0][b] = rs[0][b];
        lres[1][b] = rs[1][b];
      }
    }
  }
  __syncthreads();
  return conv;
}

// The prepared z, s and lam of the thread's columns to (TO_GLOBAL) or from
// each lane's [z | s | lam] in p.snap, for the lanes in `lanes`.
template <bool TO_GLOBAL>
__device__ __forceinline__ void hmpc_wide_snapshot(const HmpcWide& p,
                                                   const HmpcCols& c,
                                                   int lane0,
                                                   unsigned lanes) {
  const int W = p.dim_p + 2 * p.ns_p;
#pragma unroll
  for (int h = 0; h < wc::CPT; ++h) {
    const int jz = wc::col(h, p.dim_p), js = wc::col(h, p.ns_p);
    if (jz >= 0) wc::snap_row<TO_GLOBAL>(c.zn, p.snap, W, jz, jz, lane0,
                                         lanes);
    if (js >= 0) {
      wc::snap_row<TO_GLOBAL>(c.sv, p.snap, W, p.dim_p + js, js, lane0,
                              lanes);
      wc::snap_row<TO_GLOBAL>(c.lam, p.snap, W, p.dim_p + p.ns_p + js, js,
                              lane0, lanes);
    }
  }
}

__global__ void __launch_bounds__(wc::THREADS, 1)
    fused_hmpc_wide_kernel(HmpcWide p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sn_k[TB];       // exact-k: each lane's window start
  __shared__ float lres[2][TB];  // thread 0's residuals of each lane
  __shared__ int bounds[2];      // box_end, s_end
  const int dim_p = p.dim_p, ns_p = p.ns_p;
  const int lane0 = blockIdx.x * TB;
  HmpcCols c;
  c.zn = smem;
  c.w = c.zn + dim_p * TB;
  c.red = c.w + ns_p * TB;
  c.zc = p.state + static_cast<size_t>(blockIdx.x) * (dim_p + 2 * ns_p) * TB;
  c.sv = c.zc + dim_p * TB;
  c.lam = c.sv + ns_p * TB;
  if (threadIdx.x == 0) {
    bounds[0] = 0;
    bounds[1] = p.cone0;
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      lres[0][b] = wc::RBIG;
      lres[1][b] = wc::RBIG;
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < wc::CPT; ++h) {
    const int j = wc::col(h, ns_p);
    c.d[h] = j < 0 ? 0.0f : p.d[j];
    c.lb[h] = j < 0 ? 0.0f : p.lb[j];
    c.ub[h] = j < 0 ? 0.0f : p.ub[j];
    c.lo[h] = 0;
    c.hi[h] = 0;
    if (j < 0) continue;
    // the first and last nonzero of CT column j
    for (int i = 0; i < dim_p; ++i) {
      if (p.ct[static_cast<size_t>(i) * ns_p + j] != 0.0f) {
        if (c.hi[h] == 0) c.lo[h] = i;
        c.hi[h] = i + 1;
      }
    }
    if (c.hi[h] > c.lo[h]) atomicMax(&bounds[j < p.cone0 ? 0 : 1], j + 1);
  }
#pragma unroll
  for (int h = 0; h < wc::CPT; ++h) {
    const int j = wc::col(h, dim_p);
    if (j < 0) break;
    wc::read_row(c.zn, p.z1, dim_p, j, lane0);
    wc::read_row(c.zc, p.z1, dim_p, j, lane0);
  }
#pragma unroll
  for (int h = 0; h < wc::CPT; ++h) {
    const int j = wc::col(h, ns_p);
    if (j < 0) break;
    wc::read_row(c.sv, p.s0, ns_p, j, lane0);
    wc::read_row(c.lam, p.lam0, ns_p, j, lane0);
  }
  __syncthreads();
  c.box_end = bounds[0];
  c.s_end = bounds[1];
  unsigned done = 0;
  int k[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) k[b] = 0;
  const int C = p.check_every;
  const float* zout = c.zc;  // the z written out: the consumed z ...

  if (C > 1 && p.exact_k) {
    // free-run windows of C iterations; snapshot every still-active lane
    // at each window start, so the window a lane converges in can be
    // replayed with per-iteration checks once the block has drained.
    // Windows may overshoot k_max: the replay budget cuts each lane off at
    // exactly k_max.
    for (int it = 0; it < p.k_max && done != wc::ALL; it += C) {
      hmpc_wide_snapshot<true>(p, c, lane0, ~done & wc::ALL);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int b = 0; b < TB; ++b)
          if (!wc::bit(done, b)) sn_k[b] = it;
      }
      for (int f = 0; f < C - 1; ++f)
        hmpc_wide_iterate<false>(p, c, 0u, 0u, lres);
      done |= hmpc_wide_iterate<true>(p, c, 0u, 0u, lres);
    }
    // replay each lane's last window from its snapshot with per-iteration
    // checks: k counts on from the window start (the last iteration's
    // closing barrier ordered thread 0's window starts)
    hmpc_wide_snapshot<false>(p, c, lane0, wc::ALL);
#pragma unroll
    for (int h = 0; h < wc::CPT; ++h) {
      const int j = wc::col(h, dim_p);
      if (j < 0) break;
      float z[TB];
      wc::load(z, c.zn + j * TB);
      wc::store(c.zc + j * TB, z);
    }
    __syncthreads();
    int budget[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      k[b] = sn_k[b];
      budget[b] = min(C, p.k_max - k[b]);
    }
    unsigned convd = 0;
    for (int w = 0; w < C; ++w) {
      unsigned frozen = convd;
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (w >= budget[b]) frozen |= 1u << b;
      if (frozen == wc::ALL) break;
      const unsigned conv = hmpc_wide_iterate<true>(p, c, frozen,
                                                    ~frozen & wc::ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!wc::bit(frozen, b)) ++k[b];
      convd |= conv & ~frozen;
    }
    done = convd;
  } else if (C > 1) {
    // free-run: C-1 plain iterations, then one checked iteration; every
    // lane keeps iterating until the block's lanes (one group of 8) are
    // all done, k is recorded at check granularity, and a done lane's
    // residuals stay at its exit
    for (int it = 0; it < p.k_max && done != wc::ALL;) {
      const int n_fast = min(C - 1, p.k_max - 1 - it);
      for (int f = 0; f < n_fast; ++f)
        hmpc_wide_iterate<false>(p, c, 0u, 0u, lres);
      const unsigned conv =
          hmpc_wide_iterate<true>(p, c, 0u, ~done & wc::ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!wc::bit(done, b)) k[b] += n_fast + 1;
      done |= conv;
      it += n_fast + 1;
    }
    zout = c.zn;  // ... but the prepared one in free-run
  } else {
    // checked: exit tests every iteration; a converged lane freezes and
    // keeps the z it consumed at exit
    for (int it = 0; it < p.k_max && done != wc::ALL; ++it) {
      const unsigned conv =
          hmpc_wide_iterate<true>(p, c, done, ~done & wc::ALL, lres);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (!wc::bit(done, b)) ++k[b];
      done |= conv;
    }
  }

#pragma unroll
  for (int h = 0; h < wc::CPT; ++h) {
    const int j = wc::col(h, dim_p);
    if (j < 0) break;
    wc::write_row(zout, p.z, dim_p, j, lane0);
  }
#pragma unroll
  for (int h = 0; h < wc::CPT; ++h) {
    const int j = wc::col(h, ns_p);
    if (j < 0) break;
    wc::write_row(c.sv, p.s, ns_p, j, lane0);
    wc::write_row(c.lam, p.lam, ns_p, j, lane0);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      p.k[lane0 + b] = k[b];
      p.done[lane0 + b] = wc::bit(done, b) ? 1 : 0;
      p.rp[lane0 + b] = lres[0][b];
      p.rd[lane0 + b] = lres[1][b];
    }
  }
}

}  // namespace

// Dynamic shared bytes of a block of the wide build (kernels/fused_hmpc.py
// shared_bytes(dim_p, ns_p, wide=True) computes the same): the prepared z
// as [dim_p][8], w as [ns_p][8] and the warps' row maxima.
extern "C" long fused_hmpc_wide_smem(int dim_p, int ns_p) {
  return 4L * TB * (dim_p + ns_p + 2L * wc::WARPS);
}

// Launch the wide build on `stream`: the arguments of fused_hmpc_launch but
// the refill queue and the lanes, and `state`, the blocks' global state
// ([B / 8][dim_p + 2 ns_p][8] floats). The geometry comes from the wrapper
// (kernels/fused_hmpc.py launch_plan with wide=True) and is checked here
// again. Returns the CUDA error of the launch, as an int.
extern "C" int fused_hmpc_wide_launch(
    const float* z1, const float* s0, const float* lam0, const float* ct,
    const float* mc, const float* d, const float* lb, const float* ub,
    float* z, float* s, float* lam, int* k, int* done, float* rp, float* rd,
    float* snap, float* state, int B, int dim_p, int ns_p, int cone0,
    int cone_g, int use_soc, int blocks, int threads, int smem, float rho,
    float rho_i, float tol_p, float tol_d, int k_max, int check_every,
    int exact_k, void* stream) {
  const bool exact = check_every > 1 && exact_k;
  if (dim_p <= 0 || dim_p % 32 != 0 || dim_p > wc::COLS || ns_p <= 0 ||
      ns_p % 32 != 0 || ns_p > wc::COLS || cone0 < 0 || cone0 % 32 != 0 ||
      cone0 >= ns_p || cone_g < 1 || cone_g > MAX_G || B % TB != 0 ||
      blocks != B / TB || threads != wc::THREADS ||
      smem != fused_hmpc_wide_smem(dim_p, ns_p) || check_every < 1 ||
      k_max < 1 ||
      (B > 0 && (state == nullptr || (exact && snap == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_hmpc_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  HmpcWide p{z1,    s0,    lam0,  ct,     mc,      d,     lb,    ub,
             z,     s,     lam,   k,      done,    rp,    rd,    snap,
             state, dim_p, ns_p,  cone0,  cone_g,  use_soc, rho, rho_i,
             tol_p, tol_d, k_max, check_every, exact_k};
  fused_hmpc_wide_kernel<<<blocks, wc::THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

#endif  // WIDE_PART
