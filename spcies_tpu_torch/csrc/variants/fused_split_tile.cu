// Fused two-block split (S)ADMM for HMPC-ADMM-split and HMPC-SADMM-split on
// NVIDIA Hopper (sm_90a), written by hand: the build on the product stage
// csrc/tile_product.cuh. It gives csrc/fused_split.cu's results bit for bit
// and is slower than it at the HMPC families' batches on an H100 (PERF.md),
// so kernels/fused_split.py does not launch it: it is a variant that
// tools/ab_kernels.py builds, holds against csrc/fused_split.cu and times.
//
// Like csrc/fused_split.cu it replaces the Pallas TPU kernel
// spcies_tpu/kernels/fused_split.py::_fused_split_kernel and computes what
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
//
// Layout. One thread block per L = 8, 16 or 32 lanes; one thread per column
// j of the padded width P (at most 512; 320 at N=30: z 258 -> 288, one warp
// of 8 cones). aux, zs, lm and dq of the block's lanes lie in shared memory
// as [P][L] (the layout of csrc/tile_product.cuh). The element-wise half
// keeps its thread-per-column form, 8 lanes at a time: the cones lie in
// whole warps from column cone0, g <= 10 cones a warp, cone c's y0, y1, y2
// at lanes c, g + c, 2g + c; each lane of a cone reads its cone's three
// entries by warp shuffles and computes the projection itself (the three
// lanes of a cone do the same arithmetic on the same values), in the
// blended form of the JAX kernel's _proj_ssoc_seg, with no barrier. Then
// the product stage of csrc/tile_product.cuh forms acc = dq @ M1' with a
// thread owning 8 lanes x 4 columns (1 at L = 8: tp::tile_cols) and M1''s
// rows coming through a shared-memory ring filled by asynchronous copies
// (TMA); groups of 8 lanes that are done are skipped, and in exact-k's
// windows the lanes still running are compacted into the first groups and
// the tiles narrow. dq is exactly 0 on the
// pad columns (iscale = 0 there), so the product reads only the real rows:
// those below the z slab's last real column and from dim_p to the s slab's
// last real column (282 of 320 at N=30), found from iscale by each block
// before its loop. After the stage's first barrier thread t < L (lane t's
// keeper: its k and residuals live in that thread's registers) takes lane
// t's row maxima over the warps and warp 0 publishes the mask of converged
// lanes; the tile's owner then adds acc to aux, except on lanes that are
// frozen or end here, whose aux stays the one they consumed at exit (the
// checked and exact-k modes' output, so no copy of it is kept). An iteration
// has one __syncthreads a slab of M1' and one after the aux update; loop
// control is uniform across a block. In plain free-run each group of 8
// lanes freezes once its 8 lanes are done, as a tile of tile_b = 8 does.
//
// Bound. 2 (dim + n_s)^2 FLOP an iteration and lane on the CUDA cores; every
// block re-reads the real rows of M1' (282 x 320 at N=30, 361 KB) from L2
// on every iteration, for L lanes: a quarter of the 8-lane kernel's traffic
// at L = 32. M1' stays in the 50 MB L2.
//
// Arithmetic. fp32 on the CUDA cores, no TF32. The library is built with
// -fmad=false, so the element-wise steps (sqrtf and the division included)
// round as PyTorch's separate operations do; the product is an explicit
// fmaf chain over the rows in ascending order (the z rows, then the s rows),
// so the results are the same bits for every L and the same as the
// one-column-per-thread kernel's (csrc/fused_split.cu).
//
// Exact-k snapshots. At each window start aux, zs and lm of every lane not
// yet done go to global scratch (each thread writes, and later reads back,
// only its own column), and the window start to shared memory; the replay
// runs each lane's last window with the checked semantics and the budget
// min(C, k_max - kws), as K1-K5 do.
//
// Padding. Pad columns carry zero rows and columns of M1', [0, 0] bounds
// and iscale = 0, so they stay exactly 0 (a pad cone slot projects a zero
// triple onto zero) and add nothing to the row maxima.

#include <cuda_runtime.h>

#include "tile_product.cuh"

namespace {

constexpr int MAX_COLS = 512;  // threads per block, one per column
constexpr int NARROW = 320;    // up to this width a build of its own
constexpr int MAX_G = 10;      // cones a warp (MAX_CONES_PER_WARP)
constexpr int NSNAP = 3;       // snapshot leaves (SNAP_LEAVES in the wrapper)
constexpr unsigned FULL = 0xffffffffu;

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
  float* snap;  // exact-k: per lane [aux | zs | lm]
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

// The block: its shared buffers, what thread j knows of its column, its tile
// of the product, and (thread t < L) what it keeps of lane t.
template <int L, int TC>
struct Engine {
  static constexpr int G = L / 8;
  static constexpr int SR = tp::SLAB;
  static constexpr unsigned ALL = L == 32 ? FULL : (1u << L) - 1u;
  const Params& p;
  float *aux, *zs, *lm, *dq, *red;  // [P][L] each; red [warps][2][L]
  unsigned* ctrl;
  int *sn_k, *orig;  // exact-k: each lane's window start, a slot's lane
  tp::Ring ring;
  int tid, P, warps, lane0;
  bool cone_warp;  // j in a warp of cones: the warp shuffles
  bool cone;       // j holds an entry of a cone (lane < 3g)
  int src, seg;    // the lane of its cone's y0; which entry it holds
  float lb, ub, scale, iscale;
  tp::Keeper kp;

  __device__ __forceinline__ Engine(const Params& p_, float* smem,
                                    int* bounds)
      : p(p_) {
    tid = threadIdx.x;
    P = p.P;
    warps = P >> 5;
    lane0 = blockIdx.x * L;
    float* a = smem + tp::ring_bytes(P, SR) / 4;
    aux = a;
    zs = aux + P * L;
    lm = zs + P * L;
    dq = lm + P * L;
    red = dq + P * (L + tp::DQ_PAD);
    ctrl = reinterpret_cast<unsigned*>(red + warps * 2 * L);
    sn_k = reinterpret_cast<int*>(ctrl + 4);
    orig = sn_k + L;
    const int j = tid;
    scale = p.scale[j];
    iscale = p.iscale[j];
    lb = p.lb[j];
    ub = p.ub[j];
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
    if (j < L) {
      sn_k[j] = 0;
      orig[j] = j;
    }
    __syncthreads();
    if (iscale != 0.0f) atomicMax(&bounds[j < p.dim_p ? 0 : 1], j + 1);
    __syncthreads();
    tp::ring_init<SR>(ring, smem, p.m1p, P, bounds[0], p.dim_p, bounds[1],
                      tid, P);
  }

  // One iteration. Lanes in `frozen` keep all their state; what `idle`
  // lanes hold is never read again, and a group of 8 lanes that are all
  // frozen or idle is skipped; the lanes in `last` (and, with stop, the
  // lanes that converge here) keep the aux they consumed. With CHECK, the
  // keepers of the lanes in rmask record their residuals and count kinc
  // iterations, and the lanes whose residuals meet tol are returned
  // (identical in every thread of the block).
  template <bool CHECK>
  TP_ITERATE unsigned iterate(unsigned frozen, unsigned idle, unsigned last,
                              bool stop, unsigned rmask, int kinc) {
    const int j = tid;
    const float as = p.alpha * scale;
    const unsigned dead = tp::whole_groups<L>(frozen | idle);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (bit(dead, 8 * g)) continue;
      float ax[8], zo[8], lo[8], lh[8], zn[8], w[8];
      tp::ld8<L>(ax, aux, j, g);
      tp::ld8<L>(zo, zs, j, g);
      tp::ld8<L>(lo, lm, j, g);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        lh[b] = p.symmetric ? lo[b] + as * (ax[b] - zo[b]) : lo[b];
        w[b] = ax[b] + iscale * lh[b];
      }
      if (cone_warp) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          float y0 = __shfl_sync(FULL, w[b], src);
          float y1 = __shfl_sync(FULL, w[b], src + p.cone_g);
          float y2 = __shfl_sync(FULL, w[b], src + 2 * p.cone_g);
          if (p.use_soc) {
            proj_ssoc(y0, y1, y2, 1.0f, 0.0f);
          } else {
            proj_ssoc(y0, y1, y2, 1.0f, lb);
            proj_ssoc(y0, y1, y2, -1.0f, ub);
          }
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
      tp::st8_dq<L>(dq, j, g, d);
      tp::st8<L>(zs, j, g, zo);
      tp::st8<L>(lm, j, g, lo);
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
  // product, the keeper's part after its first barrier, and aux += acc.
  template <int TCX, bool CHECK>
  __device__ __forceinline__ unsigned finish(unsigned dead, unsigned frozen,
                                             unsigned last, bool stop,
                                             unsigned rmask, int kinc) {
    const tp::Tile<L, TCX> tile(tid, P);
    float acc[TCX][8];
#pragma unroll
    for (int q = 0; q < TCX; ++q) {
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[q][b] = 0.0f;
    }
    const bool live = tile.active && !bit(dead, 8 * tile.lg);
    tp::product<L, TCX, SR>(ring, dq, tile, acc, live, tid, P, CHECK, [&]() {
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
        float ax[8];
        tp::ld8<L>(ax, aux, tile.col(q), tile.lg);
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (!bit(skip, b)) ax[b] = ax[b] + acc[q][b];
        tp::st8<L>(aux, tile.col(q), tile.lg, ax);
      }
    }
    __syncthreads();
    return CHECK ? ctrl[0] : 0u;
  }

  __device__ __forceinline__ unsigned compact(unsigned done) {
    float* const leaves[NSNAP] = {aux, zs, lm};
    return tp::compact_lanes<L>(done, leaves, orig, tid);
  }

  // Copy this thread's column of aux, zs and lm between shared memory and
  // the per-lane [aux | zs | lm] layout in global memory, for the slots in
  // `lanes` (slot b holds lane orig[b]). TO_GLOBAL selects the direction.
  template <bool TO_GLOBAL>
  __device__ __forceinline__ void snapshot(unsigned lanes) {
    float* const leaves[NSNAP] = {aux, zs, lm};
#pragma unroll
    for (int l = 0; l < NSNAP; ++l) {
      for (int b = 0; b < L; ++b) {
        if (!bit(lanes, b)) continue;
        float* g = p.snap +
                   (static_cast<size_t>(lane0 + orig[b]) * NSNAP + l) * P + tid;
        float& sh = tp::at<L>(leaves[l], tid, b);
        if (TO_GLOBAL)
          *g = sh;
        else
          sh = *g;
      }
    }
  }
};

template <int L, int TC, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    fused_split_tile_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int bounds[2];  // z_end, s_end
  Engine<L, TC> e(p, smem, bounds);
  const int P = p.P;
  const int j = e.tid;
  const int lane0 = e.lane0;
  for (int b = 0; b < L; ++b) {
    const size_t g = static_cast<size_t>(lane0 + b) * P + j;
    tp::at<L>(e.aux, j, b) = p.aux1[g];
    tp::at<L>(e.zs, j, b) = p.zs0[g];
    tp::at<L>(e.lm, j, b) = p.lm0[g];
  }
  __syncthreads();
  // free-run writes out the prepared aux, the other modes the consumed one
  // (the aux a lane keeps once it has ended)
  const unsigned done =
      tp::run_modes<L>(e, p.k_max, p.check_every, p.exact_k, 0);
  tp::ring_drain(e.ring);

  for (int b = 0; b < L; ++b) {
    const size_t g = static_cast<size_t>(lane0 + b) * P + j;
    p.zs[g] = tp::at<L>(e.zs, j, b);
    p.lm[g] = tp::at<L>(e.lm, j, b);
    p.aux[g] = tp::at<L>(e.aux, j, b);
  }
  if (j < L) {
    p.k[lane0 + j] = e.kp.k;
    p.done[lane0 + j] = bit(done, j) ? 1 : 0;
    p.rp[lane0 + j] = e.kp.rp;
    p.rd[lane0 + j] = e.kp.rd;
  }
}

template <int L>
int launch(const Params& p, int blocks, int threads, int smem,
           void* stream) {
  constexpr int TC = tp::tile_cols<L>();
  // up to NARROW columns a build with more registers a thread and, at 8 and
  // 16 lanes, for more than one block an SM; wider, one block of up to
  // MAX_COLS threads
  constexpr int MINB = L == 8 ? 3 : (L == 16 ? 2 : 1);
  void (*kernel)(Params) = p.P <= NARROW
                               ? fused_split_tile_kernel<L, TC, NARROW, MINB>
                               : fused_split_tile_kernel<L, TC, MAX_COLS, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared bytes at `lanes` lanes a block: the ring of M1''s slabs, aux, zs, lm and dq as
// [P][lanes], the warps' row maxima, the masks and the window starts.
extern "C" long fused_split_tile_smem(int P, int lanes) {
  return tp::ring_bytes(P, tp::SLAB) +
         4L * (P * (4L * lanes + tp::DQ_PAD) + (P / 32) * 2L * lanes + 4 +
               2 * lanes);
}

// Launch on `stream` (a cudaStream_t), with csrc/fused_split.cu's signature.
// The lanes a block are B / blocks (8, 16 or 32), the threads P and the
// shared bytes fused_split_tile_smem's. Returns the CUDA error of the launch,
// as an int.
extern "C" int fused_split_tile_launch(
    const float* aux1, const float* zs0, const float* lm0, const float* m1p,
    const float* lb, const float* ub, const float* scale,
    const float* iscale, float* zs, float* lm, float* aux, int* k,
    int* done, float* rp, float* rd, float* snap, int B, int P, int dim_p,
    int cone0, int cone_g, int symmetric, int use_soc, int blocks,
    int threads, int smem, float alpha, float tol_p, float tol_d, int k_max,
    int check_every, int exact_k, void* stream) {
  if (B == 0) return 0;
  const int lanes = blocks > 0 ? B / blocks : 0;
  const bool exact = check_every > 1 && exact_k;
  if (P <= 0 || P % 32 != 0 || P > MAX_COLS || dim_p <= 0 ||
      dim_p % 32 != 0 || cone0 < dim_p || cone0 % 32 != 0 || cone0 >= P ||
      cone_g < 1 || cone_g > MAX_G ||
      (lanes != 8 && lanes != 16 && lanes != 32) ||
      B != blocks * lanes ||
      threads != P || smem != fused_split_tile_smem(P, lanes) ||
      check_every < 1 || k_max < 1 || (exact && snap == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{aux1,  zs0,   lm0,    m1p,       lb,      ub,    scale, iscale,
           zs,    lm,    aux,    k,         done,    rp,    rd,    snap,
           P,     dim_p, cone0,  cone_g,    symmetric, use_soc, alpha,
           tol_p, tol_d, k_max,  check_every, exact_k};
  switch (lanes) {
    case 8:
      return launch<8>(p, blocks, threads, smem, stream);
    case 16:
      return launch<16>(p, blocks, threads, smem, stream);
    default:
      return launch<32>(p, blocks, threads, smem, stream);
  }
}
