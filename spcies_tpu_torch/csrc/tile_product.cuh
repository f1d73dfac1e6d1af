// The product stage of the fused loops on NVIDIA Hopper (sm_90a), written by
// hand: acc[L x P] = dq[L x R] @ M[R x P] for the L lanes of a thread block,
// once an iteration. csrc/fused_admm.cu (K1), csrc/fused_fista.cu (K2),
// csrc/fused_eadmm.cu (K3), csrc/fused_ellip.cu (K4), csrc/fused_soc.cu
// (K5), csrc/fused_hmpc.cu (K6) and csrc/fused_split.cu (K7) include it.
// K2's three products an iteration run over a ring of several matrices
// (SegRing). The end of the file holds the mode loops a kernel runs over its
// iteration, and the engine and refill loops K4-K7 share.
//
// Many lanes a block. A block of P threads (one per column of the padded
// width P) holds L = 8, 16 or 32 lanes. The rows of M, which every block
// re-reads on every iteration, are read once per L lanes: L2 traffic per
// lane falls by L / 8 against the one-column-per-thread kernels.
//
// Register tile. In the product a thread owns 8 lanes x TC columns (thread
// t: lane group t / (P / TC), columns TC (t % (P / TC)) + q), so per row of
// M it reads TC floats of the row and 8 deltas for 8 TC fmaf. Counting 32
// floats a clock from shared memory to an SM's registers, whatever is
// broadcast, against 128 fmaf a clock (a count that fits the times of the
// one-column-per-thread kernels: 16 floats per 8 fmaf, a quarter of the
// fmaf rate), a tile of 8 x 4 asks for 12 floats per 32 fmaf and is bound
// at two thirds of the fmaf rate, 8 x 8 for 16 per 64, the balance. With TC
// above L / 8 only the first
// (L / 8) (P / TC) threads multiply; at L = 8, TC = 1 the mapping is the
// one-column-per-thread mapping. A lane group whose 8 lanes are all done
// is skipped: its threads (whole warps where P / TC is a multiple of 32)
// multiply nothing. In the first half of exact-k the lanes still running
// are kept in the first slots (compact_lanes below), and once they fill half
// or a quarter of the block's groups the tiles narrow to TC / 2 or TC / 4
// columns, so that every thread again has work: a block's cost follows its
// live lanes, not L times its slowest lane's iterations.
//
// M through shared memory. The rows arrive in slabs of SR rows (16, or 32
// where a kernel has the shared memory for it) in a ring of NST
// shared-memory buffers, filled by one cp.async.bulk (TMA) a slab that
// reports to an mbarrier; TP_STAGE 1 fills them by cp.async (16 bytes a
// thread) and TP_STAGE 0 reads M straight from L2 with __ldg, both slower
// on an H100 (PERF.md). The load of slab s + NST - 1 is issued before slab
// s is multiplied. M is the same on every iteration, so the ring runs on
// across iterations: the first slabs of the next iteration load while this
// one's element-wise half runs. One __syncthreads a slab: it publishes the
// slab and frees the buffer of the slab before.
//
// The sum order. Every (lane, column) sum is one fmaf chain over the rows in
// ascending order (the first row range, then the second), as in the
// one-column-per-thread kernels: results are bit-identical for every L.
//
// Layouts. A [rows][L] buffer of the kernels' state holds row c's L lanes as
// L / 4 chunks of 16 bytes, chunk ch stored at position ch ^ key(c) so that
// the 8 threads of a quarter warp, which hold 8 consecutive rows (or 8 rows
// a stride of 4 or 8 apart, in the product's tiles), hit 8 different bank
// groups (a plain [rows][L] layout would put them all on the same banks
// once L reaches 32). dq, which the product reads once a row of M, is
// [rows][L + 4] instead: its writers are spread over the banks by the
// padding, and a row's address is affine in the row, so the unrolled
// product spends no instruction on it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef TP_STAGE
#define TP_STAGE 2  // 0: __ldg from L2, unstaged; 1: cp.async ring; 2: TMA
#endif
#ifndef TP_SLAB_ROWS
#define TP_SLAB_ROWS 16  // rows a slab
#endif
#ifndef TP_SLAB_ROWS_NARROW
#define TP_SLAB_ROWS_NARROW 32  // rows a slab where a kernel has the room
#endif
#ifndef TP_STAGES
#define TP_STAGES 2
#endif
#ifndef TP_ADJ
#define TP_ADJ 1  // 1: a thread's TC columns are adjacent (16-byte reads)
#endif
#ifndef TP_COLS_16
#define TP_COLS_16 4  // columns a thread owns at 16 lanes a block
#endif
#ifndef TP_NOINLINE
#define TP_NOINLINE 0  // 1: a kernel's iteration is one function, not inlined
#endif
#ifndef TP_UNROLL
#define TP_UNROLL 0  // rows of a slab unrolled together; 0: the whole slab
#endif
#ifndef TP_REFILL
#define TP_REFILL 1  // 0: K4's, K5's and K6's blocks keep their lanes
#endif
#ifndef TP_CLOCKS
#define TP_CLOCKS 0  // 1: engines count the clocks of an iteration's halves
#endif
#if TP_NOINLINE
#define TP_ITERATE __device__ __noinline__
#else
#define TP_ITERATE __device__ __forceinline__
#endif

namespace tp {

constexpr int SLAB = TP_SLAB_ROWS;                // rows a slab ...
constexpr int SLAB_NARROW = TP_SLAB_ROWS_NARROW;  // ... with room for more
constexpr int NST = TP_STAGES;    // buffers in the ring
constexpr int DQ_PAD = 4;         // floats of padding a row of dq
constexpr unsigned FULL = 0xffffffffu;
static_assert(NST >= 2, "the ring needs two buffers");

// Bytes of the ring (and its mbarriers) for a width P and slabs of SR rows.
__host__ __device__ constexpr long ring_bytes(int P, int SR) {
  return TP_STAGE == 0 ? 0L : 4L * NST * SR * P + (TP_STAGE == 2 ? 64L : 0L);
}

// Float offset of chunk ch (4 lanes) of row c in a swizzled [rows][L] buffer.
// The key spreads over the bank groups both 8 consecutive rows (the
// element-wise half: a quarter warp holds 8 consecutive columns) and 8 rows
// a stride of 4 or 8 apart (the product's tiles of adjacent columns).
template <int L>
__device__ __forceinline__ int chunk(int c, int ch) {
  constexpr int NCH = L / 4;                 // chunks a row
  constexpr int RPB = L >= 32 ? 1 : 32 / L;  // rows that span the 32 banks
  constexpr int KM = NCH < 8 ? NCH : 8;
  const int r = c / RPB;
  return c * L + ((ch ^ ((r ^ (r >> 3)) % KM)) << 2);
}

// The 8 lanes of group g of row c.
template <int L>
__device__ __forceinline__ void ld8(float (&v)[8], const float* buf, int c,
                                    int g) {
  const float4 a = *reinterpret_cast<const float4*>(buf + chunk<L>(c, 2 * g));
  const float4 b =
      *reinterpret_cast<const float4*>(buf + chunk<L>(c, 2 * g + 1));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <int L>
__device__ __forceinline__ void st8(float* buf, int c, int g,
                                    const float (&v)[8]) {
  *reinterpret_cast<float4*>(buf + chunk<L>(c, 2 * g)) =
      make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(buf + chunk<L>(c, 2 * g + 1)) =
      make_float4(v[4], v[5], v[6], v[7]);
}

// The 8 lanes of group g of row i of dq ([rows][L + DQ_PAD], not swizzled).
template <int L>
__device__ __forceinline__ void ld8_dq(float (&v)[8], const float* dq, int i,
                                       int g) {
  const float4* s = reinterpret_cast<const float4*>(dq + i * (L + DQ_PAD) +
                                                    g * 8);
  const float4 a = s[0], b = s[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <int L>
__device__ __forceinline__ void st8_dq(float* dq, int i, int g,
                                       const float (&v)[8]) {
  float4* d = reinterpret_cast<float4*>(dq + i * (L + DQ_PAD) + g * 8);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// One lane of row c.
template <int L>
__device__ __forceinline__ float& at(float* buf, int c, int lane) {
  return buf[chunk<L>(c, lane >> 2) + (lane & 3)];
}

// The maxima over the warp of the 8 lanes of group g, written to
// red[warp][slot][g * 8 + b] by the warp's first thread.
template <int L>
__device__ __forceinline__ void warp_max(float (&v)[8], float* red, int tid,
                                         int slot, int g) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[b] = fmaxf(v[b], __shfl_xor_sync(FULL, v[b], off));
  }
  if ((tid & 31) == 0) {
    float* w = red + ((tid >> 5) * 2 + slot) * L + g * 8;
    *reinterpret_cast<float4*>(w) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(w + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// The maximum over the warps of red[.][slot][lane].
template <int L>
__device__ __forceinline__ float lane_max(const float* red, int warps,
                                          int slot, int lane) {
  float r = 0.0f;
  for (int w = 0; w < warps; ++w)
    r = fmaxf(r, red[(w * 2 + slot) * L + lane]);
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The ring of slabs of M = m[.][P] (row-major, row length P) over the row
// ranges [0, a_end) and [b0, b_end), and where its endless sequence of
// slabs stands.
struct Ring {
  float* stage;    // [NST][SR * P]
  uint64_t* bar;   // TP_STAGE 2: one mbarrier a buffer
  const float* m;
  int P, a_end, b0, b_end;
  int nsa, ns;     // slabs of the first range, of an iteration
  int used;        // slabs multiplied since the kernel began
  int next;        // the slab of the iteration that is loaded next
};

template <int SR>
__device__ __forceinline__ void slab_rows(const Ring& r, int s, int& row0,
                                          int& n) {
  if (s < r.nsa) {
    row0 = s * SR;
    n = min(SR, r.a_end - row0);
  } else {
    row0 = r.b0 + (s - r.nsa) * SR;
    n = min(SR, r.b_end - row0);
  }
}

// Start the load of the ring's next slab into buffer `buf`.
template <int SR>
__device__ __forceinline__ void issue(Ring& r, int buf, int tid, int T) {
#if TP_STAGE != 0
  int row0, n;
  slab_rows<SR>(r, r.next, row0, n);
  r.next = r.next + 1 == r.ns ? 0 : r.next + 1;
  float* dst = r.stage + buf * SR * r.P;
  const float* src = r.m + static_cast<size_t>(row0) * r.P;
#if TP_STAGE == 1
  const int n4 = n * r.P / 4;
  for (int i = tid; i < n4; i += T)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst + 4 * i)),
                 "l"(src + 4 * i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#else
  if (tid == 0) {
    const uint32_t bar = smem_addr(r.bar + buf);
    const uint32_t bytes = static_cast<uint32_t>(n) * r.P * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(bar), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  }
#endif
#endif
}

// Set the ring up over `smem` (ring_bytes(P, SR) bytes, 16-byte aligned) and
// start its first NST - 1 loads. Every thread of the block calls it.
template <int SR>
__device__ __forceinline__ void ring_init(Ring& r, float* smem,
                                          const float* m, int P, int a_end,
                                          int b0, int b_end, int tid, int T) {
  r.stage = smem;
  r.bar = reinterpret_cast<uint64_t*>(smem + NST * SR * P);
  r.m = m;
  r.P = P;
  r.a_end = a_end;
  r.b0 = b0;
  r.b_end = b_end;
  r.nsa = (a_end + SR - 1) / SR;
  r.ns = r.nsa + (b_end > b0 ? (b_end - b0 + SR - 1) / SR : 0);
  r.used = 0;
  r.next = 0;
#if TP_STAGE == 2
  if (tid == 0) {
    for (int b = 0; b < NST; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(r.bar + b)),
                   "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#endif
  for (int b = 0; b < NST - 1; ++b) issue<SR>(r, b, tid, T);
}

// Wait for the loads still in flight before the block ends.
__device__ __forceinline__ void ring_drain(Ring& r) {
#if TP_STAGE == 1
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#elif TP_STAGE == 2
  for (int i = 0; i < NST - 1; ++i) {
    const int g = r.used + i;
    const uint32_t bar = smem_addr(r.bar + g % NST);
    const uint32_t parity = (g / NST) & 1;
    asm volatile(
        "{\n.reg .pred P1;\nLAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
        "r"(parity)
        : "memory");
  }
#endif
  __syncthreads();
}

// The columns a thread owns in the product at L lanes a block: a tile of 8
// lanes x 4 columns, and the one-column-per-thread mapping at 8 lanes.
template <int L>
constexpr int tile_cols() {
  return L == 8 ? 1 : (L == 16 ? TP_COLS_16 : 4);
}

// The wide builds of K4-K7 (csrc/fused_ellip.cu, csrc/fused_soc.cu,
// csrc/fused_hmpc.cu, csrc/fused_split.cu): past 512 columns, up to
// WIDE_COLS, their engine runs on WIDE_THREADS threads of WIDE_CPT columns
// (t and t + WIDE_THREADS) at 16 lanes a block with 16-row slabs, or at 8
// with 8-row slabs (kernels/stage.py WIDE_BUILDS), one block an SM; where
// a kernel's leaves do not all fit at 16 lanes, all but the first go to the
// block's global scratch, with 8-row slabs (WIDE_SLAB_8).
constexpr int WIDE_CPT = 2;             // columns a thread
constexpr int WIDE_THREADS = 512;       // threads a block
constexpr int WIDE_COLS = WIDE_CPT * WIDE_THREADS;
constexpr int WIDE_SLAB_16 = 16;        // rows a slab at 16 lanes a block
constexpr int WIDE_SLAB_8 = 8;          // and at 8, and with global leaves
constexpr long SMEM_MAX = 232448;       // shared bytes a block can have

constexpr int wide_slab(int lanes) {
  return lanes == 16 ? WIDE_SLAB_16 : WIDE_SLAB_8;
}

// Columns of a wide build's product tile at L lanes: WIDE_THREADS threads
// cover (L / 8) P / TCW tiles up to WIDE_COLS columns.
template <int L>
constexpr int wide_tc() {
  return tile_cols<L>() > (L / 8) * WIDE_CPT ? tile_cols<L>()
                                              : (L / 8) * WIDE_CPT;
}

// A thread's tile of the product: lane group lg, columns c0 + q * cs;
// threads past the last tile are not active.
template <int L, int TC>
struct Tile {
  int lg, c0, cs;
  bool active;
  __device__ __forceinline__ Tile(int tid, int P) {
    const int ncg = P / TC;
    lg = tid / ncg;
    active = lg < L / 8;
    if (!active) lg = 0;
    const int cg = tid % ncg;
    c0 = TP_ADJ ? cg * TC : cg;
    cs = TP_ADJ ? 1 : ncg;
  }
  __device__ __forceinline__ int col(int q) const { return c0 + q * cs; }
};

__device__ __forceinline__ bool bit(unsigned m, int b) {
  return (m >> b) & 1u;
}

// The lanes of `mask` that belong to groups of 8 whose lanes are all in it.
template <int L>
__device__ __forceinline__ unsigned whole_groups(unsigned mask) {
  unsigned out = 0;
#pragma unroll
  for (int g = 0; g < L / 8; ++g)
    if (((mask >> (8 * g)) & 0xffu) == 0xffu) out |= 0xffu << (8 * g);
  return out;
}

// The thread's TC entries of a row of M (shared or global memory).
template <int TC, class T>
__device__ __forceinline__ void load_m(float (&m)[TC], const float* mrow,
                                       const T& t) {
#if TP_ADJ
  if constexpr (TC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < TC / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(mrow + t.c0 + 4 * q);
      m[4 * q] = a.x; m[4 * q + 1] = a.y; m[4 * q + 2] = a.z;
      m[4 * q + 3] = a.w;
    }
  } else if constexpr (TC == 2) {
    const float2 a = *reinterpret_cast<const float2*>(mrow + t.c0);
    m[0] = a.x; m[1] = a.y;
  } else {
    m[0] = mrow[t.c0];
  }
#else
#pragma unroll
  for (int q = 0; q < TC; ++q) m[q] = mrow[t.col(q)];
#endif
}

// acc[q][b] = fmaf(dq[i][lg * 8 + b], mrow[col(q)], acc[q][b]) for row i.
template <int L, int TC>
__device__ __forceinline__ void row_fma(float (&acc)[TC][8],
                                        const float* mrow, const float* dq,
                                        int i, const Tile<L, TC>& t) {
  float m[TC];
  load_m<TC>(m, mrow, t);
  float d[8];
  ld8_dq<L>(d, dq, i, t.lg);
#pragma unroll
  for (int q = 0; q < TC; ++q) {
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[q][b] = fmaf(d[b], m[q], acc[q][b]);
  }
}

// acc = dq @ M over the ring's row ranges, for this thread's tile; acc
// comes in as the start of the chains (zeros). Threads that are not `live`
// (no tile, or a lane group that is done) multiply nothing but keep the
// ring and its barriers going. dq is the [P][L + DQ_PAD] buffer the block
// wrote before the call: the first __syncthreads here publishes it, and
// hook() runs right after that barrier, before any product work. With
// need_sync, what hook() writes to shared memory can be read by every
// thread when product() returns (a barrier is added when the ring's own
// barriers do not already order it).
template <int L, int TC, int SR, class Hook>
__device__ __forceinline__ void product(Ring& r, const float* dq,
                                        const Tile<L, TC>& t,
                                        float (&acc)[TC][8], bool live,
                                        int tid, int T, bool need_sync,
                                        Hook&& hook) {
#if TP_STAGE == 0
  __syncthreads();
  hook();
  if (live) {
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int i0 = half ? r.b0 : 0;
      const int i1 = half ? r.b_end : r.a_end;
#pragma unroll 8
      for (int i = i0; i < i1; ++i)
        row_fma<L, TC>(acc, r.m + static_cast<size_t>(i) * r.P, dq, i, t);
    }
  }
  if (need_sync) __syncthreads();
#else
  for (int s = 0; s < r.ns; ++s) {
    const int buf = r.used % NST;
#if TP_STAGE == 1
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 2) : "memory");
#else
    {
      const uint32_t bar = smem_addr(r.bar + buf);
      const uint32_t parity = (r.used / NST) & 1;
      asm volatile(
          "{\n.reg .pred P1;\nLAB_WAIT:\n"
          "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
          "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
          "r"(parity)
          : "memory");
    }
#endif
    __syncthreads();
    issue<SR>(r, (r.used + NST - 1) % NST, tid, T);
    if (s == 0) hook();
    ++r.used;
    if (!live) continue;
    int row0, n;
    slab_rows<SR>(r, s, row0, n);
    const float* st = r.stage + buf * SR * r.P;
    const float* dqs = dq + row0 * (L + DQ_PAD);
    constexpr int UNROLL = TP_UNROLL > 0 ? TP_UNROLL : SR;
    if (n == SR) {
#pragma unroll UNROLL
      for (int q = 0; q < SR; ++q)
        row_fma<L, TC>(acc, st + q * r.P, dqs, q, t);
    } else {
      for (int q = 0; q < n; ++q)
        row_fma<L, TC>(acc, st + q * r.P, dqs, q, t);
    }
  }
  if (need_sync && r.ns < 2) __syncthreads();
#endif
}

// ---- a ring over several matrices ------------------------------------------
//
// K2 (csrc/fused_fista.cu) runs three products an iteration, each over its
// own matrix and width. SegRing is the ring above over an endless cycle of
// NS segments, segment s the rows [0, rows[s]) of m[s] (row-major, row
// length P[s]), each cut into slabs of SR rows: a product consumes its
// segment's slabs, and the loads of the next segment's first slab run while
// the element-wise step between two products runs. Its buffers hold slabs
// of the widest row (ring_bytes(pmax, SR)), filled by TMA. A slab is 16
// rows (shared memory has no room for more beside K2's state), so a
// __syncthreads a slab, as Ring has, would cost K2 some 40 barriers an
// iteration: instead each buffer has a second mbarrier, `empty`, on which
// every warp arrives once it is done with the buffer, and thread 0 waits on
// it before it loads the buffer again. The warps then wait for each other
// only where a product's input is published (a barrier a slab was 3 %
// slower on an H100, PERF.md).

template <int NS>
struct SegRing {
  float* stage;     // [NST][SR * pmax]
  uint64_t* full;   // [NST]: the buffer's load has landed
  uint64_t* empty;  // [NST]: every warp is done with the buffer
  const float* m[NS];
  int P[NS], rows[NS];
  int first[NS], ns[NS];  // a segment's first slab in the cycle, its slabs
  int pmax, total;        // the widest row, slabs of a cycle
  int used;               // slabs multiplied since the kernel began
  int next;               // the slab of the cycle that is loaded next
  long long clk[NS];      // TP_CLOCKS: thread 0's clocks in each segment's
                          // slab loop
};

// Wait for the phase of mbarrier `bar` whose parity is `parity` to end.
__device__ __forceinline__ void bar_wait(const uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Thread 0: start the load of slab number u (counted since the kernel
// began; it is the cycle's slab r.next) into buffer u % NST, once every
// warp is done with that buffer's slab before.
template <int SR, int NS>
__device__ __forceinline__ void issue(SegRing<NS>& r, int u, int tid) {
  static_assert(TP_STAGE == 2 || NS < 0, "SegRing loads its slabs by TMA");
  // the segment of slab r.next, picked with constant indices so that the
  // ring stays in registers
  const float* m = r.m[0];
  int first = 0, rows = r.rows[0], P = r.P[0];
#pragma unroll
  for (int i = 1; i < NS; ++i) {
    if (r.next >= r.first[i]) {
      m = r.m[i];
      first = r.first[i];
      rows = r.rows[i];
      P = r.P[i];
    }
  }
  const int row0 = (r.next - first) * SR;
  const int n = min(SR, rows - row0);
  r.next = r.next + 1 == r.total ? 0 : r.next + 1;
  if (tid != 0) return;
  const int buf = u % NST;
  if (u >= NST) bar_wait(r.empty + buf, (u / NST - 1) & 1);
  float* dst = r.stage + buf * SR * r.pmax;
  const float* src = m + static_cast<size_t>(row0) * P;
  const uint32_t bar = smem_addr(r.full + buf);
  const uint32_t bytes = static_cast<uint32_t>(n) * P * 4u;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Set the ring up over `smem` (ring_bytes(pmax, SR) bytes, 16-byte aligned)
// and start its first NST - 1 loads; every segment has at least one row.
// Every thread of the block (T threads, whole warps) calls it.
template <int SR, int NS>
__device__ __forceinline__ void ring_init(SegRing<NS>& r, float* smem,
                                          const float* const (&m)[NS],
                                          const int (&P)[NS],
                                          const int (&rows)[NS], int pmax,
                                          int tid, int T) {
  static_assert(2 * NST * 8 <= 64, "the mbarriers fit ring_bytes' 64 bytes");
  r.stage = smem;
  r.full = reinterpret_cast<uint64_t*>(smem + NST * SR * pmax);
  r.empty = r.full + NST;
  r.pmax = pmax;
  r.total = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    r.m[s] = m[s];
    r.P[s] = P[s];
    r.rows[s] = rows[s];
    r.first[s] = r.total;
    r.ns[s] = (rows[s] + SR - 1) / SR;
    r.total += r.ns[s];
  }
  r.used = 0;
  r.next = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) r.clk[s] = 0;
  if (tid == 0) {
    for (int b = 0; b < NST; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(r.full + b)),
                   "r"(1)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(r.empty + b)),
                   "r"(T / 32)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int u = 0; u < NST - 1; ++u) issue<SR>(r, u, tid);
}

// Wait for the loads still in flight before the block ends.
template <int NS>
__device__ __forceinline__ void ring_drain(SegRing<NS>& r) {
  for (int i = 0; i < NST - 1; ++i) {
    const int u = r.used + i;
    bar_wait(r.full + u % NST, (u / NST) & 1);
  }
  __syncthreads();
}

// product() above over segment `seg` of a SegRing: acc = in @ M for this
// thread's tile, in being a [rows][L + DQ_PAD] buffer the block wrote before
// the call. The barrier at the start publishes it, and hook() runs right
// after that barrier; with need_sync, what hook() writes to shared memory
// can be read by every thread when product() returns. Every warp waits for
// each slab and releases it, live or not.
template <int L, int TC, int SR, int NS, class Hook>
__device__ __forceinline__ void product(SegRing<NS>& r, int seg,
                                        const float* in, const Tile<L, TC>& t,
                                        float (&acc)[TC][8], bool live,
                                        int tid, bool need_sync,
                                        Hook&& hook) {
  const int P = r.P[seg], rows = r.rows[seg], ns = r.ns[seg];
  __syncthreads();
  hook();
  const long long t0 = TP_CLOCKS && tid == 0 ? clock64() : 0;
  for (int s = 0; s < ns; ++s) {
    const int buf = r.used % NST;
    bar_wait(r.full + buf, (r.used / NST) & 1);
    issue<SR>(r, r.used + NST - 1, tid);
    ++r.used;
    if (live) {
      const int row0 = s * SR;
      const int n = min(SR, rows - row0);
      const float* st = r.stage + buf * SR * r.pmax;
      const float* ins = in + row0 * (L + DQ_PAD);
      constexpr int UNROLL = TP_UNROLL > 0 ? TP_UNROLL : SR;
      if (n == SR) {
#pragma unroll UNROLL
        for (int q = 0; q < SR; ++q)
          row_fma<L, TC>(acc, st + q * P, ins, q, t);
      } else {
        for (int q = 0; q < n; ++q)
          row_fma<L, TC>(acc, st + q * P, ins, q, t);
      }
    }
    __syncwarp();
    if ((tid & 31) == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       smem_addr(r.empty + buf))
                   : "memory");
  }
  if (TP_CLOCKS && tid == 0) r.clk[seg] += clock64() - t0;
  if (need_sync) __syncthreads();
}

// ---- the modes of a fused loop ---------------------------------------------

// Lane compaction for the first half of exact-k, where a lane that is done
// is never read again: move the state of the lanes still running (the unset
// bits of `done`) down to slots 0, 1, ... so that whole groups of 8 slots
// fall idle and are skipped. A lane's arithmetic does not depend on its
// slot, so results do not change. Thread j moves column j of each of the NL
// leaves (swizzled [P][L] buffers); orig[s] (shared int[L]) follows with the
// lane each slot now holds. Returns the done mask of the new slots. Called
// by every thread of the block, outside an iteration.
template <int L, int NL>
__device__ __forceinline__ unsigned compact_lanes(unsigned done,
                                                  float* const (&leaves)[NL],
                                                  int* orig, int j) {
  constexpr unsigned ALL = L == 32 ? FULL : (1u << L) - 1u;
  const unsigned live = ~done & ALL;
  const int n = __popc(live);
  // nothing to gain while the idle slots already fill as many groups as
  // they can
  if (__popc(whole_groups<L>(done)) / 8 == (L - n) / 8) return done;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    int to = 0;
    for (int s = 0; s < L; ++s) {
      if (!bit(live, s)) continue;
      if (s != to) at<L>(leaves[l], j, to) = at<L>(leaves[l], j, s);
      ++to;
    }
  }
  if (j == 0) {
    int to = 0;
    for (int s = 0; s < L; ++s) {
      if (!bit(live, s)) continue;
      orig[to++] = orig[s];
    }
  }
  __syncthreads();
  return n == 32 ? 0u : ALL & ~((1u << n) - 1u);
}

// What lane t's keeper (thread t < L) holds of its lane.
struct Keeper {
  int k = 0;
  float rp = 3.4e38f, rd = 3.4e38f;  // "no residual yet"

  // The keeper's part of a checked iteration, run by all of warp 0: lane
  // tid's residuals r_p, r_d; the lanes in rmask record them and count kinc
  // iterations. Returns the mask of lanes that meet tol.
  __device__ __forceinline__ unsigned keep(int tid, int L, float r_p,
                                           float r_d, float tol_p,
                                           float tol_d, unsigned rmask,
                                           int kinc) {
    bool c = false;
    if (tid < L) {
      c = r_p <= tol_p && r_d <= tol_d;
      if (bit(rmask, tid)) {
        k += kinc;
        rp = r_p;
        rd = r_d;
      }
    }
    return __ballot_sync(FULL, c);
  }
};

// The modes (fixed_iters, exact-k, plain free-run, checked) over an engine E
// that offers
//   iterate<CHECK>(frozen, idle, last, stop, rmask, kinc) -> converged lanes
//   snapshot<TO_GLOBAL>(lanes), compact(done) (compact_lanes above, or the
//   identity), kp (the Keeper), sn_k and orig (shared int[L]: each lane's
//   window start, the lane a slot holds), tid.
// frozen lanes keep all their state; what idle lanes hold is never read
// again (an engine may stop working on them); the lanes in `last` (and, with
// stop, the lanes that converge here) keep the iterate they consumed.
// With WMIN (K2, whose residual oscillates) exact-k's windows end on the
// window's least residual: iterate returns the lanes that meet tol on every
// iteration, checked or not, and a lane is done once any iteration of its
// window met tol (min <= tol exactly when one of them is <= tol).
// Returns the done mask.
// The loops are one loop with two call sites of iterate (one checked, one
// not), each inlined once.
template <int L, bool WMIN = false, class E>
__device__ __forceinline__ unsigned run_modes(E& e, int k_max, int C,
                                              int exact_k, int fixed_iters) {
  constexpr unsigned ALL = L == 32 ? FULL : (1u << L) - 1u;
  enum { FIXED, WINDOW, REPLAY, FREE, CHECKED };
  const int tid = e.tid;
  int mode = fixed_iters > 0 ? FIXED
             : C > 1 ? (exact_k ? WINDOW : FREE)
                     : CHECKED;
  int it = 0;      // iterations begun (WINDOW, FREE: at the window's start)
  int f = 0;       // the iteration's place in its window
  int w = 0;       // REPLAY: the step
  int n_fast = 0;  // FREE: plain iterations before the checked one
  unsigned done = 0, convd = 0;
  unsigned wconv = 0;  // WMIN: the lanes that met tol in this window
  for (;;) {
    bool check = false, stop = false;
    unsigned frozen = 0, idle = 0, last = 0, rmask = 0;
    int kinc = 0;
    if (mode == FIXED) {
      // exactly fixed_iters plain iterations, no exit tests
      if (it >= fixed_iters) break;
      ++it;
    } else if (mode == WINDOW) {
      // exact-k, first half: free-run windows of C iterations; snapshot
      // every still-active lane at each window start, so the window a lane
      // converges in can be replayed with per-iteration checks once the
      // block has drained. Windows may overshoot k_max: the replay budget
      // cuts each lane off at exactly k_max.
      if (f == 0) {
        if (!(it < k_max && done != ALL)) {
          // replay each lane's last window from its snapshot, every lane
          // in its own slot again: k counts on from the window start
          if (tid < L) e.orig[tid] = tid;
          __syncthreads();
          e.template snapshot<false>(ALL);
          if (tid < L) e.kp.k = e.sn_k[tid];
          mode = REPLAY;
          continue;
        }
        done = e.compact(done);
        e.template snapshot<true>(~done & ALL);
        if (tid < L && !bit(done, tid)) e.sn_k[e.orig[tid]] = it;
      }
      // a lane that is done runs on only for its neighbours' sake: the
      // replay starts from its snapshot
      idle = done;
      check = f == C - 1;
    } else if (mode == REPLAY) {
      if (w >= C) break;
      unsigned over = 0;
#pragma unroll
      for (int b = 0; b < L; ++b) {
        const int budget = min(C, k_max - e.sn_k[b]);
        if (w >= budget) over |= 1u << b;
        if (w == budget - 1) last |= 1u << b;
      }
      frozen = convd | over;
      if (frozen == ALL) break;
      check = stop = true;
      rmask = ~frozen & ALL;
      kinc = 1;
    } else if (mode == FREE) {
      // plain free-run: C-1 plain iterations, then one checked iteration;
      // every lane keeps iterating until its group of 8 lanes is done, k is
      // recorded at check granularity, and a done lane's residuals stay at
      // its exit
      if (f == 0) {
        if (!(it < k_max && done != ALL)) break;
        n_fast = min(C - 1, k_max - 1 - it);
      }
      frozen = whole_groups<L>(done);
      check = f == n_fast;
      if (check) {
        rmask = ~done & ALL;
        kinc = n_fast + 1;
      }
    } else {
      // checked: exit tests every iteration; a converged lane freezes and
      // keeps the iterate it consumed at exit
      if (!(it < k_max && done != ALL)) break;
      frozen = done;
      last = it == k_max - 1 ? ALL : 0u;
      check = stop = true;
      rmask = ~done & ALL;
      kinc = 1;
    }
    unsigned conv = 0;
    if (check) {
      conv = e.template iterate<true>(frozen, idle, last, stop, rmask, kinc);
    } else {
      [[maybe_unused]] const unsigned c =
          e.template iterate<false>(frozen, idle, last, stop, rmask, kinc);
      if constexpr (WMIN) conv = c;
    }
    if constexpr (WMIN) {
      if (mode == WINDOW) conv = wconv |= conv;
    }
    if (mode == WINDOW || mode == FREE) {
      if (check) {
        wconv = 0;
        done |= conv;
        it += mode == WINDOW ? C : n_fast + 1;
        f = 0;
      } else {
        ++f;
      }
    } else if (mode == REPLAY) {
      convd |= conv & ~frozen;
      ++w;
    } else if (mode == CHECKED) {
      done |= conv;
      ++it;
    }
  }
  if (mode == FIXED) {
    e.kp.k = fixed_iters;
    done = ALL;
  } else if (mode == REPLAY) {
    done = convd;
  }
  return done;
}

// ---- engines on leaves, and refill ---------------------------------------
//
// TileEngine below is what csrc/fused_ellip.cu (K4), csrc/fused_soc.cu (K5),
// csrc/fused_hmpc.cu (K6) and csrc/fused_split.cu (K7) share: the state as
// leaves, the product's half of an iteration, the moves of a lane group's
// state, and run_lanes, which runs a block's modes with or without refill.
// K1 and K2 keep their own engines and take no refill.
//
// Refill. Every mode but fixed_iters ends per group of 8 lanes (a tile of
// tile_b = 8 in plain free-run; a lane's own exit in the checked mode and
// exact-k), and a wide block would otherwise run to its slowest group. With
// refill the blocks are persistent (about the SMs times the blocks an SM)
// and each block's L / 8 slots hold one group each: a slot whose group has
// ended takes the next group from a queue, an int32 counter the wrapper
// zeroes (a block's first groups are its own: blockIdx.x * G + slot). A
// group's arithmetic depends neither on its slot nor on the other groups,
// so the results are the same bits. In plain free-run each group counts its
// own iterations and its own k_max cut, and slots refill at window ends
// only, so every live group's checked iteration falls on the same block
// iteration; a group cut short by k_max waits, frozen, for the window's end.
// In the checked mode a slot refills once its 8 lanes are all frozen (both:
// run_refill). Exact-k refills for the kernels that opt in through
// run_lanes (K7, and the wide builds of K4-K7; run_refill_exact): its
// windows run as plain free-run's, every slot's windows starting together
// and each live lane's leaves and window start saved at each window start,
// and a slot refills once its
// group's 8 lanes have all met tol at a window's end or its windows have
// reached k_max; the block then replays the last window of every group it
// ran, from the lanes' snapshots, with per-iteration checks, a slot
// refilling once its 8 lanes are frozen. Window starts stay multiples of C
// from 0 for every lane, so each lane gets the bits of a block that keeps
// it from start to end. Once the queue (or the block's list of groups to
// replay) is empty the live groups move down into the first slots, so that
// the product's tiles narrow as in exact-k without refill. Without refill a
// block keeps its L lanes from start to end (run_modes: exact-k compacts the
// lanes still running and narrows the tiles); so do the narrow builds of
// K4-K6 in exact-k, and K4's fixed_iters. TP_REFILL 0 builds the narrow
// builds of K4-K6 without refill, for a timing script.

// A leaf of an engine's state: `rows` rows of L floats in shared memory
// (swizzled, chunk<L>), read from `in` and written to `out` ([B][rows] in
// global memory); snap_off is its offset in a lane's exact-k snapshot.
struct Leaf {
  float* sh;
  const float* in;
  float* out;
  int rows, snap_off;
};

// What a lane's keeper writes out besides the leaves.
struct LaneOut {
  int* k;
  int* done;
  float* rp;
  float* rd;
};

// An engine of NL leaves whose product adds acc = dq @ M to leaf 0 (P
// columns: leaf 0's rows). The kernel's engine derives from it, sets every
// member, and supplies iterate<CHECK>(frozen, idle, last, stop, rmask,
// kinc), which runs its element-wise half for the groups not in `dead` and
// returns product_half's result. In the moves of a lane group's state below
// thread tid owns row tid of every leaf, and with CPT > 1 (the wide builds
// of K4-K7: 512 threads over up to 1024 columns, whose tiles TC are
// wide enough that (L / 8) P / TC <= T) rows tid + c T, c < CPT, through
// the *_row forms; CPT = 1 keeps the text, and the code, of the builds of a
// thread a column.
template <int L, int TC, int SR, int NL, int CPT = 1>
struct TileEngine {
  static constexpr int G = L / 8;
  static constexpr unsigned ALL = L == 32 ? FULL : (1u << L) - 1u;
  Leaf leaf[NL];
  float* dq;          // [rows of M][L + DQ_PAD]
  float* red;         // [rwarps][2][L]
  unsigned* ctrl;     // [4]
  int *sn_k, *orig;   // exact-k: [L] each
  float* snap;        // exact-k: [B][snap_width]
  int snap_width;
  LaneOut out;
  Ring ring;
  Keeper kp;
  int tid, T, P, rwarps, lane0;  // threads, product columns, warps of
                                 // residuals, the static block's first lane
  float tol_p, tol_d;
  // TP_CLOCKS: thread 0's clocks from an iteration's start to the product's
  // first barrier (the element-wise half, waiting for the slowest warp),
  // and from there to the iteration's end
  long long t0 = 0, clk_ew = 0, clk_prod = 0;

  // The thread's c-th row (c < CPT).
  __device__ __forceinline__ int row(int c) const { return tid + c * T; }

  // Where an iteration starts (TP_CLOCKS).
  __device__ __forceinline__ void tic() {
    if (TP_CLOCKS && tid == 0) t0 = clock64();
  }

  // The block's counts, to queue[1 + b] (iterations) and, with TP_CLOCKS,
  // queue[1 + gridDim.x + 2 b + {0, 1}] (kilo-clocks of the two halves).
  __device__ __forceinline__ void count(int* queue, int iters) {
    if (tid != 0) return;
    queue[1 + blockIdx.x] = iters;
    if (TP_CLOCKS) {
      int* c = queue + 1 + gridDim.x + 2 * blockIdx.x;
      c[0] = static_cast<int>(clk_ew >> 10);
      c[1] = static_cast<int>(clk_prod >> 10);
    }
  }

  // The iteration's second half: the product with the widest tiles the live
  // groups allow (narrower once they are the block's first half or quarter),
  // the keepers' part after its first barrier, and leaf 0 += acc.
  template <bool CHECK>
  __device__ __forceinline__ unsigned product_half(unsigned dead,
                                                   unsigned frozen,
                                                   unsigned last, bool stop,
                                                   unsigned rmask, int kinc) {
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

  template <int TCX, bool CHECK>
  __device__ __forceinline__ unsigned finish(unsigned dead, unsigned frozen,
                                             unsigned last, bool stop,
                                             unsigned rmask, int kinc) {
    const Tile<L, TCX> tile(tid, P);
    float acc[TCX][8];
#pragma unroll
    for (int q = 0; q < TCX; ++q) {
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[q][b] = 0.0f;
    }
    const bool live = tile.active && !bit(dead, 8 * tile.lg);
    long long t1 = 0;
    product<L, TCX, SR>(ring, dq, tile, acc, live, tid, T, CHECK, [&]() {
      if (TP_CLOCKS && tid == 0) {
        t1 = clock64();
        clk_ew += t1 - t0;
      }
      if (CHECK && tid < 32) {
        float r_p = 0.0f, r_d = 0.0f;
        if (tid < L) {
          r_p = lane_max<L>(red, rwarps, 0, tid);
          r_d = lane_max<L>(red, rwarps, 1, tid);
        }
        const unsigned m = kp.keep(tid, L, r_p, r_d, tol_p, tol_d, rmask,
                                   kinc);
        if (tid == 0) ctrl[0] = m;
      }
    });
    if (live) {
      unsigned skip = (frozen | last) >> (tile.lg * 8);
      if (CHECK && stop) skip |= ctrl[0] >> (tile.lg * 8);
      float* x = leaf[0].sh;
#pragma unroll
      for (int q = 0; q < TCX; ++q) {
        float v[8];
        ld8<L>(v, x, tile.col(q), tile.lg);
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (!bit(skip, b)) v[b] = v[b] + acc[q][b];
        st8<L>(x, tile.col(q), tile.lg, v);
      }
    }
    __syncthreads();
    if (TP_CLOCKS && tid == 0) clk_prod += clock64() - t1;
    return CHECK ? ctrl[0] : 0u;
  }

  // Slot g's 8 lanes of every leaf from (TO_SHARED) or to global lanes
  // lane0 .. lane0 + 7; each thread moves its own row.
  template <bool TO_SHARED>
  __device__ __forceinline__ void move8(int g, int lane0_) {
    if constexpr (CPT > 1) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) move8_row<TO_SHARED>(g, lane0_, row(c));
    } else {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const Leaf& f = leaf[l];
        if (tid >= f.rows) continue;
        float v[8];
        if (TO_SHARED) {
#pragma unroll
          for (int b = 0; b < 8; ++b)
            v[b] = f.in[static_cast<size_t>(lane0_ + b) * f.rows + tid];
          st8<L>(f.sh, tid, g, v);
        } else {
          ld8<L>(v, f.sh, tid, g);
#pragma unroll
          for (int b = 0; b < 8; ++b)
            f.out[static_cast<size_t>(lane0_ + b) * f.rows + tid] = v[b];
        }
      }
    }
  }

  // move8 of row r.
  template <bool TO_SHARED>
  __device__ __forceinline__ void move8_row(int g, int lane0_, int r) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const Leaf& f = leaf[l];
      if (r >= f.rows) continue;
      float v[8];
      if (TO_SHARED) {
#pragma unroll
        for (int b = 0; b < 8; ++b)
          v[b] = f.in[static_cast<size_t>(lane0_ + b) * f.rows + r];
        st8<L>(f.sh, r, g, v);
      } else {
        ld8<L>(v, f.sh, r, g);
#pragma unroll
        for (int b = 0; b < 8; ++b)
          f.out[static_cast<size_t>(lane0_ + b) * f.rows + r] = v[b];
      }
    }
  }

  // Slot g's lanes out to global lanes lane0 .. lane0 + 7, the keepers'
  // records with them (`done`: the block's done mask).
  __device__ __forceinline__ void write8(int g, int lane0_, unsigned done) {
    move8<false>(g, lane0_);
    if (tid >= 8 * g && tid < 8 * g + 8) {
      const int lane = lane0_ + tid - 8 * g;
      out.k[lane] = kp.k;
      out.done[lane] = bit(done, tid) ? 1 : 0;
      out.rp[lane] = kp.rp;
      out.rd[lane] = kp.rd;
    }
  }

  // Slot g takes global lanes lane0 .. lane0 + 7, its keepers start afresh.
  __device__ __forceinline__ void read8(int g, int lane0_) {
    move8<true>(g, lane0_);
    if (tid >= 8 * g && tid < 8 * g + 8) kp = Keeper{};
  }

  // Slot `from`'s lanes move to slot `to` (each thread its rows; the
  // keepers by shuffles in warp 0). Called by every thread.
  __device__ __forceinline__ void slot_move(int from, int to) {
    if constexpr (CPT > 1) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          const Leaf& f = leaf[l];
          if (row(c) >= f.rows) continue;
          float v[8];
          ld8<L>(v, f.sh, row(c), from);
          st8<L>(f.sh, row(c), to, v);
        }
      }
    } else {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const Leaf& f = leaf[l];
        if (tid >= f.rows) continue;
        float v[8];
        ld8<L>(v, f.sh, tid, from);
        st8<L>(f.sh, tid, to, v);
      }
    }
    if (tid < 32) {
      const bool mine = tid >= 8 * to && tid < 8 * to + 8;
      const int src = mine ? tid + 8 * (from - to) : tid;
      Keeper k2;
      k2.k = __shfl_sync(FULL, kp.k, src);
      k2.rp = __shfl_sync(FULL, kp.rp, src);
      k2.rd = __shfl_sync(FULL, kp.rd, src);
      if (mine) kp = k2;
    }
  }

  // The exact-k compaction of csrc/tile_product.cuh's compact_lanes, over
  // leaves of their own row counts.
  __device__ __forceinline__ unsigned compact(unsigned done) {
    const unsigned live = ~done & ALL;
    const int n = __popc(live);
    if (__popc(whole_groups<L>(done)) / 8 == (L - n) / 8) return done;
    if constexpr (CPT > 1) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          if (row(c) >= leaf[l].rows) continue;
          int to = 0;
          for (int s = 0; s < L; ++s) {
            if (!bit(live, s)) continue;
            if (s != to)
              at<L>(leaf[l].sh, row(c), to) = at<L>(leaf[l].sh, row(c), s);
            ++to;
          }
        }
      }
    } else {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if (tid >= leaf[l].rows) continue;
        int to = 0;
        for (int s = 0; s < L; ++s) {
          if (!bit(live, s)) continue;
          if (s != to) at<L>(leaf[l].sh, tid, to) = at<L>(leaf[l].sh, tid, s);
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

  // Exact-k: each thread's rows of every leaf between shared memory and the
  // lanes' snapshots, for the slots in `lanes` (slot b holds lane orig[b]).
  template <bool TO_GLOBAL>
  __device__ __forceinline__ void snapshot(unsigned lanes) {
    if constexpr (CPT > 1) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) snapshot_row<TO_GLOBAL>(lanes, row(c));
    } else {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if (tid >= leaf[l].rows) continue;
        for (int b = 0; b < L; ++b) {
          if (!bit(lanes, b)) continue;
          float* g = snap +
                     static_cast<size_t>(lane0 + orig[b]) * snap_width +
                     leaf[l].snap_off + tid;
          float& sh = at<L>(leaf[l].sh, tid, b);
          if (TO_GLOBAL)
            *g = sh;
          else
            sh = *g;
        }
      }
    }
    // an engine may read rows other threads restored
    if (!TO_GLOBAL) __syncthreads();
  }

  // snapshot's moves of row r.
  template <bool TO_GLOBAL>
  __device__ __forceinline__ void snapshot_row(unsigned lanes, int r) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (r >= leaf[l].rows) continue;
      for (int b = 0; b < L; ++b) {
        if (!bit(lanes, b)) continue;
        float* g = snap +
                   static_cast<size_t>(lane0 + orig[b]) * snap_width +
                   leaf[l].snap_off + r;
        float& sh = at<L>(leaf[l].sh, r, b);
        if (TO_GLOBAL)
          *g = sh;
        else
          sh = *g;
      }
    }
  }

  // Exact-k with refill: slot g's lanes in `lanes` (8 bits) of every leaf to
  // (TO_GLOBAL) or from the snapshots of global lanes lane0 .. lane0 + 7;
  // each thread moves its own rows.
  template <bool TO_GLOBAL>
  __device__ __forceinline__ void snap8(int g, int lane0_, unsigned lanes) {
    if constexpr (CPT > 1) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        snap8_row<TO_GLOBAL>(g, lane0_, lanes, row(c));
    } else {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const Leaf& f = leaf[l];
        if (tid >= f.rows) continue;
        float* s0 = snap + static_cast<size_t>(lane0_) * snap_width +
                    f.snap_off + tid;
        float v[8];
        if (TO_GLOBAL) {
          ld8<L>(v, f.sh, tid, g);
#pragma unroll
          for (int b = 0; b < 8; ++b)
            if (bit(lanes, b)) s0[static_cast<size_t>(b) * snap_width] = v[b];
        } else {
#pragma unroll
          for (int b = 0; b < 8; ++b)
            v[b] = s0[static_cast<size_t>(b) * snap_width];
          st8<L>(f.sh, tid, g, v);
        }
      }
    }
  }

  // snap8 of row r.
  template <bool TO_GLOBAL>
  __device__ __forceinline__ void snap8_row(int g, int lane0_, unsigned lanes,
                                            int r) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const Leaf& f = leaf[l];
      if (r >= f.rows) continue;
      float* s0 =
          snap + static_cast<size_t>(lane0_) * snap_width + f.snap_off + r;
      float v[8];
      if (TO_GLOBAL) {
        ld8<L>(v, f.sh, r, g);
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (bit(lanes, b)) s0[static_cast<size_t>(b) * snap_width] = v[b];
      } else {
#pragma unroll
        for (int b = 0; b < 8; ++b)
          v[b] = s0[static_cast<size_t>(b) * snap_width];
        st8<L>(f.sh, r, g, v);
      }
    }
  }

  // Exact-k with refill: slot g takes the snapshots of global lanes lane0 ..
  // lane0 + 7 for their replay; their keepers start from their window
  // starts wk[lane], which sn_k[8 g + b] holds for every thread.
  __device__ __forceinline__ void restore8(int g, int lane0_, const int* wk) {
    snap8<false>(g, lane0_, 0xffu);
    if (tid >= 8 * g && tid < 8 * g + 8) {
      kp = Keeper{};
      kp.k = wk[lane0_ + tid - 8 * g];
      sn_k[tid] = kp.k;
    }
  }
};

// Once no group is left to take: the live groups (grp >= 0) move down into
// the first slots, with their counts `it` and their lanes' bits of `done`
// and `ended`, so that the product's tiles narrow; with sn_k (exact-k's
// replay) each slot's window starts in e.sn_k too, each moved by the thread
// of its slot. Every thread moves its own rows; the caller publishes them
// with a barrier.
template <int G, class E>
__device__ __forceinline__ void pack_slots(E& e, int (&grp)[G], int (&it)[G],
                                           unsigned& done, unsigned& ended,
                                           bool sn_k) {
#pragma unroll
  for (int d = 0; d < G; ++d) {
    if (grp[d] >= 0) continue;
#pragma unroll
    for (int s = d + 1; s < G; ++s) {
      if (grp[s] < 0) continue;
      e.slot_move(s, d);
      if (sn_k && e.tid >= 8 * d && e.tid < 8 * d + 8)
        e.sn_k[e.tid] = e.sn_k[e.tid + 8 * (s - d)];
      grp[d] = grp[s];
      it[d] = it[s];
      grp[s] = -1;
      const unsigned from = 0xffu << (8 * s), to = 0xffu << (8 * d);
      done = (done & ~to) | (((done & from) >> (8 * (s - d))));
      done &= ~from;
      ended = (ended & ~to) | from;
      break;
    }
  }
}

// The refill loop of plain free-run (C > 1) and the checked mode (C == 1)
// over n_groups groups of 8 lanes (see Refill above): queue[0] hands out the
// groups, and the block's counts go to the rest (TileEngine::count).
// Returns when every group this block took is written out.
template <int L, class E>
__device__ __forceinline__ void run_refill(E& e, int k_max, int C,
                                           int n_groups, int* queue) {
  constexpr int G = L / 8;
  constexpr unsigned ALL = L == 32 ? FULL : (1u << L) - 1u;
  const bool free_run = C > 1;
  int grp[G], it[G], nf[G];  // a slot's group (-1: none), its iterations
                             // begun (free-run: at its window's start), the
                             // plain iterations before its checked one
#pragma unroll
  for (int g = 0; g < G; ++g) {
    grp[g] = -1;
    it[g] = 0;
    nf[g] = 0;
  }
  unsigned done = 0;    // lanes whose exit test has passed
  unsigned ended = ALL; // lanes of slots whose group has ended, or no group
  bool first = true, dry = false;
  int f = 0;            // free-run: the iteration's place in its window
  int iters = 0;        // the block's iterations
  for (;;) {
    if (!free_run || f == 0) {
      if (ended) {
        // the slots whose group has ended write it out and take the next
        int need = 0;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (!bit(ended, 8 * g)) continue;
          if (grp[g] >= 0) e.write8(g, 8 * grp[g], done);
          grp[g] = -1;
          ++need;
        }
        if (!dry) {
          int base;
          if (first) {
            base = blockIdx.x * G;
          } else {
            if (e.tid == 0)
              e.ctrl[1] = static_cast<unsigned>(
                  gridDim.x * G + atomicAdd(queue, need));
            __syncthreads();
            base = static_cast<int>(e.ctrl[1]);
          }
          first = false;
          int i = 0;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (!bit(ended, 8 * g)) continue;
            const int n = base + i++;
            if (n >= n_groups) {  // the queue's groups follow a block's own
              dry = true;
              continue;
            }
            grp[g] = n;
            it[g] = 0;
            e.read8(g, 8 * n);
            const unsigned lanes = 0xffu << (8 * g);
            ended &= ~lanes;
            done &= ~lanes;
          }
        }
        if (dry) pack_slots<G>(e, grp, it, done, ended, false);
        // the rows a thread moved, before others read them
        __syncthreads();
      }
      if (ended == ALL) break;
      if (free_run) {
#pragma unroll
        for (int g = 0; g < G; ++g) nf[g] = min(C - 1, k_max - 1 - it[g]);
      }
    }
    unsigned frozen, last = 0, rmask, check_lanes = 0;
    if (free_run) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (grp[g] >= 0 && !bit(ended, 8 * g) && nf[g] == f)
          check_lanes |= 0xffu << (8 * g);
      frozen = ended | whole_groups<L>(done);
      rmask = check_lanes & ~done;
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (grp[g] >= 0 && it[g] == k_max - 1) last |= 0xffu << (8 * g);
      frozen = done | ended;
      check_lanes = ~frozen & ALL;
      rmask = check_lanes;
    }
    ++iters;
    unsigned conv = 0;
    if (!free_run || check_lanes)
      conv = e.template iterate<true>(frozen, 0u, last, !free_run, rmask,
                                      free_run ? f + 1 : 1);
    else
      e.template iterate<false>(frozen, 0u, 0u, false, 0u, 0);
    done |= conv & check_lanes;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const unsigned lanes = 0xffu << (8 * g);
      if (!(check_lanes & lanes)) continue;
      it[g] += free_run ? nf[g] + 1 : 1;
      if ((done & lanes) == lanes || it[g] >= k_max) ended |= lanes;
    }
    if (free_run) {
      // the window ends after its C-th iteration, or once no live group is
      // left in it
      bool any = false;
#pragma unroll
      for (int g = 0; g < G; ++g) any = any || !bit(ended, 8 * g);
      f = (f == C - 1 || !any) ? 0 : f + 1;
    }
  }
  ring_drain(e.ring);
  e.count(queue, iters);
}

// Exact-k with refill (see Refill above) over n_groups groups of 8 lanes:
// queue[0] hands out the groups for their windows, wk ([B], global) takes
// each lane's window start, and link ([n_groups]) chains the groups a block
// ran, the latest first, for its replay; the block's counts go to the rest
// of the queue (TileEngine::count). One loop over both passes, with two
// call sites of iterate (one checked, one not), each inlined once. Returns
// when every group this block took is written out.
template <int L, class E>
__device__ __forceinline__ void run_refill_exact(E& e, int k_max, int C,
                                                 int n_groups, int* queue,
                                                 int* wk, int* link) {
  constexpr int G = L / 8;
  constexpr unsigned ALL = L == 32 ? FULL : (1u << L) - 1u;
  int grp[G], it[G];  // a slot's group (-1: none), its iterations begun:
                      // at its window's start (windows), in its replay
#pragma unroll
  for (int g = 0; g < G; ++g) {
    grp[g] = -1;
    it[g] = 0;
  }
  unsigned done = 0;     // windows: lanes whose window met tol; replay:
                         // lanes that met tol
  unsigned ended = ALL;  // lanes of slots whose group has ended, or no group
  bool replay = false, first = true, dry = false;
  int f = 0;             // windows: the iteration's place in its window
  int iters = 0;         // the block's iterations
  int head = -1;         // windows: the group taken last; replay: the next
  for (;;) {
    if (replay || f == 0) {
      if (ended) {
        // the slots whose group has ended (replay: write it out) take the
        // next: from the queue for its windows, from the block's chain for
        // its replay
        int need = 0;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (!bit(ended, 8 * g)) continue;
          if (replay && grp[g] >= 0) e.write8(g, 8 * grp[g], done);
          grp[g] = -1;
          ++need;
        }
        if (!dry) {
          int base = 0;
          if (!replay) {
            if (first) {
              base = blockIdx.x * G;
            } else {
              if (e.tid == 0)
                e.ctrl[1] = static_cast<unsigned>(
                    gridDim.x * G + atomicAdd(queue, need));
              __syncthreads();
              base = static_cast<int>(e.ctrl[1]);
            }
            first = false;
          }
          int i = 0;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (!bit(ended, 8 * g)) continue;
            int n;
            if (replay) {
              n = head;
              if (n < 0) {
                dry = true;
                continue;
              }
              head = link[n];
              e.restore8(g, 8 * n, wk);
            } else {
              n = base + i++;
              if (n >= n_groups) {  // the queue's groups follow a block's own
                dry = true;
                continue;
              }
              e.read8(g, 8 * n);
              if (e.tid == 0) link[n] = head;
              head = n;
            }
            grp[g] = n;
            it[g] = 0;
            const unsigned lanes = 0xffu << (8 * g);
            ended &= ~lanes;
            done &= ~lanes;
          }
        }
        if (dry) pack_slots<G>(e, grp, it, done, ended, replay);
        // the rows a thread moved, before others read them
        __syncthreads();
      }
      if (ended == ALL) {
        if (replay) break;
        // every group this block took has ended its windows: replay them
        replay = true;
        dry = false;
        continue;
      }
      if (!replay) {
        // a window starts: each live lane that has not met tol saves its
        // leaves and its window start
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (bit(ended, 8 * g)) continue;
          const unsigned lanes = ~(done >> (8 * g)) & 0xffu;
          e.template snap8<true>(g, 8 * grp[g], lanes);
          const int b = e.tid - 8 * g;
          if (b >= 0 && b < 8 && bit(lanes, b)) wk[8 * grp[g] + b] = it[g];
        }
      }
    }
    unsigned frozen, idle = 0, last = 0, rmask = 0;
    bool check;
    if (replay) {
      // each lane's last window again, with per-iteration checks and the
      // budget min(C, k_max - its window start): k counts on from there
      unsigned over = 0;
#pragma unroll
      for (int b = 0; b < L; ++b) {
        const int budget = min(C, k_max - e.sn_k[b]);
        if (it[b >> 3] >= budget) over |= 1u << b;
        if (it[b >> 3] == budget - 1) last |= 1u << b;
      }
      frozen = done | ended | over;
      rmask = ~frozen & ALL;
      check = true;
    } else {
      // a lane that has met tol runs on only for its neighbours' sake: its
      // replay starts from its snapshot
      frozen = ended;
      idle = done;
      check = f == C - 1;
    }
    ++iters;
    unsigned conv = 0;
    if (check)
      conv = e.template iterate<true>(frozen, idle, last, replay, rmask,
                                      replay ? 1 : 0);
    else
      e.template iterate<false>(frozen, idle, 0u, false, 0u, 0);
    if (replay) {
      done |= conv & rmask;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (bit(ended, 8 * g)) continue;
        ++it[g];
        bool all = true;
#pragma unroll
        for (int b = 8 * g; b < 8 * g + 8; ++b)
          all = all && (bit(done, b) || it[g] >= min(C, k_max - e.sn_k[b]));
        if (all) ended |= 0xffu << (8 * g);
      }
    } else if (check) {
      done |= conv & ~ended;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const unsigned lanes = 0xffu << (8 * g);
        if (ended & lanes) continue;
        it[g] += C;
        if ((done & lanes) == lanes || it[g] >= k_max) ended |= lanes;
      }
      f = 0;
    } else {
      ++f;
    }
  }
  ring_drain(e.ring);
  e.count(queue, iters);
}

// A block's whole run: with REFILL run_refill, or with EXACT (a kernel
// built for exact-k with refill, wk its scratch of window starts and
// links: [B + B / 8] int32) run_refill_exact; else the block's L lanes
// from blockIdx.x * L, through run_modes (fixed_iters > 0 there: exactly
// that many plain iterations, K4's fourth mode). A kernel is built for
// each, so that each holds one loop (two inlined iterations) and not two.
template <int L, bool REFILL, bool EXACT = false, class E>
__device__ __forceinline__ void run_lanes(E& e, int k_max, int C,
                                          int exact_k, int n_groups,
                                          int* queue, int fixed_iters = 0,
                                          int* wk = nullptr) {
  constexpr int G = L / 8;
  if constexpr (REFILL && EXACT) {
    run_refill_exact<L>(e, k_max, C, n_groups, queue, wk, wk + 8 * n_groups);
  } else if constexpr (REFILL) {
    run_refill<L>(e, k_max, C, n_groups, queue);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) e.read8(g, e.lane0 + 8 * g);
    if (e.tid < L) {
      e.sn_k[e.tid] = 0;
      e.orig[e.tid] = e.tid;
    }
    __syncthreads();
    const unsigned done = run_modes<L>(e, k_max, C, exact_k, fixed_iters);
    ring_drain(e.ring);
#pragma unroll
    for (int g = 0; g < G; ++g) e.write8(g, e.lane0 + 8 * g, done);
    if (TP_CLOCKS) e.count(queue, 0);
  }
}

}  // namespace tp
