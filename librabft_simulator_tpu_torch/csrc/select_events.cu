// Batched event selection for the serial engine, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// librabft_simulator_tpu/ops/pallas_queue.py::select_events (body
// _select_kernel): per row, the lexicographic argmin over (time asc, kind
// desc, stamp asc, column asc), returning the winning column and the row's
// minimum time.  Two entries share one device body:
//
//   select_events_launch        int32 [B, M] (times, kinds, stamps): the TPU
//                               kernel's own contract.
//   select_queue_events_launch  the engine's queue and timers read in place:
//                               bool valid [B, cm], int32 time/kind/stamp
//                               [B, cm] and int32 timer time/stamp [B, n].
//                               Columns 0..cm-1 are messages (time NEVER where
//                               !valid; kind and stamp as stored, stale or
//                               not), columns cm..cm+n-1 the timers (kind =
//                               kind_timer).  The [B, cm + n] concatenation
//                               is never built.
//
// Every operand has unit column stride and its own row stride (in
// elements), at least its width: the engine's queue leaves are [B, cm]
// views of [B, cm + 1] buffers (row stride 65 at queue_cap 64).
//
// Bound: bytes.  Each operand is read once and only idx and t_min are
// written (8.7 MB per launch for the queue entry at B = 10,000, cm = 64,
// n = 4); a handful of integer compares per element is far below the
// card's operation rate.
//
// Design:
// - One block per tile of TILE_ROWS (32) consecutive rows.  In every operand
//   a tile is one contiguous span of TILE_ROWS * row_stride * elem bytes, so
//   one TMA 1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx) per
//   operand brings the whole tile into shared memory, issued by one thread
//   and completing on the block's mbarrier.  TILE_ROWS is a multiple of 16,
//   so with 16-byte aligned base pointers (the wrapper checks them) every
//   span starts and ends on a 16-byte boundary, the 65-byte bool rows
//   included.  At B = 10,000 the 313 blocks are resident at once, so every
//   tile's copies are in flight together.
// - The last tile's span stops at its last element: past it, the last
//   row's padding may lie outside the tensor's storage.  Its bulk copy takes
//   the span rounded up to 16 bytes where the storage reaches that far (the
//   engine's [B, cm + 1] buffers do), else rounded down; then warp 0 copies
//   the remaining 0-15 bytes with plain loads before lane 0 arrives on the
//   barrier (the arrival releases them to the waiting threads).  Every
//   other tile's span ends at the first element of the next tile's first
//   row, so it lies inside the storage.
// - Rows too wide for a tile in shared memory are read with plain loads
//   from device memory instead (the same reduction, no staging).
// - LANES threads per row (4), each visiting a quarter of the columns, then
//   two __shfl_xor_sync rounds.  Lane q of row r visits column (j + rot(r)) mod
//   cols for j = q, q + LANES, ...; with rot(r) = r * (LANES - S) mod 32 for
//   row stride S, the 32 lanes of a warp read 32 distinct banks for any
//   stride (65 in place, 64 at the first step, 68 for [B, 68] rows), and the
//   bool rows at the same stride share words without conflicts.  The
//   comparator is a strict total order, so neither the visiting order nor
//   the reduction tree changes the winner.
//
// The winner equals select_events_reference's for every kind >= -1 (the
// engine's kinds 0..3): a lane with no column holds a sentinel that every
// real column beats.
//
// C entry points (loaded with ctypes): launch on the given stream, do not
// synchronise, allocate nothing, and return cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Tile height and threads per row.
constexpr int TILE_ROWS = 32;
constexpr int LANES = 4;
constexpr int THREADS = TILE_ROWS * LANES;
// The block's mbarrier sits at the start of its dynamic shared memory; the
// tile's stage follows at this offset.
constexpr int STAGE_OFFSET = 128;
constexpr int NEVER = INT_MAX;
static_assert(TILE_ROWS % 16 == 0, "bulk copies need 16-byte multiples");
static_assert(THREADS % 32 == 0 && 32 % LANES == 0, "rows must not straddle warps");

struct Args {
  const uint8_t* valid;   // null for the [B, M] entry
  const int* time;
  const int* kind;
  const int* stamp;
  const int* timer_time;  // null for the [B, M] entry
  const int* timer_stamp;
  long long s_valid, s_time, s_kind, s_stamp, s_ttime, s_tstamp;  // row strides
  // Bytes from each operand's first element to the end of its storage.
  long long n_valid, n_time, n_kind, n_stamp, n_ttime, n_tstamp;
  int* idx;
  int* t_min;
  int rows, cols, timers, kind_timer;
  int tiles;    // ceil(rows / TILE_ROWS)
  bool staged;  // tiles pass through shared memory (else plain loads)
  // Byte offsets of each operand's span within the stage.
  unsigned off_valid, off_time, off_kind, off_stamp, off_ttime, off_tstamp;
};

// The comparator, without branches: lanes of a warp disagree on it all the
// time, and a branchy chain would split them.
__device__ __forceinline__ bool better(int t, int k, int s, int c,
                                       int bt, int bk, int bs, int bc) {
  return (t < bt) | ((t == bt) & ((k > bk) | ((k == bk) & ((s < bs) | ((s == bs) & (c < bc))))));
}

// Keep (t, k, s, c) if it beats the best so far (selects, not branches).
__device__ __forceinline__ void keep(int t, int k, int s, int c,
                                     int& bt, int& bk, int& bs, int& bc) {
  const bool w = better(t, k, s, c, bt, bk, bs, bc);
  bt = w ? t : bt;
  bk = w ? k : bk;
  bs = w ? s : bs;
  bc = w ? c : bc;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Warp 0: lane 0 arms the block's barrier with the tile's byte count and
// issues one bulk copy per operand; the lanes copy the last tile's
// sub-16-byte tails (if any) with plain loads; lane 0 arrives.
template <bool QUEUE>
__device__ void issue_tile(const Args& a, unsigned char* stage, uint32_t bar,
                           int tile) {
  const int lane = threadIdx.x;
  const long long row0 = (long long)tile * TILE_ROWS;
  const bool last = tile == a.tiles - 1;
  const int nrows = last ? (int)(a.rows - row0) : TILE_ROWS;
  const unsigned offs[6] = {a.off_time, a.off_kind, a.off_stamp,
                            a.off_valid, a.off_ttime, a.off_tstamp};
  const unsigned char* srcs[6] = {
      reinterpret_cast<const unsigned char*>(a.time + row0 * a.s_time),
      reinterpret_cast<const unsigned char*>(a.kind + row0 * a.s_kind),
      reinterpret_cast<const unsigned char*>(a.stamp + row0 * a.s_stamp),
      QUEUE ? a.valid + row0 * a.s_valid : nullptr,
      QUEUE ? reinterpret_cast<const unsigned char*>(a.timer_time + row0 * a.s_ttime) : nullptr,
      QUEUE ? reinterpret_cast<const unsigned char*>(a.timer_stamp + row0 * a.s_tstamp) : nullptr};
  // Bytes the tile needs from each operand (whole rows; for the last tile,
  // up to its last element) and the part a bulk copy takes: rounded up to
  // 16 where the storage reaches that far, else down.
  unsigned need[6], bulk[6];
  auto span = [&](int i, long long stride, int width, int elem, long long avail) {
    if (!QUEUE && i >= 3) { need[i] = bulk[i] = 0; return; }
    const long long n = (last ? (nrows - 1) * stride + width : TILE_ROWS * stride) * elem;
    const long long up = (n + 15) & ~15LL;
    need[i] = (unsigned)n;
    bulk[i] = (unsigned)(up <= avail - row0 * stride * elem ? up : n & ~15LL);
  };
  span(0, a.s_time, a.cols, 4, a.n_time);
  span(1, a.s_kind, a.cols, 4, a.n_kind);
  span(2, a.s_stamp, a.cols, 4, a.n_stamp);
  span(3, a.s_valid, a.cols, 1, a.n_valid);
  span(4, a.s_ttime, a.timers, 4, a.n_ttime);
  span(5, a.s_tstamp, a.timers, 4, a.n_tstamp);
  if (lane == 0) {
    unsigned total = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) total += bulk[i];
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(total) : "memory");
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (bulk[i]) bulk_copy(stage + offs[i], srcs[i], bulk[i], bar);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    for (unsigned b = bulk[i] + lane; b < need[i]; b += 32) stage[offs[i] + b] = srcs[i][b];
  __syncwarp();
  if (lane == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Reduce rows [row0, row0 + nrows) whose operands start at the given
// pointers (a shared-memory stage or the tensors themselves).  Every thread
// of the block takes part: rows past nrows hold the sentinel and write
// nothing, so the shuffles run with full warps.
template <bool QUEUE>
__device__ __forceinline__ void reduce_rows(
    const Args& a, const uint8_t* v, const int* t, const int* k, const int* s,
    const int* tt, const int* ts, long long row0, int nrows) {
  const int r = threadIdx.x / LANES;
  const int q = threadIdx.x % LANES;
  const bool live = r < nrows;
  const int cols = live ? a.cols : 0;
  int rot = (int)(((long long)r * (LANES - a.s_time)) & 31);
  if (rot >= cols) rot = cols ? rot % cols : 0;
  const int* tr = t + r * a.s_time;
  const int* kr = k + r * a.s_kind;
  const int* sr = s + r * a.s_stamp;
  const uint8_t* vr = QUEUE ? v + r * a.s_valid : nullptr;
  int bt = INT_MAX, bk = INT_MIN, bs = INT_MAX, bc = INT_MAX;
#pragma unroll 4
  for (int j = q; j < cols; j += LANES) {
    int c = j + rot;
    if (c >= cols) c -= cols;
    int tv = tr[c];
    if (QUEUE) tv = vr[c] ? tv : NEVER;  // stale kind and stamp still count
    keep(tv, kr[c], sr[c], c, bt, bk, bs, bc);
  }
  if (QUEUE) {
    const int timers = live ? a.timers : 0;
    const int* ttr = tt + r * a.s_ttime;
    const int* tsr = ts + r * a.s_tstamp;
    for (int j = q; j < timers; j += LANES) {
      keep(ttr[j], a.kind_timer, tsr[j], a.cols + j, bt, bk, bs, bc);
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    const int t2 = __shfl_xor_sync(0xffffffffu, bt, off);
    const int k2 = __shfl_xor_sync(0xffffffffu, bk, off);
    const int s2 = __shfl_xor_sync(0xffffffffu, bs, off);
    const int c2 = __shfl_xor_sync(0xffffffffu, bc, off);
    keep(t2, k2, s2, c2, bt, bk, bs, bc);
  }
  if (live && q == 0) {
    a.idx[row0 + r] = bc;
    a.t_min[row0 + r] = bt;
  }
}

template <bool QUEUE>
__global__ void __launch_bounds__(THREADS)
select_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile = blockIdx.x;
  const long long row0 = (long long)tile * TILE_ROWS;
  const int nrows = (int)min((long long)TILE_ROWS, a.rows - row0);
  if (!a.staged) {
    reduce_rows<QUEUE>(
        a, QUEUE ? a.valid + row0 * a.s_valid : nullptr,
        a.time + row0 * a.s_time, a.kind + row0 * a.s_kind,
        a.stamp + row0 * a.s_stamp,
        QUEUE ? a.timer_time + row0 * a.s_ttime : nullptr,
        QUEUE ? a.timer_stamp + row0 * a.s_tstamp : nullptr, row0, nrows);
    return;
  }
  unsigned char* stage = smem + STAGE_OFFSET;
  const uint32_t bar = smem_addr(smem);
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    issue_tile<QUEUE>(a, stage, bar, tile);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  reduce_rows<QUEUE>(
      a, reinterpret_cast<const uint8_t*>(stage + a.off_valid),
      reinterpret_cast<const int*>(stage + a.off_time),
      reinterpret_cast<const int*>(stage + a.off_kind),
      reinterpret_cast<const int*>(stage + a.off_stamp),
      reinterpret_cast<const int*>(stage + a.off_ttime),
      reinterpret_cast<const int*>(stage + a.off_tstamp), row0, nrows);
}

template <bool QUEUE>
int launch(Args a, void* stream) {
  if (a.rows <= 0) return 0;
  a.tiles = (a.rows + TILE_ROWS - 1) / TILE_ROWS;
  long long off = 0;  // (wide rows can pass 32 bits; they are not staged)
  auto span = [&](unsigned& slot, long long stride, int elem, bool used) {
    slot = (unsigned)off;
    if (used) off += TILE_ROWS * stride * elem;
  };
  span(a.off_time, a.s_time, 4, true);
  span(a.off_kind, a.s_kind, 4, true);
  span(a.off_stamp, a.s_stamp, 4, true);
  span(a.off_ttime, a.s_ttime, 4, QUEUE);
  span(a.off_tstamp, a.s_tstamp, 4, QUEUE);
  span(a.off_valid, a.s_valid, 1, QUEUE);
  const long long staged_smem = STAGE_OFFSET + off;

  // Stage the tile when it fits the block's shared memory (the kernel has no
  // static shared memory, so the opt-in limit is all of it); above the
  // default 48 KB the kernel opts in to that limit.
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return (int)err;
  a.staged = staged_smem <= limit;
  const size_t smem = a.staged ? (size_t)staged_smem : 0;
  auto kernel = select_kernel<QUEUE>;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit)))
    return (int)err;
  kernel<<<a.tiles, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int select_events_launch(
    const void* times, long long s_time, long long n_time, const void* kinds,
    long long s_kind, long long n_kind, const void* stamps, long long s_stamp,
    long long n_stamp, void* idx, void* t_min, int rows, int cols, void* stream) {
  Args a{};
  a.time = static_cast<const int*>(times);
  a.kind = static_cast<const int*>(kinds);
  a.stamp = static_cast<const int*>(stamps);
  a.s_time = s_time; a.s_kind = s_kind; a.s_stamp = s_stamp;
  a.n_time = n_time; a.n_kind = n_kind; a.n_stamp = n_stamp;
  a.idx = static_cast<int*>(idx);
  a.t_min = static_cast<int*>(t_min);
  a.rows = rows; a.cols = cols;
  return launch<false>(a, stream);
}

extern "C" int select_queue_events_launch(
    const void* valid, long long s_valid, long long n_valid, const void* time,
    long long s_time, long long n_time, const void* kind, long long s_kind,
    long long n_kind, const void* stamp, long long s_stamp, long long n_stamp,
    const void* timer_time, long long s_ttime, long long n_ttime,
    const void* timer_stamp, long long s_tstamp, long long n_tstamp, void* idx,
    void* t_min, int rows, int cols, int timers, int kind_timer, void* stream) {
  Args a{};
  a.valid = static_cast<const uint8_t*>(valid);
  a.time = static_cast<const int*>(time);
  a.kind = static_cast<const int*>(kind);
  a.stamp = static_cast<const int*>(stamp);
  a.timer_time = static_cast<const int*>(timer_time);
  a.timer_stamp = static_cast<const int*>(timer_stamp);
  a.s_valid = s_valid; a.s_time = s_time; a.s_kind = s_kind; a.s_stamp = s_stamp;
  a.s_ttime = s_ttime; a.s_tstamp = s_tstamp;
  a.n_valid = n_valid; a.n_time = n_time; a.n_kind = n_kind; a.n_stamp = n_stamp;
  a.n_ttime = n_ttime; a.n_tstamp = n_tstamp;
  a.idx = static_cast<int*>(idx);
  a.t_min = static_cast<int*>(t_min);
  a.rows = rows; a.cols = cols; a.timers = timers; a.kind_timer = kind_timer;
  return launch<true>(a, stream);
}
