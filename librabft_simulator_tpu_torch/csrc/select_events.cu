// Batched event selection for the serial engine, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// librabft_simulator_tpu/ops/pallas_queue.py::select_events (body
// _select_kernel): per row of int32 [B, M] (times, kinds, stamps), the
// lexicographic argmin over (time asc, kind desc, stamp asc, column asc),
// returning the winning column and the row's minimum time.
//
// Bound: bytes.  The kernel reads 3*B*M*4 bytes and writes 2*B*4 bytes and
// does a handful of integer compares per element (8.2 MB per launch at
// B = 10,000, M = 68), so it is limited by device-memory bandwidth.  It reads
// each operand once: one pass with a four-key comparator instead of the
// reference's three masked reductions, and no intermediate masks in memory.
//
// Design: one warp per row, WARPS rows per block.  Lane l walks columns
// l, l+32, ... (neighbouring lanes read neighbouring words, so each warp
// load is one 128-byte transaction per operand), keeps its best candidate,
// then five __shfl_xor_sync rounds reduce the 32 candidates with the same
// comparator.  The TPU kernel's 128-lane padding and [bB, 128] broadcast
// outputs were tiling artefacts and are not carried over.
//
// The winner equals select_events_reference's for every kind >= -1 (the
// engine's kinds 0..3 and the -1 pad): a lane with no column holds a
// sentinel that every real column beats.
//
// C entry point (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ bool better(int t, int k, int s, int c,
                                       int bt, int bk, int bs, int bc) {
  if (t != bt) return t < bt;
  if (k != bk) return k > bk;
  if (s != bs) return s < bs;
  return c < bc;
}

__global__ void __launch_bounds__(WARPS * 32)
select_events_kernel(const int* __restrict__ times, const int* __restrict__ kinds,
                     const int* __restrict__ stamps, int* __restrict__ idx,
                     int* __restrict__ t_min, int rows, int cols) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp shares the row
  const long long base = row * cols;
  int bt = INT_MAX, bk = INT_MIN, bs = INT_MAX, bc = INT_MAX;
  for (int c = lane; c < cols; c += 32) {
    const int t = __ldg(times + base + c);
    const int k = __ldg(kinds + base + c);
    const int s = __ldg(stamps + base + c);
    if (better(t, k, s, c, bt, bk, bs, bc)) {
      bt = t; bk = k; bs = s; bc = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int t = __shfl_xor_sync(0xffffffffu, bt, off);
    const int k = __shfl_xor_sync(0xffffffffu, bk, off);
    const int s = __shfl_xor_sync(0xffffffffu, bs, off);
    const int c = __shfl_xor_sync(0xffffffffu, bc, off);
    if (better(t, k, s, c, bt, bk, bs, bc)) {
      bt = t; bk = k; bs = s; bc = c;
    }
  }
  if (lane == 0) {
    idx[row] = bc;
    t_min[row] = bt;
  }
}

}  // namespace

extern "C" int select_events_launch(const void* times, const void* kinds,
                                    const void* stamps, void* idx, void* t_min,
                                    int rows, int cols, void* stream) {
  const dim3 block(WARPS * 32);
  const dim3 grid((rows + WARPS - 1) / WARPS);
  select_events_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(times), static_cast<const int*>(kinds),
      static_cast<const int*>(stamps), static_cast<int*>(idx),
      static_cast<int*>(t_min), rows, cols);
  return static_cast<int>(cudaGetLastError());
}
