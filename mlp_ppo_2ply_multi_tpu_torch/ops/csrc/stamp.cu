// stamp: one device time stamp, written into a ring of rows on the device.
//
// The tracer (utils/profiling.py) puts these launches at the boundaries of
// the stages of a rollout step, also inside a captured CUDA graph, and
// around the update. A CUDA event node would not do inside a graph: every
// replay overwrites the events of the one before.
//
// Contract: ring int64 [slots, width], cursor int64 [1], both on the device.
// The kernel reads %globaltimer (nanoseconds) and writes it into
// ring[cursor % slots, col]. A row's last stamp passes `close`, the row's
// kind (1-7; 0 for the others): it also writes cursor * 8 + close into the
// row's last column (its sequence number and kind, which the host checks
// against its own count) and moves the cursor on by one. The cursor
// lives on the device, so a captured graph advances it at every replay; the
// host counts the rows it has launched, and so knows where each landed
// without reading the cursor.
//
// One thread does it all: a stamp costs a launch, a load and two stores.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* __restrict__ ring, long long* __restrict__ cursor,
                             int slots, int width, int col, int close) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long c = *cursor;
  long long* row = ring + (c % slots) * width;
  row[col] = static_cast<long long>(t);
  if (close) {
    row[width - 1] = c * 8 + close;
    *cursor = c + 1;
  }
}

}  // namespace

// Launch one stamp on ``stream``; returns the CUDA error code (0: launched).
extern "C" int stamp_launch(void* ring, void* cursor, int slots, int width, int col,
                            int close, void* stream) {
  if (slots <= 0 || col < 0 || col >= width - 1 || close < 0 || close > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(cursor), slots, width, col, close);
  return static_cast<int>(cudaGetLastError());
}
