// Device timestamps for the stage loop's pieces (sm_90a).
//
// The stage's iteration is one CUDA graph replay, and a host range opened
// inside a capture is not replayed, so the pieces of an iteration are
// timed on the card: a one-thread kernel, launched on the capturing stream
// between two pieces, reads the global nanosecond timer (%globaltimer)
// and writes it into row it[0], column col of a (rows, cols) int64 table.
// The row is read on the card, so one recorded graph stamps every
// iteration's own row; a row outside the table is not written. On one
// stream each launch starts after the kernels before it end, so a stamp
// marks the boundary between two pieces, give or take a launch's latency.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void stamp_kernel(const int64_t* __restrict__ it, int64_t* __restrict__ table,
                             int rows, int cols, int col) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const int64_t row = it[0];
  if (row >= 0 && row < rows) table[row * cols + col] = static_cast<int64_t>(t);
}

extern "C" int gflow_stamp(const void* it, void* table, int rows, int cols, int col,
                           cudaStream_t stream) {
  if (rows < 1 || cols < 1 || col < 0 || col >= cols) return (int)cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, stream>>>(static_cast<const int64_t*>(it),
                                    static_cast<int64_t*>(table), rows, cols, col);
  return (int)cudaGetLastError();
}
