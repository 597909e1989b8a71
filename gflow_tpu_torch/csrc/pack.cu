// Tile-list packer for Hopper (sm_90a): kernel K4.
//
// Replaces the Pallas kernel gflow_tpu/ops/binning.py::_rotate_pack_kernel
// (pallas_call in _rotate_pack), whose semantics are the masked gather of
// binning.py:229-234:
//
//   tile_lists[t, k] = idx_s[starts[t] + k]  for k < min(counts[t], K)
//                    = -1                    otherwise
//
// The TPU version gathers whole 128-lane rows and lane-rotates each window
// into place because per-element gathers are slow there; on Hopper the
// gather is what the memory system does well. Design: one thread per
// (t, k); neighbouring threads read neighbouring ids of one tile's segment
// and write neighbouring outputs, so both sides coalesce. Bound: bytes —
// at T = 1620, K = 96 it reads at most 0.6 MB of ids plus 13 KB of starts
// and counts and writes 0.6 MB, well under a microsecond of device memory
// time, so the launch itself dominates. The sort and the segment starts
// stay outside (torch.sort, torch.searchsorted), as they were XLA ops, not
// Pallas, in the reference.

#include <cuda_runtime.h>

namespace {

__global__ void pack_tile_lists_kernel(const int* __restrict__ idx_s,
                                       const int* __restrict__ starts,
                                       const int* __restrict__ counts,
                                       int* __restrict__ out, int T, int K) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)T * K) return;
  const int t = (int)(i / K);
  const int k = (int)(i - (long long)t * K);
  out[i] = k < counts[t] ? idx_s[starts[t] + k] : -1;
}

}  // namespace

extern "C" int gflow_pack_tile_lists(const int* idx_s, const int* starts, const int* counts,
                                     int* out, int T, int K, cudaStream_t stream) {
  if (T < 0 || K < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)T * K;
  if (n > 0) {
    const int threads = 256;
    pack_tile_lists_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(
        idx_s, starts, counts, out, T, K);
  }
  return (int)cudaGetLastError();
}
