// Tail of tile binning for Hopper (sm_90a): kernel K4, one launch.
//
// Replaces the Pallas kernel gflow_tpu/ops/binning.py::_rotate_pack_kernel
// (pallas_call in _rotate_pack) together with the XLA ops around it
// (binning.py:201-212: the sorted id stream, the searchsorted segment starts,
// the counts). From the sorted packed keys and the sort's permutation:
//
//   tile(i)         = key_s[i] >> depth_nbits            (in [0, T]; T = sentinel)
//   starts[t]       = first i with tile(i) >= t, t in [0, T]   (L if none)
//   tile_counts[t]  = starts[t+1] - starts[t]            (uncapped)
//   tile_lists[t,k] = idx_flat[order[starts[t] + k]]  for k < min(tile_counts[t], K)
//                   = -1                              otherwise
//
// The TPU version splits this into a sort, a binary search per tile, a row
// gather and a lane-rotating pack, because per-element gathers are slow
// there. On Hopper gathers are cheap and launches are what cost: the first
// port ran eight small launches around the sort for this (before it, an
// arange and the expand copy of the single-class ids; after it, the L-wide
// gather idx_flat[order], the shift, an arange, searchsorted's 1,621 chains
// of ~19 dependent loads, the subtraction and the pack), each a few
// microseconds of launch ramp and memory round trips for well under a
// megabyte. The function's own bytes are 1.5-2.2 MB at L = 409,600,
// T = 1,620, K = 96 (the ~9,500 key sectors a binary search for the T + 1
// starts reads, 8-12 per live slot, the lists written), 0.45-0.65 us on an
// H100, so the design is about latency and launch count, not bandwidth: the
// kernel takes ~4 us, 10-17% of that bound (PERF.md, kernel table).
//
// One warp per tile, eight per block, one launch:
// 1. The warp finds starts[t] and starts[t + 1] together by a 32-way search:
//    each step, lanes 0..30 test the 31 points that cut each open range
//    into 32 parts (two independent loads per lane), and one ballot per
//    range narrows it to the part where "tile(i) >= t" turns true: 4
//    dependent steps at L = 409,600 instead of searchsorted's ~19. Tiles are
//    clamped to [-1, T], which leaves the predicate unchanged for every t in
//    [0, T]; the search is exact for any sorted stream, empty tiles and
//    L = 0 included.
// 2. It writes the count and its row of K outputs, coalesced; only live
//    slots read order (int64) and then their id, so the L-wide gather is
//    gone. Single-class emission passes no id array: Gaussian j's
//    candidates are contiguous in the emission, so idx_flat[j] = j / group.
//
// One launch, not a pass that writes every start and a second that packs:
// a second launch and its starts buffer cost more host time than the search
// costs on the device, and the binning layer is host-bound. 32-bit indices
// throughout (the wrapper checks L < 2^31); no 64-bit division.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one tile each
constexpr int kTilesPerBlock = kThreads / 32;

__device__ __forceinline__ int tile_at(const int* __restrict__ keys, int i, int nbits, int T) {
  return min(max(__ldg(keys + i) >> nbits, -1), T);
}

// One step of the 32-way search for the first i in [lo, hi) with
// tile(i) >= t (hi if none), the answer known to lie in [lo, hi]. Lane j < 31
// tests q_j = lo + (j + 1) n / 32 (n = hi - lo, so q_j < hi); lane 31 stands
// for hi, where the predicate holds by definition. The predicate is monotone,
// so the c lanes where it fails are lanes 0..c-1 and the answer lies in
// (q_{c-1}, q_c], q_{-1} = lo - 1, q_31 = hi. An empty range stays as it is.
__device__ __forceinline__ void narrow(unsigned fails, int& lo, int& hi) {
  const int n = hi - lo;
  const int c = __popc(fails);
  const int q_c = lo + (int)(((long long)(c + 1) * n) >> 5);
  if (c > 0) lo = lo + (int)(((long long)c * n) >> 5) + 1;
  hi = q_c;
}

template <bool kIds>
__global__ void __launch_bounds__(kThreads)
bin_tail_kernel(const int* __restrict__ keys, const long long* __restrict__ order,
                const int* __restrict__ idx_flat, int group, int* __restrict__ counts,
                int* __restrict__ lists, int L, int T, int K, int nbits) {
  const int t = blockIdx.x * kTilesPerBlock + (threadIdx.x >> 5);  // warp-uniform
  const int lane = threadIdx.x & 31;
  if (t >= T) return;
  // a: starts[t], b: starts[t + 1]; lo and hi come from ballots, so every
  // lane holds the same ranges and the loop is warp-uniform
  int lo_a = 0, hi_a = L, lo_b = 0, hi_b = L;
  while (lo_a < hi_a || lo_b < hi_b) {
    bool fail_a = false, fail_b = false;
    if (lane < 31) {
      if (lo_a < hi_a)
        fail_a = tile_at(keys, lo_a + (int)(((long long)(lane + 1) * (hi_a - lo_a)) >> 5),
                         nbits, T) < t;
      if (lo_b < hi_b)
        fail_b = tile_at(keys, lo_b + (int)(((long long)(lane + 1) * (hi_b - lo_b)) >> 5),
                         nbits, T) < t + 1;
    }
    narrow(__ballot_sync(0xffffffffu, fail_a), lo_a, hi_a);
    narrow(__ballot_sync(0xffffffffu, fail_b), lo_b, hi_b);
  }
  const int s = lo_a, n = lo_b - lo_a;
  if (lane == 0) counts[t] = n;
  const int live = min(n, K);
  int* row = lists + (size_t)t * K;
#pragma unroll 4
  for (int k = lane; k < K; k += 32) {
    int v = -1;
    if (k < live) {
      const int j = (int)__ldg(order + s + k);
      v = kIds ? __ldg(idx_flat + j) : j / group;
    }
    row[k] = v;
  }
}

}  // namespace

// keys: the L sorted int32 keys; order: the sort's int64 permutation;
// idx_flat: the L int32 ids in emission order, or null to take order / group.
// counts: (T,) int32, lists: (T, K) int32.
extern "C" int gflow_bin_tail(const int* keys, const long long* order, const int* idx_flat,
                              int group, int* counts, int* lists, int L, int T, int K,
                              int nbits, cudaStream_t stream) {
  if (L < 0 || T < 1 || K < 1 || nbits < 0 || nbits > 31 || (idx_flat == nullptr && group < 1))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((T + kTilesPerBlock - 1) / kTilesPerBlock);
  if (idx_flat != nullptr)
    bin_tail_kernel<true><<<blocks, kThreads, 0, stream>>>(keys, order, idx_flat, group, counts,
                                                           lists, L, T, K, nbits);
  else
    bin_tail_kernel<false><<<blocks, kThreads, 0, stream>>>(keys, order, idx_flat, group,
                                                            counts, lists, L, T, K, nbits);
  return (int)cudaGetLastError();
}
