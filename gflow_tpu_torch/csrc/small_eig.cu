// Batched smallest eigenvector of small symmetric matrices for Hopper (sm_90a).
//
// No Pallas kernel stands behind this one. The JAX package's LMedS
// (gflow_tpu/ops/epipolar.py::_solve_f) calls XLA's batched eigh and svd;
// the port's ops/epipolar.py needs only the eigenvector of the smallest
// eigenvalue of symmetric n x n matrices:
//
//   the null vector of A^T A  (9 x 9; 512 minimal samples, then the refit)
//   the rank-2 projection F (I - v v^T), v that of F^T F  (3 x 3)
//
// torch.linalg.eigh and svd on CUDA tensors check their status with a read
// back to the host, which a CUDA graph capture refuses, so the LMedS could
// not run compiled. This kernel reads nothing back.
//
// out[b, :] = the unit eigenvector of the smallest eigenvalue of matrix b,
// read from its lower triangle (as torch.linalg.eigh reads it), by cyclic
// Jacobi in float32. A sweep visits the n(n-1)/2 pairs in the round-robin
// (circle) order over M = n + (n odd) indices, M - 1 rounds of M / 2
// disjoint pairs (a pair with the dummy index n of an odd n is the
// identity). A rotation is skipped (the identity: c = 1, s = 0) where
// |a_pq| <= 1e-7 sqrt(|a_pp a_qq|), the relative threshold under which
// Jacobi keeps even a positive semi-definite matrix's small eigenvalues to
// full relative accuracy, and where a_pq is not a number; the sweeps end
// when one would rotate nothing, or after kMaxSweeps (the LMedS's 9 x 9
// take 5-8, 5.9 on average, on an H100: scripts/torch_small_eig_rounds.py).
//
// What bounds it: nothing the card is rated for. The function's work for
// 512 matrices of 9 x 9 is 166 KB in and 18 KB out (~55 ns at 3.35 TB/s)
// and ~4n^3/3 = 972 operations each, the tridiagonal reduction that a
// symmetric eigensolve needs (~7 ns of fp32 at 67 TFLOP/s). Jacobi does
// more (~4,200 operations a sweep at n = 9, ~7 sweeps), and the chain of
// dependent square roots and divisions of its rotations is what takes the
// time, so the design is about latency. Two layouts:
//
// n >= kWarpMinN (5; the LMedS's 9 x 9): one warp per matrix, 4 warps a
// block, so 512 matrices are 128 blocks over the 132 SMs and the refit's
// single matrix has a whole warp. The warp keeps its matrix as a full
// symmetric M x M (the dummy row and column 0) and the rotations V (n x M)
// in shared memory, in two buffers each: a round reads one and writes the
// other. The pairs of a round are disjoint, so their angles do not depend
// on one another: lane i < M computes the angle of its own index's pair
// (both lanes of a pair the same one, with the formulas of a sequential
// sweep) and publishes it for index i; after a __syncwarp all 32 lanes
// apply the round's block rotation A <- J^T A J (each lane a fixed share
// of the upper triangle, written to both halves, so A stays exactly
// symmetric) and V <- V J (its share of V's n x n), and a second
// __syncwarp ends the round. On a pair's own 2 x 2 block the diagonal
// takes a_pp - t a_pq and a_qq + t a_pq and a_pq becomes exactly 0; every
// other element is the 4-term product (2-term in V) of the two rotations
// it lies in. So a round costs about one rotation's latency, not M / 2 of
// them: ~1,000 cycles on an H100, the angle's chain of divisions and
// square roots ~730 of them (~115 for IEEE rounding) and the update ~265
// (scripts/torch_small_eig_rounds.py). Before each sweep every lane checks
// the threshold on its share of the off-diagonal elements, and the loop
// ends (__any_sync) where none passes: the sweep it saves would rotate
// nothing.
//
// n < kWarpMinN (the rank-2 projection's 3 x 3): one thread per matrix, the
// upper triangle and the accumulated rotations in registers (every loop
// unrolled over the compile-time n, so each index is a constant), 32
// threads a block so the matrices spread over the SMs. At n = 3 a round
// has one real rotation, so a warp would have nothing to run side by side.
//
// Built with -DGFLOW_SMALL_EIG_WARP_MIN_N=<k> the warp layout takes every
// n >= k (scripts/torch_small_eig_ab.py times both layouts at n = 3).

#include <cuda_runtime.h>

#ifndef GFLOW_SMALL_EIG_WARP_MIN_N
#define GFLOW_SMALL_EIG_WARP_MIN_N 5
#endif

namespace {

constexpr int kThreads = 32;  // threads a block, one-thread layout
constexpr int kWarps = 4;     // matrices a block, warp layout
constexpr int kWarpMinN = GFLOW_SMALL_EIG_WARP_MIN_N;
constexpr int kMaxSweeps = 16;
constexpr float kTol = 1e-7f;

// index of (i, j) in the packed upper triangle of an n x n matrix
template <int N>
__device__ __forceinline__ constexpr int tri(int i, int j) {
  return i <= j ? i * N - i * (i - 1) / 2 + (j - i) : j * N - j * (j - 1) / 2 + (i - j);
}

// pair k of round r of the round-robin (circle) order over M = N + (N odd)
// players; returns false where the pair holds the dummy player N
template <int N>
__device__ __forceinline__ bool pair_of(int r, int k, int& p, int& q) {
  constexpr int M = N + (N & 1);
  int x = k == 0 ? M - 1 : (r + k) % (M - 1);
  int y = k == 0 ? r : (r - k + (M - 1)) % (M - 1);
  p = x < y ? x : y;
  q = x < y ? y : x;
  return q < N;
}

// the partner of index i in round r of pair_of's order: pair 0 is
// (M - 1, r), and every other pair (x, y) has x + y = 2r mod M - 1.
// Selects, not branches: the lanes of a warp ask for different i.
template <int N>
__device__ __forceinline__ int partner_of(int r, int i) {
  constexpr unsigned M = N + (N & 1);
  const int other = (int)((2u * (unsigned)r + 2u * (M - 1) - (unsigned)i) % (M - 1));
  return i == (int)M - 1 ? r : i == r ? (int)M - 1 : other;
}

// The angle of one Jacobi rotation in the (p, q) plane: t = tan, c = cos,
// s = sin; the identity (t = 0, c = 1, s = 0, skip) where a_pq is below
// the threshold or not a number.
__device__ __forceinline__ void jacobi_angle(float app, float aqq, float apq, float& t,
                                             float& c, float& s, bool& skip) {
  // !(x > thr) is also true for a NaN
  skip = !(fabsf(apq) > kTol * sqrtf(fabsf(app * aqq)));
  // a skipped pair's t is dropped: it divides by 1, not by its a_pq (often
  // exactly 0, which sends IEEE division down its slow path)
  const float theta = 0.5f * (aqq - app) / (skip ? 1.0f : apq);
  // t = sign(theta) / (|theta| + sqrt(theta^2 + 1)); 0 where theta^2
  // overflows (|theta| > 1.8e19: the angle is below float32's resolution)
  t = copysignf(1.0f, theta) / (fabsf(theta) + sqrtf(fmaf(theta, theta, 1.0f)));
  t = skip ? 0.0f : t;
  c = 1.0f / sqrtf(fmaf(t, t, 1.0f));
  s = t * c;
}

// ---------------------------------------------------------------------------
// one thread per matrix (n < kWarpMinN)
// ---------------------------------------------------------------------------

// One Jacobi rotation J in the (p, q) plane, a <- J^T a J, v <- v J;
// the identity where a_pq is below the threshold.
template <int N>
__device__ __forceinline__ void rotate(float* a, float* v, int p, int q, bool& rotated) {
  const float apq = a[tri<N>(p, q)], app = a[tri<N>(p, p)], aqq = a[tri<N>(q, q)];
  float t, c, s;
  bool skip;
  jacobi_angle(app, aqq, apq, t, c, s, skip);
  rotated |= !skip;
  a[tri<N>(p, p)] = app - t * apq;
  a[tri<N>(q, q)] = aqq + t * apq;
  a[tri<N>(p, q)] = skip ? apq : 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k == p || k == q) continue;
    const float akp = a[tri<N>(k, p)], akq = a[tri<N>(k, q)];
    a[tri<N>(k, p)] = c * akp - s * akq;
    a[tri<N>(k, q)] = s * akp + c * akq;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float vkp = v[k * N + p], vkq = v[k * N + q];
    v[k * N + p] = c * vkp - s * vkq;
    v[k * N + q] = s * vkp + c * vkq;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    small_eig_thread_kernel(const float* __restrict__ mats, float* __restrict__ out, int batch) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const float* m = mats + (size_t)b * N * N;
  float a[N * (N + 1) / 2];
  float v[N * N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j) a[tri<N>(i, j)] = __ldg(m + j * N + i);  // lower triangle
#pragma unroll
    for (int j = 0; j < N; ++j) v[i * N + j] = i == j ? 1.0f : 0.0f;
  }
  constexpr int M = N + (N & 1);
#pragma unroll 1
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int r = 0; r < M - 1; ++r) {
#pragma unroll
      for (int k = 0; k < M / 2; ++k) {
        int p = 0, q = 0;
        if (pair_of<N>(r, k, p, q)) rotate<N>(a, v, p, q, rotated);
      }
    }
    if (!rotated) break;
  }
  // the column of the smallest diagonal entry (the first of equal ones)
  float best = a[tri<N>(0, 0)];
  float col[N];
#pragma unroll
  for (int k = 0; k < N; ++k) col[k] = v[k * N];
#pragma unroll
  for (int i = 1; i < N; ++i) {
    const bool lower = a[tri<N>(i, i)] < best;
    best = lower ? a[tri<N>(i, i)] : best;
#pragma unroll
    for (int k = 0; k < N; ++k) col[k] = lower ? v[k * N + i] : col[k];
  }
#pragma unroll
  for (int k = 0; k < N; ++k) out[(size_t)b * N + k] = col[k];
}

// ---------------------------------------------------------------------------
// one warp per matrix (n >= kWarpMinN)
// ---------------------------------------------------------------------------

// a warp's shared memory: the matrix and the rotations, two buffers each,
// and the round's rotation as seen from each index i: column i of J holds
// rot[i].x = c at row i and rot[i].y = +-s at row partner_of(r, i);
// rot[i].z is the +-t of i's diagonal update, rot[i].w is 1 where i's pair
// is the identity
template <int N>
struct alignas(16) WarpSmem {
  static constexpr int M = N + (N & 1);
  float a[2][M * M];
  float v[2][N * M];
  float4 rot[M];
};

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
    small_eig_warp_kernel(const float* __restrict__ mats, float* __restrict__ out, int batch) {
  constexpr int M = N + (N & 1);
  constexpr int kTri = M * (M + 1) / 2;       // upper triangle with the diagonal
  constexpr int kEA = (kTri + 31) / 32;       // its elements a lane updates
  constexpr int kEV = (N * N + 31) / 32;      // V's elements a lane updates
  __shared__ WarpSmem<N> smem[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= batch) return;  // a whole warp: no block-wide barrier follows
  WarpSmem<N>& w = smem[warp];
  const float* m = mats + (size_t)b * N * N;
  for (int e = lane; e < M * M; e += 32) {
    const int i = e / M, j = e % M;
    const float x = i < N && j < N ? __ldg(m + max(i, j) * N + min(i, j)) : 0.0f;
    w.a[0][e] = x;  // lower triangle, mirrored
    w.a[1][e] = 0.0f;
  }
  for (int e = lane; e < N * M; e += 32) {
    w.v[0][e] = e / M == e % M ? 1.0f : 0.0f;
    w.v[1][e] = 0.0f;
  }
  // this lane's fixed share: elements (ai, aj), i <= j, of the upper
  // triangle (row-major) and (vk, vj) of V's n x n; a slot past the end
  // reads element (0, 0) and writes nothing
  int ai[kEA], aj[kEA], vk[kEV], vj[kEV];
#pragma unroll
  for (int x = 0; x < kEA; ++x) {
    int e = lane + 32 * x, i = 0;
    if (e >= kTri) e = 0;
    for (; e >= M - i; ++i) e -= M - i;  // row i holds M - i elements
    ai[x] = i;
    aj[x] = i + e;
  }
#pragma unroll
  for (int x = 0; x < kEV; ++x) {
    const int e = lane + 32 * x < N * N ? lane + 32 * x : 0;
    vk[x] = e / N;
    vj[x] = e % N;
  }
  __syncwarp();
  int cur = 0;
#pragma unroll 1
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    // a sweep in which no pair passes the threshold would change nothing:
    // end before it (each lane checks its off-diagonal elements)
    bool unconverged = false;
#pragma unroll
    for (int x = 0; x < kEA; ++x) {
      const float* A = w.a[cur];
      const int i = ai[x], j = aj[x];
      const bool off = i < j && j < N && lane + 32 * x < kTri;  // a real pair
      const float aii = off ? A[i * M + i] : 1.0f, ajj = off ? A[j * M + j] : 1.0f;
      const float aij = off ? A[i * M + j] : 0.0f;
      unconverged |= fabsf(aij) > kTol * sqrtf(fabsf(aii * ajj));
    }
    if (!__any_sync(0xffffffffu, unconverged)) break;
#pragma unroll 1
    for (int r = 0; r < M - 1; ++r) {
      const float* A = w.a[cur];
      const float* V = w.v[cur];
      if (lane < M) {
        // a pair with the dummy index is the identity, without a square
        // root of 0 (the slow path of IEEE sqrt)
        const int ip = partner_of<N>(r, lane);
        const int p = min(lane, ip), q = max(lane, ip);
        float t = 0.0f, c = 1.0f, s = 0.0f;
        bool skip = true;
        if (q < N) jacobi_angle(A[p * M + p], A[q * M + q], A[p * M + q], t, c, s, skip);
        w.rot[lane] = make_float4(c, lane == p ? -s : s, lane == p ? -t : t, skip ? 1.0f : 0.0f);
      }
      // the partners are known before the angles: no shared memory read
      int aip[kEA], ajp[kEA], vjp[kEV];
#pragma unroll
      for (int x = 0; x < kEA; ++x) {
        aip[x] = partner_of<N>(r, ai[x]);
        ajp[x] = partner_of<N>(r, aj[x]);
      }
#pragma unroll
      for (int x = 0; x < kEV; ++x) vjp[x] = partner_of<N>(r, vj[x]);
      __syncwarp();
      float* B = w.a[cur ^ 1];
      float* U = w.v[cur ^ 1];
      // every load of the round first, then the arithmetic, then every
      // store: the compiler cannot tell the two buffers apart, so a store
      // placed between loads would order the later loads after it. Every
      // lane runs every case and selects: no divergent branch.
      float4 ri[kEA], rj[kEA], rv[kEV];
      float aij[kEA], aijp[kEA], aipj[kEA], aipjp[kEA], vkj[kEV], vkjp[kEV];
#pragma unroll
      for (int x = 0; x < kEA; ++x) {
        const int i = ai[x], j = aj[x], ip = aip[x], jp = ajp[x];
        ri[x] = w.rot[i];
        rj[x] = w.rot[j];
        aij[x] = A[i * M + j];
        aijp[x] = A[i * M + jp];
        aipj[x] = A[ip * M + j];
        aipjp[x] = A[ip * M + jp];
      }
#pragma unroll
      for (int x = 0; x < kEV; ++x) {
        rv[x] = w.rot[vj[x]];
        vkj[x] = V[vk[x] * M + vj[x]];
        vkjp[x] = V[vk[x] * M + vjp[x]];
      }
      float ya[kEA], yv[kEV];
#pragma unroll
      for (int x = 0; x < kEA; ++x) {
        const float rotated = ri[x].x * (rj[x].x * aij[x] + rj[x].y * aijp[x]) +
                              ri[x].y * (rj[x].x * aipj[x] + rj[x].y * aipjp[x]);
        const float diag = aij[x] + ri[x].z * aijp[x];        // i == j, so jp == ip
        const float pair = ri[x].w != 0.0f ? aij[x] : 0.0f;   // j == ip: a_pq
        ya[x] = ai[x] == aj[x] ? diag : ajp[x] == ai[x] ? pair : rotated;
      }
#pragma unroll
      for (int x = 0; x < kEV; ++x) yv[x] = rv[x].x * vkj[x] + rv[x].y * vkjp[x];
#pragma unroll
      for (int x = 0; x < kEA; ++x) {
        if (lane + 32 * x < kTri) {
          B[ai[x] * M + aj[x]] = ya[x];
          B[aj[x] * M + ai[x]] = ya[x];
        }
      }
#pragma unroll
      for (int x = 0; x < kEV; ++x)
        if (lane + 32 * x < N * N) U[vk[x] * M + vj[x]] = yv[x];
      __syncwarp();
      cur ^= 1;
    }
  }
  // the column of the smallest diagonal entry (the first of equal ones)
  const float* A = w.a[cur];
  int best = 0;
  float bv = A[0];
#pragma unroll
  for (int i = 1; i < N; ++i) {
    const bool lower = A[i * M + i] < bv;
    bv = lower ? A[i * M + i] : bv;
    best = lower ? i : best;
  }
  if (lane < N) out[(size_t)b * N + lane] = w.v[cur][lane * M + best];
}

template <int N>
void launch(const float* mats, float* out, int batch, cudaStream_t stream) {
  if constexpr (N >= kWarpMinN) {
    const unsigned blocks = (unsigned)((batch + kWarps - 1) / kWarps);
    small_eig_warp_kernel<N><<<blocks, kWarps * 32, 0, stream>>>(mats, out, batch);
  } else {
    const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
    small_eig_thread_kernel<N><<<blocks, kThreads, 0, stream>>>(mats, out, batch);
  }
}

}  // namespace

// mats: (batch, n, n) float32, contiguous; out: (batch, n) float32.
// 1 <= n <= 9.
extern "C" int gflow_small_eig(const float* mats, float* out, int batch, int n,
                               cudaStream_t stream) {
  if (batch < 1 || n < 1 || n > 9) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 1: launch<1>(mats, out, batch, stream); break;
    case 2: launch<2>(mats, out, batch, stream); break;
    case 3: launch<3>(mats, out, batch, stream); break;
    case 4: launch<4>(mats, out, batch, stream); break;
    case 5: launch<5>(mats, out, batch, stream); break;
    case 6: launch<6>(mats, out, batch, stream); break;
    case 7: launch<7>(mats, out, batch, stream); break;
    case 8: launch<8>(mats, out, batch, stream); break;
    default: launch<9>(mats, out, batch, stream); break;
  }
  return (int)cudaGetLastError();
}
