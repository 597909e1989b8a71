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
// Jacobi in float32: one thread per matrix, the upper triangle and the
// accumulated rotations in registers (every loop is unrolled over the
// compile-time n, so each index is a constant). A sweep visits the
// n(n-1)/2 pairs in round-robin order: the pairs of one round are disjoint,
// so their rotation angles do not depend on one another, and the compiler
// can overlap their square roots and divisions, which are the latency of a
// rotation. A rotation is skipped (the identity: c = 1, s = 0, without a
// branch) where |a_pq| <= 1e-7 sqrt(|a_pp a_qq|), the relative threshold
// under which Jacobi keeps even a positive semi-definite matrix's small
// eigenvalues to full relative accuracy; the sweeps end when one rotates
// nothing, or after kMaxSweeps (the design matrices take ~7 at n = 9).
//
// What bounds it: nothing the card is rated for. The function's work for
// 512 matrices of 9 x 9 is 166 KB in and 18 KB out (~55 ns at 3.35 TB/s)
// and ~4n^3/3 = 972 operations each, the tridiagonal reduction that a
// symmetric eigensolve needs (~7 ns of fp32 at 67 TFLOP/s). Jacobi does
// more (~4,200 operations a sweep at n = 9, ~7 sweeps), and a thread's
// chain of dependent square roots and divisions is what takes the time,
// so the design is about latency: no shared memory, no synchronisation,
// one launch, 32 threads a block so the matrices spread over the SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
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

// One Jacobi rotation J in the (p, q) plane, a <- J^T a J, v <- v J;
// the identity where a_pq is below the threshold.
template <int N>
__device__ __forceinline__ void rotate(float* a, float* v, int p, int q, bool& rotated) {
  const float apq = a[tri<N>(p, q)], app = a[tri<N>(p, p)], aqq = a[tri<N>(q, q)];
  // !(x > thr) is also true for a NaN
  const bool skip = !(fabsf(apq) > kTol * sqrtf(fabsf(app * aqq)));
  const float theta = 0.5f * (aqq - app) / apq;
  // t = sign(theta) / (|theta| + sqrt(theta^2 + 1)); 0 where theta^2
  // overflows (|theta| > 1.8e19: the angle is below float32's resolution)
  float t = copysignf(1.0f, theta) / (fabsf(theta) + sqrtf(fmaf(theta, theta, 1.0f)));
  t = skip ? 0.0f : t;
  rotated |= !skip;
  const float c = 1.0f / sqrtf(fmaf(t, t, 1.0f));
  const float s = t * c;
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
    small_eig_kernel(const float* __restrict__ mats, float* __restrict__ out, int batch) {
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

template <int N>
void launch(const float* mats, float* out, int batch, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  small_eig_kernel<N><<<blocks, kThreads, 0, stream>>>(mats, out, batch);
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
