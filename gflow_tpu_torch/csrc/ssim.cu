// SSIM of the fit's rgb loss for Hopper (sm_90a): one forward kernel and
// one backward kernel.
//
// No Pallas kernel stands behind these. The JAX package computes SSIM in
// gflow_tpu/opt/losses.py::ssim with jnp operations that XLA fuses; the
// port's plain version (ops/ssim.py::ssim_plain) is 22 shifted
// multiply-adds over five stacked (H, W, C) maps, and its autograd
// backward adds a slice-backward, a multiply and an accumulating add for
// every tap: ~90 full-frame elementwise launches an iteration, some 9 GB
// of device traffic at the fit's 854 x 480 x 3.
//
// The function (window 11, sigma 1.5, zero padding, mean over H x W x C):
// mu1 = blur(x), mu2 = blur(y), e11 = blur(x^2), e22 = blur(y^2),
// e12 = blur(xy), each blur separable, axis 0 (rows of the image) first,
// then axis 1; per pixel and channel
//   A1 = 2 mu1 mu2 + C1, A2 = 2 (e12 - mu1 mu2) + C2,
//   B1 = mu1^2 + mu2^2 + C1, B2 = (e11 - mu1^2) + (e22 - mu2^2) + C2,
//   S = A1 A2 / (B1 B2),
// and the result is the mean of S.
//
// Forward (ssim_fwd_kernel): one block per 32 x 16 output tile and all
// channels of it. Per channel the block loads x and y of the tile and a
// 5-pixel halo into shared memory (zeros outside the image: the zero
// padding), forms x^2, y^2 and xy on the fly, blurs the five maps along
// axis 0 into shared memory (the tile's rows, the halo's columns), then
// along axis 1, and evaluates S. The taps are summed w0 v0 + w1 v1 + ...
// in index order with __fmul_rn and __fadd_rn (nvcc contracts no multiply-
// add out of them), and the map's arithmetic is written the same way, so
// the blurred maps and S equal the plain version's float32 operations
// bitwise; only the mean's summation order differs. Each block writes one
// partial sum (its threads' sums reduced in a fixed order); a one-block
// kernel adds the partials in index order in double and writes the mean,
// so the result repeats from run to run (no atomics).
//
// Where the caller needs the gradient, the forward also writes three
// per-pixel coefficient maps (3, H, W, C), the partial derivatives of S
// taken with mu1, e11 and e12 as independent variables:
//   dS/dmu1 = 2 mu2 (A2 - A1) / (B1 B2) + 2 mu1 S (1/B2 - 1/B1),
//   dS/de11 = -S / B2,
//   dS/de12 = 2 A1 / (B1 B2).
//
// Backward (ssim_bwd_kernel): the zero-padded symmetric blur is its own
// transpose, so for L = mean(S) with upstream gradient g,
//   dL/dx = g / (H W C) (blur(dS/dmu1) + 2 x blur(dS/de11) + y blur(dS/de12)).
// One block per 32 x 16 tile again: the three maps of a channel with their
// halo into shared memory, the separable blur of all three, the pointwise
// combination, one write of dL/dx. Only x (the rendered image) gets a
// gradient; y is the target.
//
// What bounds it: at 854 x 480 x 3 the forward reads x and y (9.8 MB) and
// writes the maps (14.8 MB), the backward reads the maps, x and y and
// writes dL/dx (29.5 MB): ~16 us at 3.35 TB/s. The arithmetic, ~255
// operations a pixel and channel forward (5 maps x 11 taps x 2 passes x 2,
// the map, the coefficients) and ~140 backward, is ~0.5 GFLOP, ~7 us at
// 67 TFLOP/s. On an H100 the two take 0.041 and 0.028 ms (chip_smoke.py's
// ssim_rows): the axis-0 pass over the halo's columns (42 of 32), the
// separate multiply and add of the bitwise match, the shared-memory reads
// of every tap and the channel-strided loads keep them at 3-6x the bytes'
// bound, which is ~2% of the fit's iteration.
//
// Any H and W (down to images smaller than the window) and 1 <= C <= 8;
// x and y are (H, W, C) float32 with their channels contiguous and `sx`,
// `sy` floats between neighbouring pixels (C for a contiguous image, more
// for a channel slice of a wider one). No allocation and no
// synchronisation: the launches can be captured in a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int kR = 5;                // window radius: 11 taps
constexpr int kTaps = 2 * kR + 1;
constexpr int kTW = 32;              // output tile: columns (axis 1)
constexpr int kTH = 16;              // output tile: rows (axis 0)
constexpr int kSW = kTW + 2 * kR;    // tile with its halo
constexpr int kSH = kTH + 2 * kR;
constexpr int kThreads = 256;
constexpr int kSumThreads = 256;
constexpr int kMaxC = 8;

// the plain version's window (_ssim_window(11, 1.5)): exp(-(t - 5)^2 / 4.5)
// in double, rounded to float32, over its float32 sum; tested against it
__constant__ float kW[kTaps] = {
    0x1.0d956ep-10f, 0x1.f1fe04p-8f, 0x1.26eb18p-5f, 0x1.bff1p-4f, 0x1.b43c4p-3f,
    0x1.106562p-2f, 0x1.b43c4p-3f, 0x1.bff1p-4f, 0x1.26eb18p-5f, 0x1.f1fe04p-8f,
    0x1.0d956ep-10f};
constexpr float kC1 = 1e-4f;  // 0.01^2 and 0.03^2, as float32 (the plain version's)
constexpr float kC2 = 9e-4f;

// blocks of a (H, W) image's tiles
inline dim3 tile_grid(int H, int W) { return dim3((W + kTW - 1) / kTW, (H + kTH - 1) / kTH); }

// the tile's element (r, q) of its halo'd window, channel c, 0 outside
__device__ __forceinline__ float halo_load(const float* __restrict__ p, int H, int W, int s,
                                           int c, int i0, int j0, int r, int q) {
  const int i = i0 - kR + r, j = j0 - kR + q;
  return (i >= 0 && i < H && j >= 0 && j < W) ? p[((long long)i * W + j) * s + c] : 0.f;
}

// a warp's then a block's sum of v, in a fixed order; the total in thread 0
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(kThreads)
ssim_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y, int H, int W, int C,
                int sx, int sy, float* __restrict__ partial, float* __restrict__ coef) {
  __shared__ float xs[kSH][kSW], ys[kSH][kSW];
  __shared__ float vs[5][kTH][kSW];  // the axis-0 pass of mu1, mu2, e11, e22, e12
  __shared__ float red[kThreads / 32];
  const int i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;
  const long long plane = (long long)H * W * C;  // one coefficient map
  float acc = 0.f;
  for (int c = 0; c < C; ++c) {
    for (int t = threadIdx.x; t < kSH * kSW; t += kThreads) {
      const int r = t / kSW, q = t % kSW;
      xs[r][q] = halo_load(x, H, W, sx, c, i0, j0, r, q);
      ys[r][q] = halo_load(y, H, W, sy, c, i0, j0, r, q);
    }
    __syncthreads();
    // axis 0: output rows of the tile, every column of the halo'd window
    for (int t = threadIdx.x; t < kTH * kSW; t += kThreads) {
      const int r = t / kSW, q = t % kSW;
      float a[5];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const float xv = xs[r + k][q], yv = ys[r + k][q];
        const float m[5] = {xv, yv, __fmul_rn(xv, xv), __fmul_rn(yv, yv), __fmul_rn(xv, yv)};
#pragma unroll
        for (int n = 0; n < 5; ++n) {
          const float term = __fmul_rn(kW[k], m[n]);
          a[n] = k == 0 ? term : __fadd_rn(a[n], term);
        }
      }
#pragma unroll
      for (int n = 0; n < 5; ++n) vs[n][r][q] = a[n];
    }
    __syncthreads();
    // axis 1, then S and its coefficients
    for (int t = threadIdx.x; t < kTH * kTW; t += kThreads) {
      const int r = t / kTW, q = t % kTW;
      const int i = i0 + r, j = j0 + q;
      if (i >= H || j >= W) continue;
      float b[5];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
#pragma unroll
        for (int n = 0; n < 5; ++n) {
          const float term = __fmul_rn(kW[k], vs[n][r][q + k]);
          b[n] = k == 0 ? term : __fadd_rn(b[n], term);
        }
      }
      const float mu1 = b[0], mu2 = b[1];
      const float mu1_sq = __fmul_rn(mu1, mu1), mu2_sq = __fmul_rn(mu2, mu2);
      const float mu1_mu2 = __fmul_rn(mu1, mu2);
      const float sigma1_sq = __fsub_rn(b[2], mu1_sq), sigma2_sq = __fsub_rn(b[3], mu2_sq);
      const float sigma12 = __fsub_rn(b[4], mu1_mu2);
      const float A1 = __fadd_rn(__fmul_rn(2.f, mu1_mu2), kC1);
      const float A2 = __fadd_rn(__fmul_rn(2.f, sigma12), kC2);
      const float B1 = __fadd_rn(__fadd_rn(mu1_sq, mu2_sq), kC1);
      const float B2 = __fadd_rn(__fadd_rn(sigma1_sq, sigma2_sq), kC2);
      const float D = __fmul_rn(B1, B2);
      const float S = __fdiv_rn(__fmul_rn(A1, A2), D);
      acc += S;
      if (coef != nullptr) {
        const long long o = ((long long)i * W + j) * C + c;
        coef[o] = 2.f * mu2 * (A2 - A1) / D + 2.f * mu1 * S * (1.f / B2 - 1.f / B1);
        coef[plane + o] = -S / B2;
        coef[2 * plane + o] = 2.f * A1 / D;
      }
    }
    __syncthreads();  // the next channel overwrites xs, ys
  }
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// out[0] = (sum of partial[0..n)) / count, summed in double in index order
// per thread, then over the threads in a fixed tree
__global__ void __launch_bounds__(kSumThreads)
ssim_mean_kernel(const float* __restrict__ partial, int n, double count, float* __restrict__ out) {
  __shared__ double red[kSumThreads];
  double s = 0.0;
  for (int t = threadIdx.x; t < n; t += kSumThreads) s += partial[t];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = kSumThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)(red[0] / count);
}

__global__ void __launch_bounds__(kThreads)
ssim_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ coef, const float* __restrict__ g, int H, int W,
                int C, int sx, int sy, float* __restrict__ dx) {
  __shared__ float cs[3][kSH][kSW];
  __shared__ float vs[3][kTH][kSW];
  const int i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;
  const long long plane = (long long)H * W * C;
  const float scale = (float)((double)g[0] / ((double)H * W * C));
  for (int c = 0; c < C; ++c) {
    for (int t = threadIdx.x; t < kSH * kSW; t += kThreads) {
      const int r = t / kSW, q = t % kSW;
#pragma unroll
      for (int n = 0; n < 3; ++n) cs[n][r][q] = halo_load(coef + n * plane, H, W, C, c, i0, j0, r, q);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kTH * kSW; t += kThreads) {
      const int r = t / kSW, q = t % kSW;
      float a[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
#pragma unroll
        for (int n = 0; n < 3; ++n) a[n] = fmaf(kW[k], cs[n][r + k][q], a[n]);
      }
#pragma unroll
      for (int n = 0; n < 3; ++n) vs[n][r][q] = a[n];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kTH * kTW; t += kThreads) {
      const int r = t / kTW, q = t % kTW;
      const int i = i0 + r, j = j0 + q;
      if (i >= H || j >= W) continue;
      float b[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
#pragma unroll
        for (int n = 0; n < 3; ++n) b[n] = fmaf(kW[k], vs[n][r][q + k], b[n]);
      }
      const long long p = (long long)i * W + j;
      const float xv = x[p * sx + c], yv = y[p * sy + c];
      dx[p * C + c] = scale * (b[0] + 2.f * xv * b[1] + yv * b[2]);
    }
    __syncthreads();  // the next channel overwrites cs
  }
}

bool valid(int H, int W, int C, int sx, int sy) {
  return H >= 1 && W >= 1 && C >= 1 && C <= kMaxC && sx >= C && sy >= C &&
         (long long)(H + kTH - 1) / kTH <= 65535;
}

}  // namespace

// SSIM's mean of (H, W, C) images x and y into out[0]; partial holds the
// n_partial = ceil(W / 32) * ceil(H / 16) blocks' sums; coef, if not null,
// receives the (3, H, W, C) coefficient maps of the backward.
extern "C" int gflow_ssim_fwd(const float* x, const float* y, int H, int W, int C, int sx,
                              int sy, float* partial, int n_partial, float* out, float* coef,
                              cudaStream_t stream) {
  const dim3 grid = tile_grid(H, W);
  if (!valid(H, W, C, sx, sy) || n_partial != (int)(grid.x * grid.y))
    return (int)cudaErrorInvalidValue;
  ssim_fwd_kernel<<<grid, kThreads, 0, stream>>>(x, y, H, W, C, sx, sy, partial, coef);
  ssim_mean_kernel<<<1, kSumThreads, 0, stream>>>(partial, n_partial, (double)H * W * C, out);
  return (int)cudaGetLastError();
}

// dx (H, W, C), contiguous: the gradient of mean SSIM with respect to x for
// the upstream gradient g[0], from the forward's coefficient maps
extern "C" int gflow_ssim_bwd(const float* x, const float* y, const float* coef, const float* g,
                              int H, int W, int C, int sx, int sy, float* dx,
                              cudaStream_t stream) {
  if (!valid(H, W, C, sx, sy)) return (int)cudaErrorInvalidValue;
  ssim_bwd_kernel<<<tile_grid(H, W), kThreads, 0, stream>>>(x, y, coef, g, H, W, C, sx, sy, dx);
  return (int)cudaGetLastError();
}
