// Per-tile front-to-back alpha compositing for Hopper (sm_90a): kernels
// K1 (forward), K2 (forward + moving coverage) and K3 (backward).
//
// Replaces the Pallas kernels of gflow_tpu/ops/pallas_raster.py:
//   K1  _fwd_kernel with with_cov=False   (pallas_call in _packed_fwd_call)
//   K2  _fwd_kernel with with_cov=True    (composite_with_coverage_pallas)
//   K3  _bwd_kernel                       (pallas_call in _packed_bwd)
//
// Input is the packed per-tile candidate block attrs (T, K, CA): each row is
// [u, v, conic a, b, c, opacity, feat F (, mov)], depth-sorted front to
// back; only the first count_t = min(counts[t], K) rows of a tile are live
// (later rows hold clamped-gather garbage and are ignored). Pixel i of tile
// t sits at (tx0 + (i & 15), ty0 + (i >> 4)): integer coordinates, no +0.5.
//
//   power   = -0.5 (a dx^2 + c dy^2) - b dx dy,   dx = px - u, dy = py - v
//   raw     = op exp(min(power, 0)),  alpha = min(0.99, raw)
//   alpha   = 0 unless power <= 0 and alpha >= 1/255
//   out     = sum_k alpha_k T_k feat_k + T_final bg,  T_k = prod_{j<k}(1-alpha_j)
//   cov     = max_k alpha_k mov_k                                    (K2 only)
//
// Design. One thread block per 16x16 tile, one thread per pixel. The
// tile's live rows (at most 256 x 15 floats = 15 KB) are staged in shared
// memory once and read by all 256 threads as broadcasts. Each thread walks
// the slots front to back with a running transmittance; there is no early
// termination (the reference has none; stopping at T < 1e-4 would change
// the result). Bound: for the canonical T = 1620 tiles, K = 96, F = 4 the
// forward reads ~6 MB and writes ~7 MB (about 4 us at 3.35 TB/s) but does
// ~30 fp32 operations plus one expf per (pixel, live slot), some 40 M pairs
// (about 20 us at 67 TFLOP/s): operations bind, so the design keeps every
// byte of the slot loop in shared memory and registers.
//
// Backward (K3). Same grid. Each thread recomputes its pixel's alphas in
// two front-to-back passes instead of recovering T_k back to front by
// dividing by (1 - alpha) (deep stacks underflow T to 0 and the division
// then loses the suffix): pass 1 gives T_final and A = sum_j w_j fg_j
// (w = alpha T, fg = feat . g); pass 2 rebuilds T_k and the prefix P_k, so
// the suffix S_k = A - P_k; its absolute error is a few ulp of |A|. The
// per-slot sums over the tile's 256 pixels (five moments s1..s5 of dpower,
// s0 = sum dpower, dfeat = sum w g) are block reductions: warp shuffles,
// then a fixed-order pass over the 8 warps in shared memory, slot chunk by
// slot chunk. No float atomics, so K3's output is the same from run to run.
// Its cost is ~2.5x the forward's arithmetic plus (6 + F) warp reductions
// per live slot: operations bind.
//
// Built without --use_fast_math: alpha is compared against 1/255, so expf
// must be the accurate one.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int P_PIX = TILE * TILE;
constexpr int NWARPS = P_PIX / 32;
constexpr int MAX_F = 8;
constexpr int CHUNK = 32;  // slots per block-reduction round in K3
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float ALPHA_SKIP = 1.0f / 255.0f;

struct Alpha {
  float alpha;  // masked, clamped opacity contribution
  float raw;    // op * exp(min(power, 0))
  bool dmask;   // d alpha / d raw == 1 (live and unclamped)
};

__device__ __forceinline__ Alpha eval_alpha(const float* r, float dx, float dy) {
  const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
  const float raw = r[5] * expf(fminf(power, 0.0f));
  const float clamped = fminf(ALPHA_CLAMP, raw);
  const bool live = (power <= 0.0f) && (clamped >= ALPHA_SKIP);
  return {live ? clamped : 0.0f, raw, live && raw < ALPHA_CLAMP};
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy the tile's first `count` rows (count * CA floats) into shared memory.
__device__ __forceinline__ void stage_rows(float* s, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += P_PIX) s[i] = src[i];
}

template <bool WITH_COV>
__global__ void __launch_bounds__(P_PIX)
composite_fwd_kernel(const int* __restrict__ counts, const float* __restrict__ attrs,
                     const float* __restrict__ bg, float* __restrict__ out,
                     float* __restrict__ cov, int K, int CA, int F, int n_tx) {
  extern __shared__ float s_attr[];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int count = max(0, min(counts[t], K));
  stage_rows(s_attr, attrs + (size_t)t * K * CA, count * CA);
  __syncthreads();

  const float px = (float)((t % n_tx) * TILE + (p & (TILE - 1)));
  const float py = (float)((t / n_tx) * TILE + (p >> 4));
  float acc[MAX_F];
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) acc[f] = 0.0f;
  float trans = 1.0f;
  float cv = 0.0f;
  for (int k = 0; k < count; ++k) {
    const float* r = s_attr + k * CA;
    const float alpha = eval_alpha(r, px - r[0], py - r[1]).alpha;
    const float w = alpha * trans;
#pragma unroll
    for (int f = 0; f < MAX_F; ++f)
      if (f < F) acc[f] += w * r[6 + f];
    trans *= 1.0f - alpha;
    if (WITH_COV) cv = fmaxf(cv, alpha * r[6 + F]);
  }
  float* o = out + ((size_t)t * P_PIX + p) * F;
#pragma unroll
  for (int f = 0; f < MAX_F; ++f)
    if (f < F) o[f] = acc[f] + trans * bg[f];
  if (WITH_COV) cov[(size_t)t * P_PIX + p] = cv;
}

__global__ void __launch_bounds__(P_PIX)
composite_bwd_kernel(const int* __restrict__ counts, const float* __restrict__ attrs,
                     const float* __restrict__ bg, const float* __restrict__ g,
                     float* __restrict__ dattrs, int K, int CA, int F, int n_tx) {
  extern __shared__ float smem[];
  float* s_attr = smem;           // K * CA
  float* s_red = smem + K * CA;   // NWARPS * CHUNK * (6 + F)
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int NV = 6 + F;
  const int count = max(0, min(counts[t], K));
  float* d_t = dattrs + (size_t)t * K * CA;
  for (int i = count * CA + p; i < K * CA; i += P_PIX) d_t[i] = 0.0f;
  if (count == 0) return;  // uniform over the block
  stage_rows(s_attr, attrs + (size_t)t * K * CA, count * CA);
  __syncthreads();

  const float px = (float)((t % n_tx) * TILE + (p & (TILE - 1)));
  const float py = (float)((t / n_tx) * TILE + (p >> 4));
  float gp[MAX_F];
  float bgg = 0.0f;
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) {
    gp[f] = f < F ? g[((size_t)t * P_PIX + p) * F + f] : 0.0f;
    if (f < F) bgg += bg[f] * gp[f];
  }

  // pass 1: T_final and A = sum_k w_k fg_k
  float trans = 1.0f;
  float A = 0.0f;
  for (int k = 0; k < count; ++k) {
    const float* r = s_attr + k * CA;
    const float alpha = eval_alpha(r, px - r[0], py - r[1]).alpha;
    float fg = 0.0f;
#pragma unroll
    for (int f = 0; f < MAX_F; ++f)
      if (f < F) fg += r[6 + f] * gp[f];
    A += alpha * trans * fg;
    trans *= 1.0f - alpha;
  }
  const float t_final = trans;

  // pass 2: per-slot gradients, reduced over the tile's pixels
  trans = 1.0f;
  float prefix = 0.0f;
  for (int k0 = 0; k0 < count; k0 += CHUNK) {
    const int kn = min(CHUNK, count - k0);
    for (int j = 0; j < kn; ++j) {
      const float* r = s_attr + (k0 + j) * CA;
      const float dx = px - r[0];
      const float dy = py - r[1];
      const Alpha al = eval_alpha(r, dx, dy);
      float fg = 0.0f;
#pragma unroll
      for (int f = 0; f < MAX_F; ++f)
        if (f < F) fg += r[6 + f] * gp[f];
      const float w = al.alpha * trans;
      prefix += w * fg;
      const float suffix = A - prefix;  // sum_{j > k} w_j fg_j
      const float dalpha = trans * fg - (suffix + t_final * bgg) / (1.0f - al.alpha);
      const float dpower = al.dmask ? dalpha * al.raw : 0.0f;
      float v[6 + MAX_F];
      v[0] = dpower;
      v[1] = dpower * dx;
      v[2] = dpower * dy;
      v[3] = v[1] * dx;
      v[4] = v[1] * dy;
      v[5] = v[2] * dy;
#pragma unroll
      for (int f = 0; f < MAX_F; ++f) v[6 + f] = w * gp[f];
      trans *= 1.0f - al.alpha;
#pragma unroll
      for (int i = 0; i < 6 + MAX_F; ++i) {
        if (i < NV) {
          const float s = warp_sum(v[i]);
          if (lane == 0) s_red[(warp * CHUNK + j) * NV + i] = s;
        }
      }
    }
    __syncthreads();
    if (p < kn) {
      float s[6 + MAX_F];
#pragma unroll
      for (int i = 0; i < 6 + MAX_F; ++i) {
        float acc = 0.0f;
        if (i < NV)
          for (int w = 0; w < NWARPS; ++w) acc += s_red[(w * CHUNK + p) * NV + i];
        s[i] = acc;
      }
      const float* r = s_attr + (k0 + p) * CA;
      const float a = r[2], b = r[3], c = r[4], op = r[5];
      float* d = d_t + (size_t)(k0 + p) * CA;
      d[0] = a * s[1] + b * s[2];              // du
      d[1] = c * s[2] + b * s[1];              // dv
      d[2] = -0.5f * s[3];                     // da
      d[3] = -s[4];                            // db
      d[4] = -0.5f * s[5];                     // dc
      d[5] = op > 0.0f ? s[0] / fmaxf(op, 1e-20f) : 0.0f;  // dop
      for (int f = 0; f < F; ++f) d[6 + f] = s[6 + f];     // dfeat
      for (int i = 6 + F; i < CA; ++i) d[i] = 0.0f;        // mov: no gradient
    }
    __syncthreads();
  }
}

bool bad_shape(int T, int K, int CA, int F, int extra) {
  return T < 0 || K < 1 || F < 1 || F > MAX_F || CA != 6 + F + extra;
}

}  // namespace

extern "C" int gflow_composite_fwd(const int* counts, const float* attrs, const float* bg,
                                   float* out, int T, int K, int CA, int F, int n_tx,
                                   cudaStream_t stream) {
  if (bad_shape(T, K, CA, F, 0)) return (int)cudaErrorInvalidValue;
  if (T > 0)
    composite_fwd_kernel<false><<<T, P_PIX, (size_t)K * CA * sizeof(float), stream>>>(
        counts, attrs, bg, out, nullptr, K, CA, F, n_tx);
  return (int)cudaGetLastError();
}

extern "C" int gflow_composite_fwd_cov(const int* counts, const float* attrs, const float* bg,
                                       float* out, float* cov, int T, int K, int CA, int F,
                                       int n_tx, cudaStream_t stream) {
  if (bad_shape(T, K, CA, F, 1)) return (int)cudaErrorInvalidValue;
  if (T > 0)
    composite_fwd_kernel<true><<<T, P_PIX, (size_t)K * CA * sizeof(float), stream>>>(
        counts, attrs, bg, out, cov, K, CA, F, n_tx);
  return (int)cudaGetLastError();
}

extern "C" int gflow_composite_bwd(const int* counts, const float* attrs, const float* bg,
                                   const float* g, float* dattrs, int T, int K, int CA, int F,
                                   int n_tx, cudaStream_t stream) {
  if (T < 0 || K < 1 || F < 1 || F > MAX_F || (CA != 6 + F && CA != 7 + F))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)K * CA + (size_t)NWARPS * CHUNK * (6 + F)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (T > 0)
    composite_bwd_kernel<<<T, P_PIX, smem, stream>>>(counts, attrs, bg, g, dattrs, K, CA, F,
                                                     n_tx);
  return (int)cudaGetLastError();
}
