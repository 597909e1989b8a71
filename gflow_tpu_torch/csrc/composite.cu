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
// t sits at (tx0 + (i & 15), ty0 + (i >> 4)): integer coordinates, no +0.5,
// tx0 = 16 (t % n_tx), ty0 = 16 (t / n_tx + row0). row0 is a band's first
// tile row (0 for a whole image): a band of tile rows composites in place,
// the counterpart of the JAX band wrapper's shift of uv.y, without its
// float32 rounding.
//
//   power   = -0.5 (a dx^2 + c dy^2) - b dx dy,   dx = px - u, dy = py - v
//   raw     = op exp(min(power, 0)),  alpha = min(0.99, raw)
//   alpha   = 0 unless power <= 0 and alpha >= 1/255
//   out     = sum_k alpha_k T_k feat_k + T_final bg,  T_k = prod_{j<k}(1-alpha_j)
//   cov     = max_k alpha_k mov_k                                    (K2 only)
//
// Bound. For the canonical T = 1620 tiles, K = 96, F = 4 there are about
// 85 k live slots, i.e. 22 M (pixel, slot) pairs: the bytes (a few MB) take
// ~4 us at 3.35 TB/s, the fp32 operations ~9 us (K1) and ~18 us (K3) at 67
// TFLOP/s. Operations bind, so the designs below cut the instructions
// issued per pair, not bytes.
//
// Layout (all three kernels). One block of 64 threads per 16x16 tile; each
// thread owns R = 4 neighbouring pixels, a 4x1 strip of one row, so the
// per-slot terms in dy are shared by the strip, and a thread's output (or
// upstream gradient) is 4F contiguous floats, moved as F float4s. The
// tile's live rows are staged once in shared memory, each padded to a
// multiple of 4 floats and read back as float4 broadcasts once per slot per
// thread, not once per pixel. The conic's a and c are staged times -0.5,
// which is exact, so power rounds as -0.5 (a dx^2 + c dy^2) - b dx dy does,
// up to FMA contraction. F is a template parameter (1..8), so the
// per-pixel arrays live in registers at their real size. Grid: 64-thread
// blocks, one per tile (256-thread blocks ran in 2.5 waves); K1/K2 hold
// all 1,620 tiles of the canonical frame resident at once, K3 (about 96
// registers at F = 4) about 1,300, the rest following as blocks retire.
// Tiles cost 0 to K slots, so with every tile resident the per-SM sums of
// tile costs are uneven; PERF.md measures what that costs against the same
// input at even counts.
//
// Forward (K1/K2). Each thread runs R independent transmittance chains
// through the slots: instruction-level parallelism in the dependent
// T *= 1 - alpha loop. No early termination: the reference has none, and
// the coverage max of K2 goes on after T reaches 0. (Skipping a slot whose
// alpha is 0 at every pixel of a warp, as K3 does, made K1 slower: few
// slots are dead across a whole 16x8 half-tile.)
//
// Backward (K3). Each thread recomputes its pixels' alphas in two
// front-to-back passes instead of recovering T_k back to front by dividing
// by (1 - alpha) (deep stacks underflow T to 0 and the division then loses
// the suffix): pass 1 gives T_final and A = sum_j w_j fg_j (w = alpha T,
// fg = feat . g); pass 2 rebuilds T_k and the prefix P_k, so the suffix
// S_k = A - P_k. Per slot a tile needs NV = 6 + F sums over its 256 pixels
// (s0 = sum dpower, the moments s1..s5 of dpower, dfeat = sum w g). A
// thread first sums its R pixels in registers; a warp then holds S =
// 32 / NV slots x NV values (3 x 10 at F = 4) and reduce-scatters them in
// one butterfly, 31 shuffles for up to 32 sums (a 5-shuffle tree per value
// would take 160), after which lane l holds the warp's sum
// of value l. The warps' sums go to shared memory and, after one barrier,
// all 64 threads combine them (warp 0 + warp 1, a fixed order) into the
// tile's (K, CA) output, one element each, in coalesced stores. No float
// atomics, so K3's output is the same from run to run. What K3 skips is
// exact for finite inputs: a slot whose alpha is 0 at every pixel of a warp
// adds exact zeros there (w = 0, T *= 1, dpower = 0), so in both passes
// the warp moves on after one vote; and a pixel whose alpha is masked or
// clamped (dpower = 0) adds no moments, so it skips dalpha and its
// division.
//
// Built without --use_fast_math: alpha is compared against 1/255, so expf
// must be the accurate one, and dalpha's division stays IEEE.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int P_PIX = TILE * TILE;
constexpr int R = 4;             // pixels per thread: a 4x1 strip of one row
constexpr int NT = P_PIX / R;    // threads per block, one tile per block
constexpr int NWARPS = NT / 32;
constexpr int MAX_F = 8;
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float ALPHA_SKIP = 1.0f / 255.0f;

// floats per staged row: n attributes padded to a multiple of 4
__host__ __device__ constexpr int row_stride(int n) { return (n + 3) & ~3; }

struct Alpha {
  float alpha;  // masked, clamped opacity contribution
  float raw;    // op * exp(min(power, 0))
  bool dmask;   // d alpha / d raw == 1 (live and unclamped)
};

__device__ __forceinline__ Alpha eval_alpha(float power, float op) {
  const float raw = op * expf(fminf(power, 0.0f));
  const float clamped = fminf(ALPHA_CLAMP, raw);
  const bool live = (power <= 0.0f) && (clamped >= ALPHA_SKIP);
  return {live ? clamped : 0.0f, raw, live && raw < ALPHA_CLAMP};
}

// power of a staged row r = [u, v, -a/2, b, -c/2, ...] at offsets (dx, dy);
// hcdd = (-c/2) dy dy is shared by the strip
__device__ __forceinline__ float eval_power(const float* r, float dx, float dy, float hcdd) {
  return (r[2] * dx * dx + hcdd) - r[3] * dx * dy;
}

// Stage the tile's first `count` rows: the first N of each row's CA floats
// into rows of RS floats, a and c times -0.5 (exact).
template <int RS, int N>
__device__ __forceinline__ void stage_rows(float* s, const float* src, int count, int CA) {
  for (int k = threadIdx.x; k < count; k += NT) {
    const float* g = src + (size_t)k * CA;
    float* d = s + k * RS;
#pragma unroll
    for (int c = 0; c < N; ++c) d[c] = (c == 2 || c == 4) ? -0.5f * g[c] : g[c];
  }
}

template <int RS>
__device__ __forceinline__ void load_row(float (&r)[RS], const float* s) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int q = 0; q < RS / 4; ++q) {
    const float4 x = s4[q];
    r[4 * q] = x.x;
    r[4 * q + 1] = x.y;
    r[4 * q + 2] = x.z;
    r[4 * q + 3] = x.w;
  }
}

template <int F, bool WITH_COV>
__global__ void __launch_bounds__(NT)
composite_fwd_kernel(const int* __restrict__ counts, const float* __restrict__ attrs,
                     const float* __restrict__ bg, float* __restrict__ out,
                     float* __restrict__ cov, int K, int n_tx, int row0) {
  constexpr int CA = 6 + F + (WITH_COV ? 1 : 0);
  constexpr int RS = row_stride(CA);
  extern __shared__ float4 smem4[];
  float* s_rows = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.x;
  const int count = max(0, min(counts[t], K));
  stage_rows<RS, CA>(s_rows, attrs + (size_t)t * K * CA, count, CA);
  __syncthreads();

  const int p0 = threadIdx.x * R;  // first pixel of this thread's strip
  const float px0 = (float)((t % n_tx) * TILE + (p0 & (TILE - 1)));
  const float py = (float)((t / n_tx + row0) * TILE + (p0 >> 4));
  float acc[R][F], trans[R], cv[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    trans[j] = 1.0f;
    cv[j] = 0.0f;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[j][f] = 0.0f;
  }
#pragma unroll 2
  for (int k = 0; k < count; ++k) {
    float r[RS];
    load_row<RS>(r, s_rows + k * RS);
    const float dy = py - r[1];
    const float hcdd = r[4] * dy * dy;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float dx = (px0 + (float)j) - r[0];
      const float alpha = eval_alpha(eval_power(r, dx, dy, hcdd), r[5]).alpha;
      const float w = alpha * trans[j];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[j][f] += w * r[6 + f];
      trans[j] *= 1.0f - alpha;
      if constexpr (WITH_COV) cv[j] = fmaxf(cv[j], alpha * r[6 + F]);
    }
  }

  float bgv[F];
#pragma unroll
  for (int f = 0; f < F; ++f) bgv[f] = bg[f];
  // R * F contiguous floats from pixel p0 on: F float4s, 16-byte aligned
  float4* o4 = reinterpret_cast<float4*>(out + ((size_t)t * P_PIX + p0) * F);
#pragma unroll
  for (int q = 0; q < F; ++q) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = (4 * q + e) / F, f = (4 * q + e) % F;
      v[e] = acc[j][f] + trans[j] * bgv[f];
    }
    o4[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
  if constexpr (WITH_COV)
    *reinterpret_cast<float4*>(cov + (size_t)t * P_PIX + p0) =
        make_float4(cv[0], cv[1], cv[2], cv[3]);
}

// One butterfly step: a lane keeps the half of its H-value groups that its
// lane bit H selects and adds the partner's copy of that half.
template <int H>
__device__ __forceinline__ void butterfly_step(float (&v)[32], int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Reduce-scatter 32 values across the warp: afterwards v[0] of lane l is
// the sum over the 32 lanes of value l; 16 + 8 + 4 + 2 + 1 = 31 shuffles.
// The steps are spelled out so that every index is a constant and v stays
// in registers.
__device__ __forceinline__ void butterfly_reduce_scatter(float (&v)[32], int lane) {
  butterfly_step<16>(v, lane);
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
}

template <int F>
__global__ void __launch_bounds__(NT)
composite_bwd_kernel(const int* __restrict__ counts, const float* __restrict__ attrs,
                     const float* __restrict__ bg, const float* __restrict__ g,
                     float* __restrict__ dattrs, int K, int CA, int n_tx, int row0) {
  constexpr int NV = 6 + F;         // sums per slot
  constexpr int S = 32 / NV;        // slots per butterfly
  constexpr int RS = row_stride(6 + F);
  const int KB = (K + S - 1) / S * S;
  extern __shared__ float4 smem4[];
  float* s_rows = reinterpret_cast<float*>(smem4);  // K * RS
  float* s_red = s_rows + K * RS;                     // NWARPS * KB * NV
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int count = max(0, min(counts[t], K));
  float* d_t = dattrs + (size_t)t * K * CA;
  if (count == 0) {  // uniform over the block
    for (int i = tid; i < K * CA; i += NT) d_t[i] = 0.0f;
    return;
  }
  stage_rows<RS, 6 + F>(s_rows, attrs + (size_t)t * K * CA, count, CA);
  __syncthreads();

  const int p0 = tid * R;
  const float px0 = (float)((t % n_tx) * TILE + (p0 & (TILE - 1)));
  const float py = (float)((t / n_tx + row0) * TILE + (p0 >> 4));
  float gp[R][F];
  const float4* g4 = reinterpret_cast<const float4*>(g + ((size_t)t * P_PIX + p0) * F);
#pragma unroll
  for (int q = 0; q < F; ++q) {
    const float4 x = g4[q];
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) gp[(4 * q + e) / F][(4 * q + e) % F] = xs[e];
  }
  float bgg[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    bgg[j] = 0.0f;
#pragma unroll
    for (int f = 0; f < F; ++f) bgg[j] += bg[f] * gp[j][f];
  }

  // pass 1: T_final and A = sum_k w_k fg_k per pixel
  float trans[R], A[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    trans[j] = 1.0f;
    A[j] = 0.0f;
  }
  for (int k = 0; k < count; ++k) {
    float r[RS];
    load_row<RS>(r, s_rows + k * RS);
    const float dy = py - r[1];
    const float hcdd = r[4] * dy * dy;
    float alpha[R];
    bool any = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      alpha[j] = eval_alpha(eval_power(r, (px0 + (float)j) - r[0], dy, hcdd), r[5]).alpha;
      any |= alpha[j] > 0.0f;
    }
    if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float fg = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) fg += r[6 + f] * gp[j][f];
      A[j] += alpha[j] * trans[j] * fg;
      trans[j] *= 1.0f - alpha[j];
    }
  }
  float t_final[R], prefix[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    t_final[j] = trans[j];
    trans[j] = 1.0f;
    prefix[j] = 0.0f;
  }

  // pass 2: per-slot sums, S slots per butterfly; value s * NV + i of a
  // batch is sum i of slot k0 + s
  float* red = s_red + warp * KB * NV;
  for (int k0 = 0; k0 < count; k0 += S) {
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (k0 + s >= count) continue;  // uniform over the block
      float r[RS];
      load_row<RS>(r, s_rows + (k0 + s) * RS);
      const float dy = py - r[1];
      const float hcdd = r[4] * dy * dy;
      Alpha al[R];
      bool any = false;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        al[j] = eval_alpha(eval_power(r, (px0 + (float)j) - r[0], dy, hcdd), r[5]);
        any |= al[j].alpha > 0.0f;
      }
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float fg = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) fg += r[6 + f] * gp[j][f];
        const float w = al[j].alpha * trans[j];
        prefix[j] += w * fg;
        if (al[j].dmask) {  // else dpower = 0 and the moments add zeros
          const float dx = (px0 + (float)j) - r[0];
          const float suffix = A[j] - prefix[j];  // sum_{i > k} w_i fg_i
          const float dalpha =
              trans[j] * fg - (suffix + t_final[j] * bgg[j]) / (1.0f - al[j].alpha);
          const float dpower = dalpha * al[j].raw;
          const float dpx = dpower * dx;
          const float dpy = dpower * dy;
          v[s * NV + 0] += dpower;
          v[s * NV + 1] += dpx;
          v[s * NV + 2] += dpy;
          v[s * NV + 3] += dpx * dx;
          v[s * NV + 4] += dpx * dy;
          v[s * NV + 5] += dpy * dy;
        }
#pragma unroll
        for (int f = 0; f < F; ++f) v[s * NV + 6 + f] += w * gp[j][f];
        trans[j] *= 1.0f - al[j].alpha;
      }
    }
    butterfly_reduce_scatter(v, lane);
    if (lane < S * NV) red[k0 * NV + lane] = v[0];
  }
  __syncthreads();

  // combine the warps' sums (fixed order) into the tile's (K, CA) output:
  // rows >= count and the mov column get zero
  for (int i = tid; i < K * CA; i += NT) {
    const int k = i / CA;
    const int c = i - k * CA;
    auto sum = [&](int v) {
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) acc += s_red[(w * KB + k) * NV + v];
      return acc;
    };
    const float* r = s_rows + k * RS;
    float d = 0.0f;
    if (k < count) {
      if (c == 0) d = -2.0f * r[2] * sum(1) + r[3] * sum(2);        // du = a s1 + b s2
      else if (c == 1) d = -2.0f * r[4] * sum(2) + r[3] * sum(1);   // dv = c s2 + b s1
      else if (c == 2) d = -0.5f * sum(3);                           // da
      else if (c == 3) d = -sum(4);                                  // db
      else if (c == 4) d = -0.5f * sum(5);                           // dc
      else if (c == 5) d = r[5] > 0.0f ? sum(0) / fmaxf(r[5], 1e-20f) : 0.0f;  // dop
      else if (c < 6 + F) d = sum(c);                                // dfeat
    }
    d_t[i] = d;
  }
}

bool bad_shape(int T, int K, int CA, int F, int extra) {
  return T < 0 || K < 1 || F < 1 || F > MAX_F || CA != 6 + F + extra;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int F, bool WITH_COV>
size_t fwd_smem(int K) {
  return (size_t)K * row_stride(6 + F + (WITH_COV ? 1 : 0)) * sizeof(float);
}

template <int F>
size_t bwd_smem(int K) {
  constexpr int NV = 6 + F, S = 32 / NV;
  const size_t KB = (size_t)(K + S - 1) / S * S;
  return ((size_t)K * row_stride(6 + F) + NWARPS * KB * NV) * sizeof(float);
}

template <int F, bool WITH_COV>
int launch_fwd(const int* counts, const float* attrs, const float* bg, float* out, float* cov,
               int T, int K, int n_tx, int row0, cudaStream_t stream) {
  const size_t smem = fwd_smem<F, WITH_COV>(K);
  const cudaError_t e = allow_smem(composite_fwd_kernel<F, WITH_COV>, smem);
  if (e != cudaSuccess) return (int)e;
  if (T > 0)
    composite_fwd_kernel<F, WITH_COV><<<T, NT, smem, stream>>>(counts, attrs, bg, out, cov,
                                                               K, n_tx, row0);
  return (int)cudaGetLastError();
}

template <int F>
int launch_bwd(const int* counts, const float* attrs, const float* bg, const float* g,
               float* dattrs, int T, int K, int CA, int n_tx, int row0, cudaStream_t stream) {
  const size_t smem = bwd_smem<F>(K);
  const cudaError_t e = allow_smem(composite_bwd_kernel<F>, smem);
  if (e != cudaSuccess) return (int)e;
  if (T > 0)
    composite_bwd_kernel<F><<<T, NT, smem, stream>>>(counts, attrs, bg, g, dattrs, K, CA,
                                                     n_tx, row0);
  return (int)cudaGetLastError();
}

// Resident blocks per SM, registers, local bytes, dynamic shared bytes and
// threads per block of one kernel (5 ints).
template <typename Kernel>
int occupancy(Kernel kernel, size_t smem, int* o) {
  cudaError_t e = allow_smem(kernel, smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NT, smem);
  if (e != cudaSuccess) return (int)e;
  o[0] = blocks;
  o[1] = attr.numRegs;
  o[2] = (int)attr.localSizeBytes;
  o[3] = (int)smem;
  o[4] = NT;
  return 0;
}

template <int F>
int occupancy_all(int K, int* info) {
  int rc = occupancy(composite_fwd_kernel<F, false>, fwd_smem<F, false>(K), info);
  if (rc == 0) rc = occupancy(composite_fwd_kernel<F, true>, fwd_smem<F, true>(K), info + 5);
  if (rc == 0) rc = occupancy(composite_bwd_kernel<F>, bwd_smem<F>(K), info + 10);
  return rc;
}

}  // namespace

// One instantiation per feature count F = 1..8.
#define GFLOW_SWITCH_F(F, CALL)                 \
  switch (F) {                                  \
    case 1: return CALL(1);                     \
    case 2: return CALL(2);                     \
    case 3: return CALL(3);                     \
    case 4: return CALL(4);                     \
    case 5: return CALL(5);                     \
    case 6: return CALL(6);                     \
    case 7: return CALL(7);                     \
    case 8: return CALL(8);                     \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" int gflow_composite_fwd(const int* counts, const float* attrs, const float* bg,
                                   float* out, int T, int K, int CA, int F, int n_tx,
                                   int row0, cudaStream_t stream) {
  if (bad_shape(T, K, CA, F, 0)) return (int)cudaErrorInvalidValue;
#define GFLOW_FWD(NF) \
  launch_fwd<NF, false>(counts, attrs, bg, out, nullptr, T, K, n_tx, row0, stream)
  GFLOW_SWITCH_F(F, GFLOW_FWD)
#undef GFLOW_FWD
}

extern "C" int gflow_composite_fwd_cov(const int* counts, const float* attrs, const float* bg,
                                       float* out, float* cov, int T, int K, int CA, int F,
                                       int n_tx, int row0, cudaStream_t stream) {
  if (bad_shape(T, K, CA, F, 1)) return (int)cudaErrorInvalidValue;
#define GFLOW_FWD_COV(NF) \
  launch_fwd<NF, true>(counts, attrs, bg, out, cov, T, K, n_tx, row0, stream)
  GFLOW_SWITCH_F(F, GFLOW_FWD_COV)
#undef GFLOW_FWD_COV
}

extern "C" int gflow_composite_bwd(const int* counts, const float* attrs, const float* bg,
                                   const float* g, float* dattrs, int T, int K, int CA, int F,
                                   int n_tx, int row0, cudaStream_t stream) {
  if (bad_shape(T, K, CA, F, 0) && bad_shape(T, K, CA, F, 1))
    return (int)cudaErrorInvalidValue;
#define GFLOW_BWD(NF) \
  launch_bwd<NF>(counts, attrs, bg, g, dattrs, T, K, CA, n_tx, row0, stream)
  GFLOW_SWITCH_F(F, GFLOW_BWD)
#undef GFLOW_BWD
}

// Resident blocks per SM, registers, local (spill) bytes, dynamic shared
// bytes and threads per block of K1, K2 and K3 (5 ints each, in that
// order) at capacity K and F feature channels.
extern "C" int gflow_composite_occupancy(int K, int F, int* info) {
  if (K < 1) return (int)cudaErrorInvalidValue;
#define GFLOW_OCC(NF) occupancy_all<NF>(K, info)
  GFLOW_SWITCH_F(F, GFLOW_OCC)
#undef GFLOW_OCC
}
