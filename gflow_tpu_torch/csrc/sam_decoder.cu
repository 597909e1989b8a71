// The image stream of SAM's two-way mask decoder for Hopper (sm_90a): its
// start, both cross-attentions and the residual LayerNorm, on one
// contiguous token-major layout, (B, N, C) rows.
//
// No Pallas kernel stands behind these: SAM has no counterpart in the JAX
// package. They stand in for the plain operations of the decoder's image
// stream (ops/sam_decoder.py, the plain versions beside them), which at the
// automatic grid's batch (B = 64 prompts, N = 64 x 64 image tokens of
// C = 256, T = 7 tokens, cross attention 8 heads of 16) made every pass
// over a 268 MB (B, N, C) tensor through PyTorch's generic strided or
// broadcast elementwise kernel: the embedding's broadcast add, keys + key_pe
// five times, head-major copies of K, Q and V, the materialised scores, their
// scale and softmax, the output's copy back, the residual and the norm.
//
// The kernels (the projections between them stay F.linear GEMMs on the
// contiguous rows):
//
// - stream_init_kernel: keys = image + dense, kpe = keys + key_pe. The
//   (C, N) channel-major embedding is read once, through a 32 x 32
//   shared-memory transpose tile, and each tile's rows are written to all
//   B prompts; key_pe is the (N, C) token-major positional encoding.
//   stream_init_each_kernel is the same tile a prompt (a grid of B
//   layers): SAM 2's tracked frames give each prompt (object) its own
//   memory-conditioned image, and its prompted frame a dense prompt per
//   cell (the mask input's embedding), (B, C, N) each. It would compute
//   SAM's shared call too, but reads the image and key_pe once a prompt:
//   on an H100 at B = 64, 0.219 ms against this kernel's 0.197-0.201 ms,
//   so a shared image and (C,) prompt keep the broadcast kernel.
// - t2i_split_kernel + t2i_combine_kernel, token to image: for each prompt,
//   head and token, softmax over the N image keys of (q k^T) / 4, times V.
//   Flash decoding: a block per (prompt, chunk of 256 keys), every head of
//   a key row at once (a warp reads a 512 B row as one float4 a lane; the
//   4 lanes of a head sum their products by two shuffles), an online
//   softmax over groups of 4 rows, the block's 8 warps merged in shared
//   memory into one partial (max, sum, weighted V) per chunk; a second
//   kernel merges the chunks in index order (no atomics: repeatable). K and
//   V are read once each; no scores and no head-major copies are written.
// - i2t_kernel, image to token: for each image row and head, softmax over
//   the T token keys of (q k^T) / 4, times V. A lane keeps its 4 channels of
//   the T token keys and values in registers for all its rows, so each
//   row is one float4 read and one float4 write a lane; the output is the
//   merged-head (B, N, 128) row that out_proj reads.
// - residual_ln_kernel: keys = LayerNorm(keys + out) (the block's norm4,
//   eps given) and kpe = keys + key_pe, one warp per row of 256: the row in
//   registers, mean and variance in two passes by warp shuffles. The next
//   block's, or the final attention's, keys + key_pe is made here once.
//
// What bounds them: bytes. At the cell's shapes one decode moves (each
// input read once, each output written once) 545 MB in stream_init, 268 MB
// in each token-to-image attention (K and V), 268 MB in each
// image-to-token one (Q in, the output out) and 1.07 GB in each residual
// LayerNorm: ~1.2 ms at 3.35 TB/s. Their arithmetic, a few operations a
// byte (the attentions' products are ~0.1 GFLOP), is far under the card's
// FP32 rate. So each byte of the image stream is moved once, in 16-byte
// loads and stores of whole rows, and nothing between the kernels and the
// GEMMs is materialised.
//
// Arithmetic is FP32, with fmaf and expf (no fast-math). stream_init's
// adds equal the plain version's bitwise; the attentions and the norm sum
// in another order (shuffle trees, the online softmax) and agree with the
// plain version to rounding. Shapes: C a multiple of 32 and N of 32
// (stream_init); C = 256 (the norm); the cross-attention width 128 in 8
// heads of 16 and 1 <= T <= 8 (the attentions): SAM's released decoders.
// Tensors are contiguous float32 on 16-byte boundaries. No allocation and
// no synchronisation: the launches can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInner = 128;          // cross-attention width: a warp's row, a float4 a lane
constexpr int kHeads = 8;            // of kHeadDim: the 4 lanes 4h..4h+3 hold head h
constexpr int kHeadDim = 16;
constexpr float kScale = 0.25f;      // 1 / sqrt(kHeadDim), exact
constexpr int kWidth = 256;          // the image stream's width (the norm)
constexpr int kTile = 32;            // stream_init: 32 tokens x 32 channels
constexpr int kChunk = 256;          // attentions: image rows a block, kChunk / kWarps a warp
constexpr int kGroup = 4;            // rows a warp loads before it computes with them
constexpr int kMaxT = 8;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}
// p a + b, per component
__device__ __forceinline__ float4 axpy4(float p, float4 a, float4 b) {
  return make_float4(fmaf(p, a.x, b.x), fmaf(p, a.y, b.y), fmaf(p, a.z, b.z), fmaf(p, a.w, b.w));
}
// a head's score: the sum over its 4 lanes, in every one of them
__device__ __forceinline__ float head_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// keys[b, n, c] = emb[c, n] + dense[c], kpe = keys + pe[n, c], for every b
__global__ void __launch_bounds__(kThreads)
stream_init_kernel(const float* __restrict__ emb, const float* __restrict__ dense,
                   const float* __restrict__ pe, int N, int C, int B,
                   float* __restrict__ keys, float* __restrict__ kpe) {
  __shared__ float tile[kTile][kTile + 1];  // [channel][token]
  const int n0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < kTile; c += kWarps)
    tile[c][lane] = emb[(long long)(c0 + c) * N + n0 + lane] + dense[c0 + c];
  __syncthreads();
  // a thread: one token, 4 channels (a warp: 4 tokens' 128-byte segments)
  const int tok = threadIdx.x >> 3, q = (threadIdx.x & 7) * 4;
  const float4 k = make_float4(tile[q][tok], tile[q + 1][tok], tile[q + 2][tok],
                               tile[q + 3][tok]);
  const long long at = (long long)(n0 + tok) * C + c0 + q;
  const float4 kp = add4(k, ld4(pe + at));
  const long long plane = (long long)N * C;
  for (int b = 0; b < B; ++b) {
    st4(keys + b * plane + at, k);
    st4(kpe + b * plane + at, kp);
  }
}

// keys[b, n, c] = emb[b?, c, n] + dense[b?, c(, n)], kpe = keys + pe[n, c]:
// blockIdx.z is the prompt b; emb_stride (0: one image for all prompts, C N:
// one each) and dense_cells (0: dense (C,), 1: dense (B, C, N)) say which
// operands are per prompt
__global__ void __launch_bounds__(kThreads)
stream_init_each_kernel(const float* __restrict__ emb, const float* __restrict__ dense,
                        const float* __restrict__ pe, int N, int C, long long emb_stride,
                        int dense_cells, float* __restrict__ keys, float* __restrict__ kpe) {
  __shared__ float tile[kTile][kTile + 1];  // [channel][token]
  const int n0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile, b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const long long plane = (long long)N * C;
  const float* img = emb + b * emb_stride;
  for (int c = threadIdx.x >> 5; c < kTile; c += kWarps) {
    const long long at = (long long)(c0 + c) * N + n0 + lane;
    tile[c][lane] = img[at] + (dense_cells ? dense[b * plane + at] : dense[c0 + c]);
  }
  __syncthreads();
  const int tok = threadIdx.x >> 3, q = (threadIdx.x & 7) * 4;
  const float4 k = make_float4(tile[q][tok], tile[q + 1][tok], tile[q + 2][tok],
                               tile[q + 3][tok]);
  const long long at = (long long)(n0 + tok) * C + c0 + q;
  st4(keys + b * plane + at, k);
  st4(kpe + b * plane + at, add4(k, ld4(pe + at)));
}

// Token to image, one block per (chunk of kChunk keys, prompt): the chunk's
// partial softmax of each token and head, its max and sum in part_ml
// (B, S, T, kHeads, 2) and its exp-weighted sum of V in part_acc
// (B, S, T, kInner).
template <int T>
__global__ void __launch_bounds__(kThreads)
t2i_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, int N, float* __restrict__ part_acc,
                 float* __restrict__ part_ml) {
  __shared__ float s_m[kWarps][T][kHeads], s_l[kWarps][T][kHeads];
  __shared__ __align__(16) float s_acc[kWarps][T][kInner];
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4 qv[T], acc[T];
  float m[T], l[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    qv[t] = ld4(q + ((long long)b * T + t) * kInner + 4 * lane);
    acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    m[t] = -INFINITY;
    l[t] = 0.f;
  }
  const int lo = s * kChunk + warp * (kChunk / kWarps);
  const int hi = min(lo + kChunk / kWarps, N);
  const long long base = (long long)b * N * kInner + 4 * lane;
  for (int r0 = lo; r0 < hi; r0 += kGroup) {  // r0 and hi are the warp's own: no divergence
    float4 kk[kGroup], vv[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const bool in = r0 + g < hi;
      kk[g] = in ? ld4(k + base + (long long)(r0 + g) * kInner) : make_float4(0.f, 0.f, 0.f, 0.f);
      vv[g] = in ? ld4(v + base + (long long)(r0 + g) * kInner) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float sc[kGroup];
      float mx = m[t];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float d = head_sum(dot4(qv[t], kk[g])) * kScale;
        sc[g] = r0 + g < hi ? d : -INFINITY;
        mx = fmaxf(mx, sc[g]);
      }
      const float corr = expf(m[t] - mx);  // 0 at the first group (m = -inf)
      l[t] *= corr;
      acc[t] = make_float4(acc[t].x * corr, acc[t].y * corr, acc[t].z * corr, acc[t].w * corr);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float p = expf(sc[g] - mx);
        l[t] += p;
        acc[t] = axpy4(p, vv[g], acc[t]);
      }
      m[t] = mx;
    }
  }
  // the block's warps merged: a warp without rows has m = -inf, l = 0, acc = 0
  const int h = lane >> 2;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if ((lane & 3) == 0) {
      s_m[warp][t][h] = m[t];
      s_l[warp][t][h] = l[t];
    }
    st4(&s_acc[warp][t][4 * lane], acc[t]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T * kInner; i += kThreads) {
    const int t = i / kInner, c = i % kInner, hh = c / kHeadDim;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w][t][hh]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(s_m[w][t][hh] - M);
      L = fmaf(s_l[w][t][hh], e, L);
      A = fmaf(s_acc[w][t][c], e, A);
    }
    const long long at = ((long long)b * S + s) * T + t;
    part_acc[at * kInner + c] = A;
    if (c % kHeadDim == 0) {
      part_ml[(at * kHeads + hh) * 2] = M;
      part_ml[(at * kHeads + hh) * 2 + 1] = L;
    }
  }
}

// the S chunks' partials of one prompt merged in index order: out (B, T, kInner)
__global__ void t2i_combine_kernel(const float* __restrict__ part_acc,
                                   const float* __restrict__ part_ml, int S, int T,
                                   float* __restrict__ out) {
  const int b = blockIdx.x, t = threadIdx.x / kInner, c = threadIdx.x % kInner;
  const int hh = c / kHeadDim;
  const long long first = (long long)b * S * T + t;  // chunk s: first + s * T
  float M = -INFINITY;
  for (int s = 0; s < S; ++s) M = fmaxf(M, part_ml[((first + (long long)s * T) * kHeads + hh) * 2]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < S; ++s) {
    const long long at = first + (long long)s * T;
    const float e = expf(part_ml[(at * kHeads + hh) * 2] - M);
    L = fmaf(part_ml[(at * kHeads + hh) * 2 + 1], e, L);
    A = fmaf(part_acc[at * kInner + c], e, A);
  }
  out[((long long)b * T + t) * kInner + c] = A / L;
}

// Image to token: each row of q (B, N, kInner) against its prompt's T keys
// and values (B, T, kInner), into out (B, N, kInner).
template <int T>
__global__ void __launch_bounds__(kThreads)
i2t_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, int N, float* __restrict__ out) {
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4 kr[T], vr[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    kr[t] = ld4(k + ((long long)b * T + t) * kInner + 4 * lane);
    vr[t] = ld4(v + ((long long)b * T + t) * kInner + 4 * lane);
  }
  const int lo = blockIdx.x * kChunk + warp * (kChunk / kWarps);
  const int hi = min(lo + kChunk / kWarps, N);
  const long long base = (long long)b * N * kInner + 4 * lane;
  for (int r0 = lo; r0 < hi; r0 += kGroup) {
    float4 qq[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      qq[g] = r0 + g < hi ? ld4(q + base + (long long)(r0 + g) * kInner)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      float sc[T];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        sc[t] = head_sum(dot4(qq[g], kr[t])) * kScale;
        mx = fmaxf(mx, sc[t]);
      }
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        sc[t] = expf(sc[t] - mx);
        sum += sc[t];
      }
      const float inv = 1.f / sum;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int t = 0; t < T; ++t) o = axpy4(sc[t] * inv, vr[t], o);
      if (r0 + g < hi) st4(out + base + (long long)(r0 + g) * kInner, o);
    }
  }
}

// out = LayerNorm(x + y) * w + bias over each row of kWidth, out_pe = out +
// pe[row mod N]; rows = B * N, one warp each
__global__ void __launch_bounds__(kThreads)
residual_ln_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   const float* __restrict__ pe, long long rows, int N, float eps,
                   float* __restrict__ out, float* __restrict__ out_pe) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps
  const int lane = threadIdx.x & 31;
  // a lane: channels 4 lane .. 4 lane + 3 and 128 + the same
  const long long at = row * kWidth + 4 * lane;
  const float4 a0 = add4(ld4(x + at), ld4(y + at));
  const float4 a1 = add4(ld4(x + at + kWidth / 2), ld4(y + at + kWidth / 2));
  const float mean =
      warp_sum(((a0.x + a0.y) + (a0.z + a0.w)) + ((a1.x + a1.y) + (a1.z + a1.w))) *
      (1.f / kWidth);
  const float4 d0 = make_float4(a0.x - mean, a0.y - mean, a0.z - mean, a0.w - mean);
  const float4 d1 = make_float4(a1.x - mean, a1.y - mean, a1.z - mean, a1.w - mean);
  const float var = warp_sum(dot4(d0, d0) + dot4(d1, d1)) * (1.f / kWidth);
  const float rstd = 1.f / sqrtf(var + eps);
  const float4 w0 = ld4(w + 4 * lane), w1 = ld4(w + kWidth / 2 + 4 * lane);
  const float4 b0 = ld4(bias + 4 * lane), b1 = ld4(bias + kWidth / 2 + 4 * lane);
  const float4 o0 = make_float4(fmaf(d0.x * rstd, w0.x, b0.x), fmaf(d0.y * rstd, w0.y, b0.y),
                                fmaf(d0.z * rstd, w0.z, b0.z), fmaf(d0.w * rstd, w0.w, b0.w));
  const float4 o1 = make_float4(fmaf(d1.x * rstd, w1.x, b1.x), fmaf(d1.y * rstd, w1.y, b1.y),
                                fmaf(d1.z * rstd, w1.z, b1.z), fmaf(d1.w * rstd, w1.w, b1.w));
  st4(out + at, o0);
  st4(out + at + kWidth / 2, o1);
  const long long p = (row % N) * kWidth + 4 * lane;
  st4(out_pe + at, add4(o0, ld4(pe + p)));
  st4(out_pe + at + kWidth / 2, add4(o1, ld4(pe + p + kWidth / 2)));
}

template <int T>
int t2i(const float* q, const float* k, const float* v, int B, int N, float* part_acc,
        float* part_ml, float* out, cudaStream_t stream) {
  const int S = (N + kChunk - 1) / kChunk;
  t2i_split_kernel<T><<<dim3(S, B), kThreads, 0, stream>>>(q, k, v, N, part_acc, part_ml);
  t2i_combine_kernel<<<B, T * kInner, 0, stream>>>(part_acc, part_ml, S, T, out);
  return (int)cudaGetLastError();
}

template <int T>
int i2t(const float* q, const float* k, const float* v, int B, int N, float* out,
        cudaStream_t stream) {
  i2t_kernel<T><<<dim3((N + kChunk - 1) / kChunk, B), kThreads, 0, stream>>>(q, k, v, N, out);
  return (int)cudaGetLastError();
}

bool batch_ok(int B, int N) { return B >= 1 && B <= 65535 && N >= 1; }

}  // namespace

// keys, kpe (B, N, C) from the embedding emb, (C, N) or with image_each
// (B, C, N), the dense prompt dense, (C,) or with dense_cells (B, C, N), and
// the positional encoding pe (N, C); one launch either way
extern "C" int gflow_sam_stream_init(const float* emb, const float* dense, const float* pe,
                                     int N, int C, int B, int image_each, int dense_cells,
                                     float* keys, float* kpe, cudaStream_t stream) {
  if (!batch_ok(B, N) || N % kTile || C % kTile || C < kTile || C / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  if (!image_each && !dense_cells)
    stream_init_kernel<<<dim3(N / kTile, C / kTile), kThreads, 0, stream>>>(emb, dense, pe, N,
                                                                           C, B, keys, kpe);
  else
    stream_init_each_kernel<<<dim3(N / kTile, C / kTile, B), kThreads, 0, stream>>>(
        emb, dense, pe, N, C, image_each ? (long long)N * C : 0LL, dense_cells, keys, kpe);
  return (int)cudaGetLastError();
}

// token to image: out (B, T, 128) from q (B, T, 128) and k, v (B, N, 128);
// part_acc (B, S, T, 128) and part_ml (B, S, T, 8, 2) scratch, S =
// ceil(N / 256)
extern "C" int gflow_sam_t2i_attend(const float* q, const float* k, const float* v, int B,
                                    int T, int N, float* part_acc, float* part_ml, float* out,
                                    cudaStream_t stream) {
  if (!batch_ok(B, N)) return (int)cudaErrorInvalidValue;
  switch (T) {
    case 1: return t2i<1>(q, k, v, B, N, part_acc, part_ml, out, stream);
    case 2: return t2i<2>(q, k, v, B, N, part_acc, part_ml, out, stream);
    case 3: return t2i<3>(q, k, v, B, N, part_acc, part_ml, out, stream);
    case 4: return t2i<4>(q, k, v, B, N, part_acc, part_ml, out, stream);
    case 5: return t2i<5>(q, k, v, B, N, part_acc, part_ml, out, stream);
    case 6: return t2i<6>(q, k, v, B, N, part_acc, part_ml, out, stream);
    case 7: return t2i<7>(q, k, v, B, N, part_acc, part_ml, out, stream);
    case kMaxT: return t2i<kMaxT>(q, k, v, B, N, part_acc, part_ml, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// image to token: out (B, N, 128) from q (B, N, 128) and k, v (B, T, 128)
extern "C" int gflow_sam_i2t_attend(const float* q, const float* k, const float* v, int B,
                                    int T, int N, float* out, cudaStream_t stream) {
  if (!batch_ok(B, N)) return (int)cudaErrorInvalidValue;
  switch (T) {
    case 1: return i2t<1>(q, k, v, B, N, out, stream);
    case 2: return i2t<2>(q, k, v, B, N, out, stream);
    case 3: return i2t<3>(q, k, v, B, N, out, stream);
    case 4: return i2t<4>(q, k, v, B, N, out, stream);
    case 5: return i2t<5>(q, k, v, B, N, out, stream);
    case 6: return i2t<6>(q, k, v, B, N, out, stream);
    case 7: return i2t<7>(q, k, v, B, N, out, stream);
    case kMaxT: return i2t<kMaxT>(q, k, v, B, N, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out, out_pe (B, N, 256): LayerNorm(x + y) (weight w, bias, eps) and it
// plus pe (N, 256)
extern "C" int gflow_sam_residual_ln(const float* x, const float* y, const float* w,
                                     const float* bias, const float* pe, int B, int N,
                                     float eps, float* out, float* out_pe,
                                     cudaStream_t stream) {
  if (!batch_ok(B, N)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * N;
  residual_ln_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      x, y, w, bias, pe, rows, N, eps, out, out_pe);
  return (int)cudaGetLastError();
}
