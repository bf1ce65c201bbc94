// Paged-attention decode for Hopper (sm_90a): one new query token per
// sequence attends to its KV cache, read page by page through the
// sequence's block table.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_paged_decode_kernel
// (launched by paged_attention_decode there) and computes the same
// function:
//   s   = (q * sm_scale rounded to q's dtype) . k^T, f32 accumulation
//   s   = -1e30 at positions >= lengths[b] (finite, never -inf)
//   online softmax with running max m and normaliser l (f32)
//   acc = acc * alpha + p.v, with p rounded to the input dtype first
//   out = acc / max(l, 1e-30), rounded to q's dtype
//
// Bound on this card: decode attention does ~2 FLOP per byte of KV it
// reads, far below the H100's ~295 FLOP/byte ridge, so it is bound by
// HBM bytes: per layer, sum_b ceil(len_b / bs) * bs * Hkv * D * 2 *
// sizeof(dtype) bytes of K and V, over 3.35 TB/s.
//
// Design against that bound:
//   * one CTA per (sequence, kv head); the G = H / Hkv query heads of
//     the group share every K/V byte the CTA loads (GQA reuse);
//   * each CTA reads its own block-table row and length and walks only
//     ceil(len / bs) pages -- pages past the length are never read
//     (they would add exactly 0, since masked logits are finite);
//   * pages are loaded a tile of several pages at a time with 16-byte
//     coalesced loads (a page's [bs, D] rows sit Hkv * D apart), so
//     each thread keeps several loads in flight per tile;
//   * the S x D scores never leave shared memory.
// Not done yet (later work): split-KV across CTAs ("flash-decoding")
// for small batches, cp.async/TMA double buffering, tensor-core dots.
//
// Plain C interface, loaded with ctypes by ray_tpu_torch/kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 8;  // output elements per thread: G * D <= 1024
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back: the cast the reference applies.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared memory, in order: K tile [tile, D] T, V tile [tile, D] T,
// q [G, D] f32, p [G, tile] f32, m [G], l [G], alpha [G] f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float sm_scale, int Hkv, int G, int D, int bs, int NB,
                    int tile_pages) {
  constexpr int E = 16 / sizeof(T);  // elements in one 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = tile_pages * bs;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + tile * D;
  float* q_s = reinterpret_cast<float*>(v_s + tile * D);
  float* p_s = q_s + G * D;
  float* m_s = p_s + G * tile;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int hkv = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = Hkv * G;
  const int len = lengths[b];
  int n_pages = len > 0 ? (len + bs - 1) / bs : 0;
  if (n_pages > NB) n_pages = NB;
  const int* bt = block_tables + (size_t)b * NB;
  const size_t row_stride = (size_t)Hkv * D;  // between a page's tokens

  const T* qb = q + ((size_t)b * H + (size_t)hkv * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = round_to<T>(to_float(qb[i]) * sm_scale);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  const int vpr = D / E;     // 16-byte vectors in one K or V row
  const int tpw = 32 / vpr;  // rows one warp covers in one pass
  const int sub = lane / vpr;
  const int vec = lane % vpr;
  __syncthreads();

  for (int j0 = 0; j0 < n_pages; j0 += tile_pages) {
    const int np = min(tile_pages, n_pages - j0);
    const int n_tok = np * bs;

    // 1. K and V rows of this tile's pages into shared memory
    for (int vi = tid; vi < n_tok * vpr; vi += kThreads) {
      const int t = vi / vpr;
      const int page = __ldg(bt + j0 + t / bs);
      const size_t src = ((size_t)page * bs + t % bs) * row_stride +
                         (size_t)hkv * D + (size_t)(vi % vpr) * E;
      reinterpret_cast<uint4*>(k_s)[vi] =
          __ldg(reinterpret_cast<const uint4*>(k_pages + src));
      reinterpret_cast<uint4*>(v_s)[vi] =
          __ldg(reinterpret_cast<const uint4*>(v_pages + src));
    }
    __syncthreads();

    // 2. scores: vpr lanes share one row, one 16-byte vector each
    for (int t0 = warp * tpw; t0 < n_tok; t0 += kWarps * tpw) {
      const int t = t0 + sub;
      const bool live = t < n_tok;
      float kf[E];
      if (live) {
        const uint4 u = reinterpret_cast<const uint4*>(k_s)[t * vpr + vec];
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < E; ++i) kf[i] = to_float(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) kf[i] = 0.f;
      }
      for (int g = 0; g < G; ++g) {
        const float* qg = q_s + g * D + vec * E;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) part += qg[i] * kf[i];
        for (int off = vpr >> 1; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (live && vec == 0)
          p_s[g * tile + t] = (j0 * bs + t < len) ? part : kNegInf;
      }
    }
    __syncthreads();

    // 3. online softmax, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* s = p_s + g * tile;
      float mx = kNegInf;
      for (int t = lane; t < n_tok; t += 32) mx = fmaxf(mx, s[t]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < n_tok; t += 32) {
        const float p = expf(s[t] - m_new);
        sum += p;
        s[t] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p . V, thread per (head, d) output element
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * D) {
        const int g = idx / D;
        const int d = idx % D;
        const float* p = p_s + g * tile;
        float a = acc[i] * a_s[g];
        for (int t = 0; t < n_tok; ++t) a += p[t] * to_float(v_s[t * D + d]);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * H + (size_t)hkv * G) * D;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < G * D)
      ob[idx] = from_float<T>(acc[i] / fmaxf(l_s[idx / D], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* lengths, void* out,
           float sm_scale, int B, int Hkv, int G, int D, int bs, int NB,
           int tile_pages, size_t smem, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), sm_scale, Hkv,
      G, D, bs, NB, tile_pages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 on success); the caller checked shapes, types and alignment.
int rtt_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                     const void* block_tables, const void* lengths, void* out,
                     int dtype, float sm_scale, int B, int Hkv, int G, int D,
                     int bs, int NB, int tile_pages, size_t smem,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths,
                                 out, sm_scale, B, Hkv, G, D, bs, NB,
                                 tile_pages, smem, s);
  return launch<float>(q, k_pages, v_pages, block_tables, lengths, out,
                       sm_scale, B, Hkv, G, D, bs, NB, tile_pages, smem, s);
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
