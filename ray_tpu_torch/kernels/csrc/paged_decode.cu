// Paged-attention decode for Hopper (sm_90a): one new query token per
// sequence attends to its KV cache, read page by page through the
// sequence's block table.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_paged_decode_kernel
// (launched by paged_attention_decode there) and computes the same
// function:
//   s   = (q * sm_scale rounded to q's dtype) . k^T, f32 accumulation
//   s   = -1e30 at positions >= lengths[b] (finite, never -inf)
//   softmax with a running max m and normaliser l (f32), l summed from
//   the unrounded p
//   acc = acc * alpha + p.v, with p rounded to the input dtype first
//   out = acc / max(l, 1e-30), rounded to q's dtype
//
// Bound on this card: decode attention does ~2 FLOP per byte of KV it
// reads, far below the H100's ~295 FLOP/byte ridge, so it is bound by
// HBM bytes: per layer, sum_b ceil(len_b / bs) * bs * Hkv * D * 2 *
// sizeof(dtype) bytes of K and V, over 3.35 TB/s.
//
// Design against that bound (flash-decoding):
//   * the KV range of each (sequence, kv head) is split across CTAs:
//     split i takes pages [i * split_pages, (i + 1) * split_pages) of
//     the block table. The layout comes from NB, bs and the tile size
//     alone (ops/attention.py: paged_split_plan), so the wrapper never
//     reads the lengths on the host; a split CTA whose first page lies
//     past its sequence's length writes an empty partial (m = -1e30,
//     l = 0, acc = 0) and exits. The longest sequence no longer walks
//     its pages alone while the short ones' CTAs have finished;
//   * a split streams tiles of 8 KB of K (and of V) through a 2-stage
//     ring, so tile j+1 is in flight while tile j is computed. One
//     thread loads a tile with TMA, one box of [box_rows tokens, D] per
//     piece of a page (a page's tokens are Hkv * D apart: a 2-D tensor
//     map over [P * bs, Hkv * D]), behind an mbarrier; per-vector
//     cp.async took the threads more instructions than the math. The
//     split's page numbers are read once, in parallel with its length;
//     rows past the length are never used (their p is 0 and their v is
//     skipped);
//   * every warp works on every tile: lane (sub, vec) owns 16-byte
//     vector vec of row sub of each warp pass, so the scores, the
//     softmax and p . V all run on the 4 warps at G = 1 as well. Each
//     warp keeps its own running max, sum and acc over its rows; the
//     warps' partials are merged in shared memory once per split. G
//     and D are template arguments, so the shuffles that sum a row's
//     lanes unroll and the rows' chains overlap: on the card the math
//     of a tile, not the bytes, sets a split's time;
//   * the G = H / Hkv query heads of the group share every K/V byte
//     (GQA reuse); the dots stay on the CUDA cores (at G = 1 this is a
//     matrix-vector product);
//   * a second kernel merges the splits of each (b, query head) in
//     split order: M = max m_i, l = sum l_i e^(m_i - M), acc = sum
//     acc_i e^(m_i - M), out = acc / max(l, 1e-30). A second launch
//     rather than the last split CTA through a counter: no counter to
//     zero or reset between calls, no atomics or fences, and the sum
//     order is fixed, so the result is deterministic.
//
// Plain C interface, loaded with ctypes by ray_tpu_torch/kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;           // rows of a tile per lane
constexpr int kTileBytes = 8192;   // bytes of K (and of V) per tile
constexpr int kStages = 2;
constexpr int kSmemBytes = kStages * 2 * kTileBytes;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

// Dynamic shared memory of a split CTA: the ring, its mbarriers, the
// split's page numbers.
constexpr size_t smem_bytes(int split_pages) {
  return kSmemBytes + kStages * sizeof(uint64_t) + split_pages * sizeof(int);
}

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

// The 16 / sizeof(T) elements of a 16-byte vector, widened to f32.
template <typename T>
__device__ __forceinline__ void widen(const uint4& u,
                                      float (&f)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) f[i] = to_float(e[i]);
}

// One split of one (sequence, kv head): grid (n_splits, Hkv, B). Writes
// the partial of each of the group's G query heads to ws [B, H,
// n_splits, D + 2] f32, a row being (m, l, acc[D]) with acc not yet
// divided by l. Shared memory: the ring (kStages stages of a K tile
// then a V tile, [n_row][D] each; reused for the warps' merge), its
// kStages mbarriers, then the split's page numbers.
template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const T* __restrict__ q,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ lengths, float* __restrict__ ws,
                   float sm_scale, int Hkv, int bs, int NB, int split_pages,
                   int n_splits, int box_rows) {
  constexpr int E = 16 / sizeof(T);  // elements in one 16-byte vector
  constexpr int vpr = D / E;         // lanes (vectors) per row
  constexpr int tpw = 32 / vpr;      // rows of one warp pass
  constexpr int n_row = kRows * kWarps * tpw;  // rows (tokens) per tile
  static_assert(vpr >= 1 && vpr <= 32 && 32 % vpr == 0,
                "a row is 16 to 512 bytes, a power of two");
  extern __shared__ __align__(128) unsigned char smem[];
  const int split = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = Hkv * G;
  const int W = D + 2;  // a partial's row
  // head g's row of this split: part + g * n_splits * W
  float* part =
      ws + (((size_t)b * H + (size_t)hkv * G) * n_splits + split) * W;
  const size_t head_stride = (size_t)n_splits * W;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSmemBytes);
  int* pages = reinterpret_cast<int*>(full + kStages);

  // the length and the split's page numbers, read at once (the pages
  // past the length are in the table too, and go unused)
  const int len = __ldg(lengths + b);
  const int p0 = split * split_pages;
  const int* bt = block_tables + (size_t)b * NB + p0;
  for (int i = tid; i < min(split_pages, NB - p0); i += kThreads)
    pages[i] = __ldg(bt + i);
  const int n_pages = min(len > 0 ? (len + bs - 1) / bs : 0, NB);
  if (p0 >= n_pages) {  // nothing of the sequence in this split
    for (int i = tid; i < G * W; i += kThreads)
      part[(i / W) * head_stride + i % W] = i % W == 0 ? kNegInf : 0.f;
    return;
  }
  const int sub = lane / vpr, vec = lane % vpr;
  // tokens of the split that are part of the sequence
  const int n_tok = min(min(p0 + split_pages, n_pages) * bs, len) - p0 * bs;
  const int n_tiles = (n_tok + n_row - 1) / n_row;
  T* ring = reinterpret_cast<T*>(smem);
  const int stage = 2 * n_row * D;            // elements per stage
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) rtt::bar_init(&full[st], 1);
    rtt::bar_fence_init();
  }
  __syncthreads();

  // tile j's K and V rows into stage j % kStages by TMA (thread 0): the
  // boxes that hold a token of the split's sequence
  auto issue = [&](int j) {
    T* k_s = ring + (j % kStages) * stage;
    T* v_s = k_s + n_row * D;
    const int t0 = j * n_row;
    const int boxes = (min(n_row, n_tok - t0) + box_rows - 1) / box_rows;
    uint64_t* bar = &full[j % kStages];
    rtt::bar_expect_tx(bar, boxes * box_rows * D * (int)sizeof(T) * 2);
    for (int x = 0; x < boxes; ++x) {
      const int t = t0 + x * box_rows;         // token within the split
      const int row = pages[t / bs] * bs + t % bs;
      rtt::tma_load_2d(k_s + x * box_rows * D, &tm_k, bar, hkv * D, row);
      rtt::tma_load_2d(v_s + x * box_rows * D, &tm_v, bar, hkv * D, row);
    }
  };
  if (tid == 0) {
    issue(0);
    if (n_tiles > 1) issue(1);
  }

  // the lane's slice of q, scaled and rounded as the reference does
  float qr[G][E];
  const T* qb = q + ((size_t)b * H + (size_t)hkv * G) * D + vec * E;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    widen<T>(*reinterpret_cast<const uint4*>(qb + (size_t)g * D), qr[g]);
#pragma unroll
    for (int i = 0; i < E; ++i) qr[g][i] = round_to<T>(qr[g][i] * sm_scale);
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[g][i] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    rtt::bar_wait(&full[j % kStages], (j / kStages) & 1);  // tile j is in
    const T* k_s = ring + (j % kStages) * stage;
    const T* v_s = k_s + n_row * D;
    // scores of the lane's rows: the vpr lanes of a row each take one
    // vector of the dot, then sum over the row's lanes (all rows' dots
    // first, so that their shuffles overlap)
    float s[kRows][G];
    bool live[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = (r * kWarps + warp) * tpw + sub;
      live[r] = j * n_row + t < n_tok;
      float kf[E];
      widen<T>(reinterpret_cast<const uint4*>(k_s)[t * vpr + vec], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) dot += qr[g][i] * kf[i];
        s[r][g] = dot;
      }
    }
#pragma unroll
    for (int off = vpr >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[r][g] += __shfl_xor_sync(0xffffffffu, s[r][g], off);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (!live[r]) s[r][g] = kNegInf;
    // the warp's running max over its rows of the tile, and the rescale
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int r = 1; r < kRows; ++r) mx = fmaxf(mx, s[r][g]);
#pragma unroll
      for (int off = vpr; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[g][i] *= alpha;
    }
    // p = exp(s - m) where live; l sums p unrounded, acc takes p
    // rounded to the input dtype times the lane's vector of v (rows past
    // the length hold stale data: skipped, so that a NaN there stays out)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!live[r]) continue;
      const int t = (r * kWarps + warp) * tpw + sub;
      float vf[E];
      widen<T>(reinterpret_cast<const uint4*>(v_s)[t * vpr + vec], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = expf(s[r][g] - m[g]);
        l[g] += p;
        const float pr = round_to<T>(p);
#pragma unroll
        for (int i = 0; i < E; ++i) acc[g][i] += pr * vf[i];
      }
    }
    __syncthreads();  // every warp is done with the stage
    if (tid == 0 && j + 2 < n_tiles) issue(j + 2);
  }

  // the warp's sums over its rows: the lanes of one vector column
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int off = vpr; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int i = 0; i < E; ++i)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
    }
  // merge the warps in shared memory (the ring is free): wm, wl
  // [kWarps][G], wacc [kWarps][G][D]
  float* wm = reinterpret_cast<float*>(smem);
  float* wl = wm + kWarps * G;
  float* wacc = wl + kWarps * G;
  __syncthreads();
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < E; ++i)
        wacc[(warp * G + g) * D + vec * E + i] = acc[g][i];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * G + g] - mx);
      a += wacc[(w * G + g) * D + d] * f;
      lsum += wl[w * G + g] * f;
    }
    float* row = part + g * head_stride;
    row[2 + d] = a;
    if (d == 0) {
      row[0] = mx;
      row[1] = lsum;
    }
  }
}

// out [B*H, D] from the partials ws [B*H, n_splits, D + 2]: one CTA
// per (b, query head); the splits' factors e^(m_i - M) go to shared
// memory, then each thread merges the splits of its d in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine(const float* __restrict__ ws, T* __restrict__ out,
                     int n_splits, int D) {
  extern __shared__ float f[];  // [n_splits]
  const int W = D + 2;
  const float* w = ws + (size_t)blockIdx.x * n_splits * W;
  for (int i = threadIdx.x; i < n_splits; i += kThreads) f[i] = w[i * W];
  __syncthreads();
  float mx = kNegInf;
  for (int i = 0; i < n_splits; ++i) mx = fmaxf(mx, f[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < n_splits; i += kThreads)
    f[i] = expf(f[i] - mx);
  __syncthreads();
  float l = 0.f;
  for (int i = 0; i < n_splits; ++i) l += w[i * W + 1] * f[i];
  l = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_splits; ++i) a += w[i * W + 2 + d] * f[i];
    out[(size_t)blockIdx.x * D + d] = from_float<T>(a / l);
  }
}

// [P * bs, Hkv * D] rows of a page pool (a token's kv heads side by
// side) as a 2-D tensor map; boxes of box_rows tokens of one head.
inline bool page_map(CUtensorMap* map, const void* base, int dtype,
                     long long rows, int width, int D, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * (dtype == 1 ? 2 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)D, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return rtt::encode_tiled() != nullptr &&
         rtt::encode_tiled()(
             map, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int G, int D>
int launch(const CUtensorMap& tm_k, const CUtensorMap& tm_v, const void* q,
           const void* block_tables, const void* lengths, void* out,
           void* ws, float sm_scale, int B, int Hkv, int bs, int NB,
           int split_pages, int n_splits, int box_rows,
           cudaStream_t stream) {
  const dim3 grid(n_splits, Hkv, B);
  paged_decode_split<T, G, D><<<grid, kThreads, smem_bytes(split_pages),
                                stream>>>(
      tm_k, tm_v, static_cast<const T*>(q),
      static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
      static_cast<float*>(ws), sm_scale, Hkv, bs, NB, split_pages, n_splits,
      box_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_combine<T><<<B * Hkv * G, kThreads, n_splits * sizeof(float),
                            stream>>>(static_cast<const float*>(ws),
                                      static_cast<T*>(out), n_splits, D);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on G = 1..kMaxG and on D, a row of 32 to 512 bytes.
template <typename T>
int launch_gd(int G, int D, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
              const void* q, const void* block_tables, const void* lengths,
              void* out, void* ws, float sm_scale, int B, int Hkv, int bs,
              int NB, int split_pages, int n_splits, int box_rows,
              cudaStream_t stream) {
#define RTT_CASE(g, d)                                                     \
  if (G == g && D == d)                                                    \
    return launch<T, g, d>(tm_k, tm_v, q, block_tables, lengths, out, ws,   \
                           sm_scale, B, Hkv, bs, NB, split_pages, n_splits, \
                           box_rows, stream);
#define RTT_DIMS(g)                                                    \
  RTT_CASE(g, 16) RTT_CASE(g, 32) RTT_CASE(g, 64) RTT_CASE(g, 128)     \
  if constexpr (sizeof(T) == 2) {                                      \
    RTT_CASE(g, 256)                                                   \
  }
  RTT_DIMS(1) RTT_DIMS(2) RTT_DIMS(3) RTT_DIMS(4)
  RTT_DIMS(5) RTT_DIMS(6) RTT_DIMS(7) RTT_DIMS(8)
#undef RTT_DIMS
#undef RTT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

static_assert(kMaxG == 8, "launch_gd instantiates G = 1 .. 8");

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. k_pages, v_pages [P, bs, Hkv, D];
// ws: [B, Hkv * G, n_splits, D + 2] f32 scratch. Returns the
// cudaError_t of the launches (0 on success); the caller checked
// shapes, types, alignment, that G <= 8 and D is 16, 32, 64, 128 (or
// 256 in bf16), and that split_pages, n_splits, box_rows follow
// paged_split_plan.
int rtt_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                     const void* block_tables, const void* lengths, void* out,
                     void* ws, int dtype, float sm_scale, int B, int Hkv,
                     int G, int D, int bs, int NB, int P, int split_pages,
                     int n_splits, int box_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tm_k, tm_v;
  const long long rows = (long long)P * bs;
  if (!page_map(&tm_k, k_pages, dtype, rows, Hkv * D, D, box_rows) ||
      !page_map(&tm_v, v_pages, dtype, rows, Hkv * D, D, box_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return launch_gd<__nv_bfloat16>(G, D, tm_k, tm_v, q, block_tables,
                                    lengths, out, ws, sm_scale, B, Hkv, bs,
                                    NB, split_pages, n_splits, box_rows, s);
  return launch_gd<float>(G, D, tm_k, tm_v, q, block_tables, lengths, out,
                          ws, sm_scale, B, Hkv, bs, NB, split_pages,
                          n_splits, box_rows, s);
}

// Dynamic shared memory per split CTA of a launch with `split_pages`
// pages per split (paged_split_plan mirrors it).
int rtt_paged_decode_smem_bytes(int split_pages) {
  return static_cast<int>(smem_bytes(split_pages));
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
