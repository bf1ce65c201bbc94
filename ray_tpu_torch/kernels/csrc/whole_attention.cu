// Whole-kv self-attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels ray_tpu/ops/attention.py:_whole_fwd_kernel
// (launched by _whole_forward) and _whole_bwd_kernel (launched by
// _whole_backward), and computes the same functions on q pre-scaled by
// sm_scale (the wrapper folds the scale into q, as the JAX one does):
//
// forward   s   = q . k^T, f32 accumulation
//           e   = exp(min(s, 50) - 25), 0 above the diagonal (causal)
//           l   = max(sum_k e, 1e-30) from the UNROUNDED f32 e
//           o   = (e rounded to the input dtype) . v / l, rounded
//           lse = log(l) + 25
// backward  p   = exp(min(s, 50) - lse), 0 above the diagonal
//           dp  = do . v^T
//           ds  = p * (dp - delta), rounded to the input dtype
//           dq  = ds . k;  dk = ds^T . q;  dv = (p rounded)^T . do
//           (delta = rowsum(o * do) comes from the wrapper, as in JAX)
//
// No running max: softmax is shift-invariant, so the static shift with
// the cap at 50 replaces the max/rescale passes. That makes the tiles
// of a row independent -- l and acc just add -- which is what lets a
// GPU split the work freely.
//
// Bound on this card at GPT-2 training's shape (b16 h12 s1024 d64,
// bf16, causal): the forward moves ~101 MB for ~26 GFLOP and is bound
// by HBM bytes (~0.030 ms); the backward does ~64 GFLOP on ~178 MB and
// is bound by tensor-core operations (~0.065 ms).
//
// Design. The TPU grid gives one program a whole [bq = s, s] score
// block in VMEM and walks q blocks in order, carrying dk/dv in VMEM.
// A GPU runs CTAs at once and has 227 KB of shared memory, so:
//   * both kernels cut the sequence into 64-row tiles; a CTA owns one
//     tile of q rows (forward, dq) or of keys (dk, dv) and walks the
//     64-row tiles of the other side through shared memory;
//   * causal tiles wholly above the diagonal are skipped (the TPU
//     computes and zeroes them: e there is exactly 0, the same
//     function); only the diagonal tile is masked;
//   * the forward's tiles are independent, so nothing crosses CTAs;
//   * the backward is one launch with two kinds of CTA (FA2's split):
//     a kv-tile CTA loops over the q tiles at or below the diagonal
//     and sums dk, dv in registers; a q-tile CTA loops over the kv
//     tiles and sums dq. No atomics, deterministic; dk/dv are summed
//     in f32 and rounded once (JAX rounds per q block of 512 rows,
//     which differs only at s > 1024);
//   * CTAs with the most tiles are launched first, so the long causal
//     rows do not trail at the end of the grid.
// bf16 inputs (training) run on the tensor cores (mma.sync, below);
// f32 inputs on the CUDA cores with fma, 16 x 16 threads each owning a
// 4 x 4 piece of the score tile. Neither pipelines its loads (no
// cp.async/TMA double buffering, no wgmma): later work.
//
// Plain C interface, loaded with ctypes by ray_tpu_torch/kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTile = 64;       // rows of q and of k/v per tile
constexpr int kThreads = 256;   // 16 x 16; each owns a 4 x 4 score piece
constexpr float kCapHi = 50.f;
constexpr float kCapShift = 25.f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// min(s, 50) that keeps a NaN a NaN, as jnp.minimum does.
__device__ __forceinline__ float cap(float s) {
  return s > kCapHi ? kCapHi : s;
}

// A 64 x D tile of a row-major [S, D] slab into shared memory,
// row-major: dst[r * D + c].
template <int D>
__device__ __forceinline__ void tile_rows(const float* __restrict__ src,
                                          float* dst) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    *reinterpret_cast<float4*>(dst + r * D + c) = ld4(src + (size_t)r * D + c);
  }
}

// The same tile transposed: dst[c * 64 + r]. Rows run fastest across
// threads, so the scalar stores of a warp land in distinct banks.
template <int D>
__device__ __forceinline__ void tile_cols(const float* __restrict__ src,
                                          float* dst) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i % kTile, c = (i / kTile) * 4;
    const float4 x = ld4(src + (size_t)r * D + c);
    dst[(c + 0) * kTile + r] = x.x;
    dst[(c + 1) * kTile + r] = x.y;
    dst[(c + 2) * kTile + r] = x.z;
    dst[(c + 3) * kTile + r] = x.w;
  }
}

// acc[i][j] += sum_{d < N} a[d][ra + i] * b[d][rb + j]; a and b are
// transposed tiles ([N][64]) in shared memory.
template <int N>
__device__ __forceinline__ void mul_tn(float (&acc)[4][4], const float* a,
                                       const float* b, int ra, int rb) {
#pragma unroll 8
  for (int d = 0; d < N; ++d) {
    const float4 x = ld4(a + d * kTile + ra);
    const float4 y = ld4(b + d * kTile + rb);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
  }
}

// acc[i][c] += sum_{k < 64} p[k][ra + i] * m[k][c0 + c] for c < D/16;
// p is a [64][64] tile, m a row-major [64][D] tile.
template <int D>
__device__ __forceinline__ void mul_pn(float (&acc)[4][D / 16],
                                       const float* p, const float* m,
                                       int ra, int c0) {
  constexpr int C = D / 16;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    const float4 x = ld4(p + k * kTile + ra);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    float ys[C];
    if constexpr (C % 4 == 0) {
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        const float4 y = ld4(m + k * D + c0 + c);
        ys[c] = y.x;
        ys[c + 1] = y.y;
        ys[c + 2] = y.z;
        ys[c + 3] = y.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) ys[c] = m[k * D + c0 + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = fmaf(xs[i], ys[c], acc[i][c]);
  }
}

template <int D>
constexpr size_t fwd_smem_floats() {
  return 3 * D * kTile + kTile * kTile;
}

template <int D>
constexpr size_t bwd_smem_floats() {
  // kv-tile CTA: Kt, Vt, Qt|Pt, dOt|dSt, Qs, dOs, lse, delta
  // q-tile CTA:  Qt, dOt, Kt, Vt, Ks, dSt, lse, delta
  constexpr size_t R = (D > kTile ? D : kTile) * kTile;
  constexpr size_t kv = 4 * D * kTile + 2 * R + 2 * kTile;
  constexpr size_t q = 5 * D * kTile + kTile * kTile + 2 * kTile;
  return kv > q ? kv : q;
}

// ------------------------------------------------------ f32 path: forward

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
whole_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int BH, int S, int causal) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem_f4[];
  float* Qt = reinterpret_cast<float*>(smem_f4);  // [D][64]
  float* Kt = Qt + D * kTile;                     // [D][64]
  float* Vs = Kt + D * kTile;                     // [64][D]
  float* Et = Vs + kTile * D;                     // [64 keys][64 rows]

  const int nt = S / kTile;
  const int qt = nt - 1 - (int)(blockIdx.x / BH);  // longest rows first
  const int bh = blockIdx.x % BH;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t slab = (size_t)bh * S * D;

  tile_cols<D>(q + slab + (size_t)qt * kTile * D, Qt);
  float acc[4][C] = {};
  float lsum[4] = {};
  const int n_kv = causal ? qt + 1 : nt;
  for (int kt = 0; kt < n_kv; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    tile_cols<D>(k + slab + (size_t)kt * kTile * D, Kt);
    tile_rows<D>(v + slab + (size_t)kt * kTile * D, Vs);
    __syncthreads();
    float s[4][4] = {};
    mul_tn<D>(s, Qt, Kt, ty * 4, tx * 4);
    const bool diag = causal && kt == qt;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float e4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float e = expf(cap(s[i][j]) - kCapShift);
        if (diag && tx * 4 + j > ty * 4 + i) e = 0.f;
        lsum[i] += e;
        e4[i] = e;
      }
      *reinterpret_cast<float4*>(Et + (tx * 4 + j) * kTile + ty * 4) =
          make_float4(e4[0], e4[1], e4[2], e4[3]);
    }
    __syncthreads();
    mul_pn<D>(acc, Et, Vs, ty * 4, tx * C);
  }

  // a row's 64 columns are spread over the 16 lanes of a half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], off);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * kTile + ty * 4 + i;
    const float l = lsum[i] < 1e-30f ? 1e-30f : lsum[i];  // NaN stays NaN
    float* orow = o + slab + (size_t)row * D + tx * C;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[c] = acc[i][c] / l;
    if (tx == 0) lse[(size_t)bh * S + row] = logf(l) + kCapShift;
  }
}

// ----------------------------------------------------- f32 path: backward

// dk, dv of one kv tile: loop over the q tiles at or below the diagonal.
// The thread's 4 x 4 score piece is keys ty*4.. by queries tx*4...
template <int D>
__device__ __forceinline__ void dkdv_tile(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    int S, int kt, int causal, float* smem) {
  constexpr int C = D / 16;
  constexpr int R = (D > kTile ? D : kTile) * kTile;
  float* Kt = smem;              // [D][64]
  float* Vt = Kt + D * kTile;    // [D][64]
  float* Qt = Vt + D * kTile;    // [D][64]; then Pt [64 q][64 keys]
  float* dOt = Qt + R;           // [D][64]; then dSt [64 q][64 keys]
  float* Qs = dOt + R;           // [64][D]
  float* dOs = Qs + kTile * D;   // [64][D]
  float* lse_s = dOs + kTile * D;
  float* delta_s = lse_s + kTile;
  float* Pt = Qt;
  float* dSt = dOt;

  const int nt = S / kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  tile_cols<D>(k + (size_t)kt * kTile * D, Kt);
  tile_cols<D>(v + (size_t)kt * kTile * D, Vt);
  float dk_acc[4][C] = {};
  float dv_acc[4][C] = {};
  for (int qt = causal ? kt : 0; qt < nt; ++qt) {
    __syncthreads();
    const size_t off = (size_t)qt * kTile * D;
    tile_cols<D>(q + off, Qt);
    tile_cols<D>(dout + off, dOt);
    tile_rows<D>(q + off, Qs);
    tile_rows<D>(dout + off, dOs);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse[qt * kTile + threadIdx.x];
      delta_s[threadIdx.x] = delta[qt * kTile + threadIdx.x];
    }
    __syncthreads();
    float st[4][4] = {}, dpt[4][4] = {};
    mul_tn<D>(st, Kt, Qt, ty * 4, tx * 4);    // s^T: keys x queries
    mul_tn<D>(dpt, Vt, dOt, ty * 4, tx * 4);  // dp^T
    __syncthreads();  // Qt and dOt are read: Pt and dSt take their place
    const bool diag = causal && qt == kt;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx * 4 + j;  // query row within the tile
      float p4[4], s4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = expf(cap(st[i][j]) - lse_s[r]);
        if (diag && ty * 4 + i > r) p = 0.f;
        p4[i] = p;
        s4[i] = p * (dpt[i][j] - delta_s[r]);
      }
      *reinterpret_cast<float4*>(Pt + r * kTile + ty * 4) =
          make_float4(p4[0], p4[1], p4[2], p4[3]);
      *reinterpret_cast<float4*>(dSt + r * kTile + ty * 4) =
          make_float4(s4[0], s4[1], s4[2], s4[3]);
    }
    __syncthreads();
    mul_pn<D>(dv_acc, Pt, dOs, ty * 4, tx * C);
    mul_pn<D>(dk_acc, dSt, Qs, ty * 4, tx * C);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (size_t)(kt * kTile + ty * 4 + i) * D + tx * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[row + c] = dk_acc[i][c];
      dv[row + c] = dv_acc[i][c];
    }
  }
}

// dq of one q tile: loop over the kv tiles at or left of the diagonal.
// The thread's 4 x 4 score piece is queries ty*4.. by keys tx*4...
template <int D>
__device__ __forceinline__ void dq_tile(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int S, int qt,
    int causal, float* smem) {
  constexpr int C = D / 16;
  float* Qt = smem;              // [D][64]
  float* dOt = Qt + D * kTile;   // [D][64]
  float* Kt = dOt + D * kTile;   // [D][64]
  float* Vt = Kt + D * kTile;    // [D][64]
  float* Ks = Vt + D * kTile;    // [64][D]
  float* dSt = Ks + kTile * D;   // [64 keys][64 rows]
  float* lse_s = dSt + kTile * kTile;
  float* delta_s = lse_s + kTile;

  const int nt = S / kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qoff = (size_t)qt * kTile * D;
  tile_cols<D>(q + qoff, Qt);
  tile_cols<D>(dout + qoff, dOt);
  if (threadIdx.x < kTile) {
    lse_s[threadIdx.x] = lse[qt * kTile + threadIdx.x];
    delta_s[threadIdx.x] = delta[qt * kTile + threadIdx.x];
  }
  float acc[4][C] = {};
  const int n_kv = causal ? qt + 1 : nt;
  for (int kt = 0; kt < n_kv; ++kt) {
    __syncthreads();
    const size_t off = (size_t)kt * kTile * D;
    tile_cols<D>(k + off, Kt);
    tile_cols<D>(v + off, Vt);
    tile_rows<D>(k + off, Ks);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mul_tn<D>(s, Qt, Kt, ty * 4, tx * 4);
    mul_tn<D>(dp, dOt, Vt, ty * 4, tx * 4);
    const bool diag = causal && kt == qt;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        float p = expf(cap(s[i][j]) - lse_s[r]);
        if (diag && tx * 4 + j > r) p = 0.f;
        d4[i] = p * (dp[i][j] - delta_s[r]);
      }
      *reinterpret_cast<float4*>(dSt + (tx * 4 + j) * kTile + ty * 4) =
          make_float4(d4[0], d4[1], d4[2], d4[3]);
    }
    __syncthreads();
    mul_pn<D>(acc, dSt, Ks, ty * 4, tx * C);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = dq + (size_t)(qt * kTile + ty * 4 + i) * D + tx * C;
#pragma unroll
    for (int c = 0; c < C; ++c) row[c] = acc[i][c];
  }
}

// One launch, 2 * BH * nt CTAs: even ones take a kv tile (dk, dv), odd
// ones a q tile (dq). Rank r = blockIdx / (2 BH) orders them by work:
// kv tile r and q tile nt-1-r each loop over nt - r tiles when causal.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
whole_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 float* __restrict__ dk, float* __restrict__ dv, int BH, int S,
                 int causal) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int nt = S / kTile;
  const int rank = blockIdx.x / (2 * BH);
  const int rem = blockIdx.x % (2 * BH);
  const int bh = rem >> 1;
  const size_t slab = (size_t)bh * S * D;
  const size_t rows = (size_t)bh * S;
  if (rem & 1)
    dq_tile<D>(q + slab, k + slab, v + slab, dout + slab, lse + rows,
                  delta + rows, dq + slab, S, nt - 1 - rank, causal, smem);
  else
    dkdv_tile<D>(q + slab, k + slab, v + slab, dout + slab, lse + rows,
                    delta + rows, dk + slab, dv + slab, S, rank, causal,
                    smem);
}

// ------------------------------------------------ tensor-core path (bf16)
//
// The same two kernels for bf16 inputs on the tensor cores, with
// mma.sync m16n8k16 (bf16 in, f32 accumulate). A CTA is 4 warps; each
// warp owns 16 rows of the CTA's 64-row tile and the 16 x 64 score
// block of those rows against a 64-key tile. Operands sit in shared
// memory as bf16, rows padded by 8 elements so that the fragment loads
// of a warp hit 32 distinct banks; the operands a product needs
// k-major (v for p.v, q and do for dk/dv, k for dq) are stored
// transposed. The score block's accumulator fragment is laid out as
// the A fragment of the next product, so e, p and ds go from f32
// registers to bf16 registers (rounded to nearest even, as the
// reference rounds) without passing through shared memory.

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;
constexpr int kLdT = kTile + 8;  // row stride of a transposed tile

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 (lo at the lower address) from f32, round to nearest even
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ uint32_t lds2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// [64][D] rows of a slab -> shared [64][D + 8], 16-byte copies.
template <int D>
__device__ __forceinline__ void mma_rows(const bf16* __restrict__ src,
                                         bf16* dst) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kTile * kVec; i += kMmaThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

// The same tile transposed: shared [D][64 + 8]; rows run fastest
// across threads, so a warp's 2-byte stores fill 16 distinct words.
template <int D>
__device__ __forceinline__ void mma_cols(const bf16* __restrict__ src,
                                         bf16* dst) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kTile * kVec; i += kMmaThreads) {
    const int r = i % kTile, c = (i / kTile) * 8;
    const uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    bf16 e[8];
    memcpy(e, &u, sizeof(u));
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * kLdT + r] = e[j];
  }
}

// A fragment (16 x 16) of rows r0..r0+15, columns c0..c0+15 of a
// row-major shared tile with row stride ld.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int ld, int r0, int c0, int g, int q) {
  a[0] = lds2(t + (r0 + g) * ld + c0 + 2 * q);
  a[1] = lds2(t + (r0 + g + 8) * ld + c0 + 2 * q);
  a[2] = lds2(t + (r0 + g) * ld + c0 + 8 + 2 * q);
  a[3] = lds2(t + (r0 + g + 8) * ld + c0 + 8 + 2 * q);
}

// c[n] += A (16 x D, rows r0.. of a) . B^T for the 64 rows of b, both
// row-major [.][D + 8]: a 16 x 64 score block in 8 fragments of 8 cols.
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const bf16* a,
                                        const bf16* b, int r0, int g, int q) {
  constexpr int ld = D + 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t fa[4];
    frag_a(fa, a, ld, r0, ks * 16, g, q);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const bf16* row = b + (n * 8 + g) * ld + ks * 16 + 2 * q;
      mma16816(c[n], fa, lds2(row), lds2(row + 8));
    }
  }
}

// c[dn] += P (16 x 64, A fragments in registers) . M (64 x D), M given
// transposed in shared memory ([D][64 + 8]).
template <int D>
__device__ __forceinline__ void mma_pm(float (&c)[D / 8][4],
                                       const uint32_t (&p)[4][4],
                                       const bf16* mt, int g, int q) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* row = mt + (dn * 8 + g) * kLdT + kk * 16 + 2 * q;
      mma16816(c[dn], p[kk], lds2(row), lds2(row + 8));
    }
}

// Score fragment n holds rows g, g + 8 and columns n*8 + 2q, +1 of the
// warp's block: pairs (v0, v1) and (v2, v3) become the A fragment of
// the columns' 16-wide k step.
__device__ __forceinline__ void to_frag(uint32_t (&p)[4][4], int n, float v0,
                                        float v1, float v2, float v3) {
  p[n / 2][(n % 2) * 2] = pack2(v0, v1);
  p[n / 2][(n % 2) * 2 + 1] = pack2(v2, v3);
}

template <int D>
constexpr size_t fwd_mma_smem_bytes() {
  return (2 * kTile * (D + 8) + D * kLdT) * sizeof(bf16);
}

template <int D>
constexpr size_t bwd_mma_smem_bytes() {
  // kv-tile CTA: K, V, Q, dO row-major; Q, dO transposed; lse, delta
  // q-tile CTA:  Q, dO, K, V row-major; K transposed; lse, delta
  return (4 * kTile * (D + 8) + 2 * D * kLdT) * sizeof(bf16) +
         2 * kTile * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
whole_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int BH, int S, int causal) {
  constexpr int ld = D + 8;
  extern __shared__ float4 smem_f4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_f4);  // [64][D + 8]
  bf16* Ks = Qs + kTile * ld;                   // [64][D + 8]
  bf16* Vt = Ks + kTile * ld;                   // [D][64 + 8]

  const int nt = S / kTile;
  const int qt = nt - 1 - (int)(blockIdx.x / BH);  // longest rows first
  const int bh = blockIdx.x % BH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = warp * 16;  // the warp's first row in the tile
  const size_t slab = (size_t)bh * S * D;

  mma_rows<D>(q + slab + (size_t)qt * kTile * D, Qs);
  float acc[D / 8][4] = {};
  float lsum[2] = {};
  const int n_kv = causal ? qt + 1 : nt;
  for (int kt = 0; kt < n_kv; ++kt) {
    __syncthreads();
    mma_rows<D>(k + slab + (size_t)kt * kTile * D, Ks);
    mma_cols<D>(v + slab + (size_t)kt * kTile * D, Vt);
    __syncthreads();
    float s[8][4] = {};
    mma_abt<D>(s, Qs, Ks, r0, g, qd);
    const bool diag = causal && kt == qt;
    uint32_t p[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e[i] = expf(cap(s[n][i]) - kCapShift);
        const int row = r0 + g + (i >> 1) * 8, key = n * 8 + 2 * qd + (i & 1);
        if (diag && key > row) e[i] = 0.f;
      }
      lsum[0] += e[0] + e[1];
      lsum[1] += e[2] + e[3];
      to_frag(p, n, e[0], e[1], e[2], e[3]);
    }
    mma_pm<D>(acc, p, Vt, g, qd);
  }

  // a row's columns are spread over the 4 lanes of a quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qt * kTile + r0 + g + h * 8;
    const float l = lsum[h] < 1e-30f ? 1e-30f : lsum[h];  // NaN stays NaN
    bf16* orow = o + slab + (size_t)row * D + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8) =
          pack2(acc[dn][2 * h] / l, acc[dn][2 * h + 1] / l);
    if (qd == 0) lse[(size_t)bh * S + row] = logf(l) + kCapShift;
  }
}

// dk, dv of one kv tile; warp w owns keys 16w..16w+15 of it and, per
// q tile, the 16 x 64 block s^T (keys x queries).
template <int D>
__device__ __forceinline__ void dkdv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int kt, int causal,
    bf16* smem) {
  constexpr int ld = D + 8;
  bf16* Ks = smem;              // [64][D + 8]
  bf16* Vs = Ks + kTile * ld;
  bf16* Qs = Vs + kTile * ld;
  bf16* dOs = Qs + kTile * ld;
  bf16* Qt = dOs + kTile * ld;  // [D][64 + 8]
  bf16* dOt = Qt + D * kLdT;
  float* lse_s = reinterpret_cast<float*>(dOt + D * kLdT);
  float* delta_s = lse_s + kTile;

  const int nt = S / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = warp * 16;
  mma_rows<D>(k + (size_t)kt * kTile * D, Ks);
  mma_rows<D>(v + (size_t)kt * kTile * D, Vs);
  float dk_acc[D / 8][4] = {};
  float dv_acc[D / 8][4] = {};
  for (int qt = causal ? kt : 0; qt < nt; ++qt) {
    __syncthreads();
    const size_t off = (size_t)qt * kTile * D;
    mma_rows<D>(q + off, Qs);
    mma_rows<D>(dout + off, dOs);
    mma_cols<D>(q + off, Qt);
    mma_cols<D>(dout + off, dOt);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse[qt * kTile + threadIdx.x];
      delta_s[threadIdx.x] = delta[qt * kTile + threadIdx.x];
    }
    __syncthreads();
    float st[8][4] = {}, dpt[8][4] = {};
    mma_abt<D>(st, Ks, Qs, r0, g, qd);    // s^T: keys x queries
    mma_abt<D>(dpt, Vs, dOs, r0, g, qd);  // dp^T
    const bool diag = causal && qt == kt;
    uint32_t p[4][4], ds[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float pv[4], dv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = r0 + g + (i >> 1) * 8, row = n * 8 + 2 * qd + (i & 1);
        pv[i] = expf(cap(st[n][i]) - lse_s[row]);
        if (diag && key > row) pv[i] = 0.f;
        dv4[i] = pv[i] * (dpt[n][i] - delta_s[row]);
      }
      to_frag(p, n, pv[0], pv[1], pv[2], pv[3]);
      to_frag(ds, n, dv4[0], dv4[1], dv4[2], dv4[3]);
    }
    mma_pm<D>(dv_acc, p, dOt, g, qd);
    mma_pm<D>(dk_acc, ds, Qt, g, qd);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)(kt * kTile + r0 + g + h * 8) * D + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(dk + row + dn * 8) =
          pack2(dk_acc[dn][2 * h], dk_acc[dn][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + row + dn * 8) =
          pack2(dv_acc[dn][2 * h], dv_acc[dn][2 * h + 1]);
    }
  }
}

// dq of one q tile; warp w owns queries 16w..16w+15 of it.
template <int D>
__device__ __forceinline__ void dq_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, int qt, int causal, bf16* smem) {
  constexpr int ld = D + 8;
  bf16* Qs = smem;              // [64][D + 8]
  bf16* dOs = Qs + kTile * ld;
  bf16* Ks = dOs + kTile * ld;
  bf16* Vs = Ks + kTile * ld;
  bf16* Kt = Vs + kTile * ld;   // [D][64 + 8]
  float* lse_s = reinterpret_cast<float*>(Kt + D * kLdT);
  float* delta_s = lse_s + kTile;

  const int nt = S / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = warp * 16;
  const size_t qoff = (size_t)qt * kTile * D;
  mma_rows<D>(q + qoff, Qs);
  mma_rows<D>(dout + qoff, dOs);
  if (threadIdx.x < kTile) {
    lse_s[threadIdx.x] = lse[qt * kTile + threadIdx.x];
    delta_s[threadIdx.x] = delta[qt * kTile + threadIdx.x];
  }
  float acc[D / 8][4] = {};
  const int n_kv = causal ? qt + 1 : nt;
  for (int kt = 0; kt < n_kv; ++kt) {
    __syncthreads();
    const size_t off = (size_t)kt * kTile * D;
    mma_rows<D>(k + off, Ks);
    mma_rows<D>(v + off, Vs);
    mma_cols<D>(k + off, Kt);
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};
    mma_abt<D>(s, Qs, Ks, r0, g, qd);
    mma_abt<D>(dp, dOs, Vs, r0, g, qd);
    const bool diag = causal && kt == qt;
    uint32_t ds[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + (i >> 1) * 8, key = n * 8 + 2 * qd + (i & 1);
        float p = expf(cap(s[n][i]) - lse_s[row]);
        if (diag && key > row) p = 0.f;
        d4[i] = p * (dp[n][i] - delta_s[row]);
      }
      to_frag(ds, n, d4[0], d4[1], d4[2], d4[3]);
    }
    mma_pm<D>(acc, ds, Kt, g, qd);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* row = dq + (size_t)(qt * kTile + r0 + g + h * 8) * D + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(row + dn * 8) =
          pack2(acc[dn][2 * h], acc[dn][2 * h + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
whole_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int BH, int S, int causal) {
  extern __shared__ float4 smem_f4[];
  bf16* smem = reinterpret_cast<bf16*>(smem_f4);
  const int nt = S / kTile;
  const int rank = blockIdx.x / (2 * BH);
  const int rem = blockIdx.x % (2 * BH);
  const int bh = rem >> 1;
  const size_t slab = (size_t)bh * S * D;
  const size_t rows = (size_t)bh * S;
  if (rem & 1)
    dq_mma<D>(q + slab, k + slab, v + slab, dout + slab, lse + rows,
              delta + rows, dq + slab, S, nt - 1 - rank, causal, smem);
  else
    dkdv_mma<D>(q + slab, k + slab, v + slab, dout + slab, lse + rows,
                delta + rows, dk + slab, dv + slab, S, rank, causal, smem);
}

template <int D>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o,
                   void* lse, int BH, int S, int causal,
                   cudaStream_t stream) {
  const size_t smem = fwd_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)whole_fwd_mma<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  whole_fwd_mma<D><<<BH * (S / kTile), kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), BH, S, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_mma(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int BH, int S, int causal,
                   cudaStream_t stream) {
  const size_t smem = bwd_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)whole_bwd_mma<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  whole_bwd_mma<D><<<2 * BH * (S / kTile), kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      BH, S, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int BH, int S, int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)whole_fwd_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  whole_fwd_kernel<D><<<BH * (S / kTile), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
      BH, S, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int BH, int S, int causal, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)whole_bwd_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  whole_bwd_kernel<D><<<2 * BH * (S / kTile), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), BH, S,
      causal);
  return static_cast<int>(cudaGetLastError());
}

#define RTT_HEAD_DIMS(X) X(16) X(32) X(64) X(128)

int fwd_for(int bf16_in, int D, const void* q, const void* k, const void* v,
            void* o, void* lse, int BH, int S, int causal, cudaStream_t s) {
#define RTT_CASE(d)                                                       \
  if (D == d)                                                             \
    return bf16_in ? launch_fwd_mma<d>(q, k, v, o, lse, BH, S, causal, s) \
                   : launch_fwd<d>(q, k, v, o, lse, BH, S, causal, s);
  RTT_HEAD_DIMS(RTT_CASE)
#undef RTT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int bwd_for(int bf16_in, int D, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* delta, void* dq,
            void* dk, void* dv, int BH, int S, int causal, cudaStream_t s) {
#define RTT_CASE(d)                                                          \
  if (D == d)                                                                \
    return bf16_in ? launch_bwd_mma<d>(q, k, v, dout, lse, delta, dq, dk, dv, \
                                       BH, S, causal, s)                     \
                   : launch_bwd<d>(q, k, v, dout, lse, delta, dq, dk,  \
                                          dv, BH, S, causal, s);
  RTT_HEAD_DIMS(RTT_CASE)
#undef RTT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Tensors are contiguous [BH, S, D] (lse, delta: [BH, S] f32); dtype:
// 0 = float32, 1 = bfloat16; S a multiple of 64; D in {16, 32, 64,
// 128}. Returns the cudaError_t of the launch (0 on success); the
// caller checked shapes, types and alignment.
int rtt_whole_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int dtype, int BH, int S,
                            int D, int causal, void* stream) {
  return fwd_for(dtype == 1, D, q, k, v, o, lse, BH, S, causal,
                 static_cast<cudaStream_t>(stream));
}

int rtt_whole_attention_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, void* dk, void* dv,
                            int dtype, int BH, int S, int D, int causal,
                            void* stream) {
  return bwd_for(dtype == 1, D, q, k, v, dout, lse, delta, dq, dk, dv, BH, S,
                 causal, static_cast<cudaStream_t>(stream));
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
