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
//           (delta = rowsum(o * do) is an input: attention_delta.cu)
//
// No running max: softmax is shift-invariant, so the static shift with
// the cap at 50 replaces the max/rescale passes. That makes the tiles
// of a row independent -- l and acc just add -- which is what lets a
// GPU split the work freely.
//
// Bound on this card at GPT-2 training's shape (b16 h12 s1024 d64,
// bf16, causal): the forward moves ~101 MB for ~26 GFLOP and is bound
// by HBM bytes (~0.030 ms); the backward's function does 5 products
// (~64 GFLOP) on ~178 MB and is bound by tensor-core operations
// (~0.065 ms).
//
// Design. The TPU grid gives one program a whole [bq = s, s] score
// block in VMEM and walks q blocks in order, carrying dk/dv in VMEM.
// A GPU runs CTAs at once and has 227 KB of shared memory, so:
//   * a CTA owns a tile of q rows (forward, dq) or of keys (dk, dv)
//     and walks the tiles of the other side through shared memory;
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
//
// The forward in bf16 at d = 64 and 128 (the training path;
// whole_fwd_wgmma) runs attention_wgmma.cuh's forward body, the
// streaming forward's, with the cap in place of the running max: 128
// q rows per item (two consumer warpgroups), kv tiles of 128 keys
// through a 2-stage TMA ring, s and p . V as wgmma (V read MN-major),
// e = exp(min(s, 50) - 25) packed to bf16 in the same pass that sums
// l, no max and no rescale of acc. The grid is persistent: one CTA
// per SM walks the (q tile, head) items, longest first, and loads the
// next item's Q and K, V while this one's rows are stored. At GPT-2's
// shape a causal item has 1-8 kv tiles, so a CTA's start and end were
// a large share of its life: a CTA per item was slower on the card, and
// so were issuing tile i+1's s before tile i's p . V (which the missing
// rescale allows) and writing e back into s before a separate pack
// pass.
//
// The backward in bf16 at d = 64 and 128 (the training path;
// whole_bwd_wgmma) runs attention_wgmma.cuh's bodies, the streaming
// backward's (flash_attention.cu), with the cap: 128-key and 128-row
// CTAs of two consumer warpgroups and a TMA producer warpgroup, the
// other side's 64-row tiles streaming through a 2-stage mbarrier ring,
// every product a wgmma with Q, dO or K read MN-major (no transposed
// copy). Both kinds of CTA compute s and dp, so the launch does 7
// products where the function needs 5. Shared memory per CTA is the
// larger of the two kinds' layouts.
//
// Elsewhere 64-row tiles: the forward and the backward at d = 16, 32
// in bf16 on the tensor cores with mma.sync m16n8k16 (below; loads
// through registers, no overlap: later work), f32 on the CUDA cores
// with fma, 16 x 16 threads each owning a 4 x 4 piece of the score
// tile.
//
// Plain C interface, loaded with ctypes by ray_tpu_torch/kernels.

#include "attention_wgmma.cuh"

namespace {

using namespace rtt;

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
// The forward, and the backward at d = 16, 32, for bf16 inputs on the
// tensor cores with mma.sync m16n8k16 (layouts in attention_tiles.cuh):
// the operands a product needs k-major (v for p.v, q and do for dk/dv,
// k for dq) are stored transposed, and e, p and ds go from f32
// registers to bf16 registers (rounded to nearest even, as the
// reference rounds) without passing through shared memory.

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

// bf16 at d = 64, 128: one launch, 2 * BH * cdiv(S, 128) CTAs of three
// warpgroups running attention_wgmma.cuh's bodies with the cap: even
// ones sum dk, dv of a 128-key tile over the q tiles at or below the
// diagonal (dkv_wgmma), odd ones dq of a 128-row tile over the kv tiles
// (dq_wgmma). Rank r = blockIdx / (2 BH) orders them by work: kv tile r
// and q tile nt-1-r each walk S/64 - 2r tiles of 64 when causal. Each
// kind gets its own tensor maps (the other side's tiles stream in
// 64-row boxes, its own arrive in 128-row ones).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
whole_bwd_wgmma(const __grid_constant__ BwdMaps kv_maps,
                const __grid_constant__ BwdMaps q_maps, bf16* __restrict__ dq,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int S,
                int causal) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = align_1k(smem_raw);
  const int rank = blockIdx.x / (2 * BH);
  const int rem = blockIdx.x % (2 * BH);
  const int bh = rem >> 1;
  if (rem & 1)
    dq_wgmma<D, true>(sm, &q_maps.q, &q_maps.k, &q_maps.v, &q_maps.dout,
                      &q_maps.lse, &q_maps.delta, dq,
                      cdiv(S, 2 * kTile) - 1 - rank, bh, S, S, causal);
  else
    dkv_wgmma<D, true>(sm, &kv_maps.q, &kv_maps.k, &kv_maps.v, &kv_maps.dout,
                       &kv_maps.lse, &kv_maps.delta, dk, dv, rank, bh, S, S,
                       causal);
}

template <int D>
constexpr size_t bwd_wgmma_smem_bytes() {
  return DkvSmem<D>::kBytes > DqSmem<D>::kBytes ? DkvSmem<D>::kBytes
                                                : DqSmem<D>::kBytes;
}

// bf16 at d = 64, 128: attention_wgmma.cuh's forward body with the
// cap, on a persistent grid: one CTA per SM walks the (q tile, head)
// items, longest first across heads, dealt out in a snake (CTA c takes
// item c of even rounds and gridDim - 1 - c of odd ones) so that the
// CTAs' shares of tiles even out; the next item's Q and K, V load
// while this one's rows are stored.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
whole_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                bf16* __restrict__ o, float* __restrict__ lse, int BH, int S,
                int causal) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int nqt = cdiv(S, 2 * kTile), n_items = nqt * BH;
  auto item = [&](int j, int& qt, int& bh) {
    const int c = blockIdx.x, n = gridDim.x;
    const int w = j * n + ((j & 1) ? n - 1 - c : c);
    qt = nqt - 1 - w / BH;
    bh = w % BH;
    return w < n_items;
  };
  fwd_wgmma<D, true>(align_1k(smem_raw), &tm_q, &tm_k, &tm_v, o, lse, item,
                     S, S, causal);
}

// bf16 at d = 64, 128: the TMA + wgmma body (128-row items, one CTA
// per SM); d = 16, 32: the mma.sync body (64-row CTAs). f32: CUDA
// cores.
template <int D>
int launch_fwd(int bf16_in, const void* q, const void* k, const void* v,
               void* o, void* lse, int BH, int S, int causal,
               cudaStream_t stream) {
  const int grid = BH * (S / kTile);
  if (bf16_in) {
    if constexpr (D >= 64) {
      CUtensorMap tq, tk, tv;
      if (encode_tiled() == nullptr ||
          !tile_map(&tq, q, BH, S, D, 2 * kTile) ||
          !tile_map(&tk, k, BH, S, D, kFwdKeys) ||
          !tile_map(&tv, v, BH, S, D, kFwdKeys))
        return static_cast<int>(cudaErrorInvalidValue);
      int dev = 0, n_sm = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 dev) != cudaSuccess)
        return static_cast<int>(cudaGetLastError());
      const int n_items = BH * cdiv(S, 2 * kTile);
      return launch(whole_fwd_wgmma<D>, n_items < n_sm ? n_items : n_sm,
                    kWgThreads, WholeFwdSmem<D>::kBytes, stream, tq, tk, tv,
                    static_cast<bf16*>(o), static_cast<float*>(lse), BH, S,
                    causal);
    } else {
      return launch(whole_fwd_mma<D>, grid, kMmaThreads,
                    fwd_mma_smem_bytes<D>(), stream,
                    static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o),
                    static_cast<float*>(lse), BH, S, causal);
    }
  }
  return launch(whole_fwd_kernel<D>, grid, kThreads,
                fwd_smem_floats<D>() * sizeof(float), stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o),
                static_cast<float*>(lse), BH, S, causal);
}

// bf16 at d = 64, 128: the TMA + wgmma bodies (128-row CTAs); d = 16,
// 32: the mma.sync bodies (64-row CTAs). f32: CUDA cores.
template <int D>
int launch_bwd(int bf16_in, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta, void* dq,
               void* dk, void* dv, int BH, int S, int causal,
               cudaStream_t stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (bf16_in) {
    if constexpr (D >= 64) {
      BwdMaps kv_maps, q_maps;
      if (!bwd_maps<D>(&kv_maps, q, k, v, dout, lse, delta, BH, S, S, kTile,
                       2 * kTile) ||
          !bwd_maps<D>(&q_maps, q, k, v, dout, lse, delta, BH, S, S,
                       2 * kTile, kTile))
        return static_cast<int>(cudaErrorInvalidValue);
      return launch(whole_bwd_wgmma<D>, 2 * BH * cdiv(S, 2 * kTile),
                    kWgThreads, bwd_wgmma_smem_bytes<D>(), stream, kv_maps,
                    q_maps, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                    static_cast<bf16*>(dv), BH, S, causal);
    } else {
      return launch(whole_bwd_mma<D>, 2 * BH * (S / kTile), kMmaThreads,
                    bwd_mma_smem_bytes<D>(), stream,
                    static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v),
                    static_cast<const bf16*>(dout), l, dl,
                    static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                    static_cast<bf16*>(dv), BH, S, causal);
    }
  }
  return launch(whole_bwd_kernel<D>, 2 * BH * (S / kTile), kThreads,
                bwd_smem_floats<D>() * sizeof(float), stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout),
                l, dl, static_cast<float*>(dq), static_cast<float*>(dk),
                static_cast<float*>(dv), BH, S, causal);
}

// Dynamic shared memory per CTA that a launch of `pass` (0 forward,
// 1 backward) sets.
template <int D>
size_t smem_bytes(int pass, int bf16_in) {
  if (!bf16_in)
    return (pass == 0 ? fwd_smem_floats<D>() : bwd_smem_floats<D>()) *
           sizeof(float);
  if constexpr (D >= 64)
    return pass == 0 ? WholeFwdSmem<D>::kBytes : bwd_wgmma_smem_bytes<D>();
  else
    return pass == 0 ? fwd_mma_smem_bytes<D>() : bwd_mma_smem_bytes<D>();
}

#define RTT_HEAD_DIMS(X) X(16) X(32) X(64) X(128)

}  // namespace

extern "C" {

// Tensors are contiguous [BH, S, D] (lse, delta: [BH, S] f32); dtype:
// 0 = float32, 1 = bfloat16; S a multiple of 64; D in {16, 32, 64,
// 128}. Returns the cudaError_t of the launch (0 on success); the
// caller checked shapes, types and alignment.
int rtt_whole_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int dtype, int BH, int S,
                            int D, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_CASE(d)                                                     \
  if (D == d)                                                           \
    return launch_fwd<d>(dtype == 1, q, k, v, o, lse, BH, S, causal, s);
  RTT_HEAD_DIMS(RTT_CASE)
#undef RTT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int rtt_whole_attention_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, void* dk, void* dv,
                            int dtype, int BH, int S, int D, int causal,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_CASE(d)                                                       \
  if (D == d)                                                             \
    return launch_bwd<d>(dtype == 1, q, k, v, dout, lse, delta, dq, dk, dv, \
                         BH, S, causal, s);
  RTT_HEAD_DIMS(RTT_CASE)
#undef RTT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory per CTA of a launch (pass 0 forward,
// 1 backward; dtype as above); -1 for a head dim the kernels do not
// take.
long long rtt_whole_attention_smem_bytes(int pass, int dtype, int D) {
#define RTT_CASE(d) \
  if (D == d) return static_cast<long long>(smem_bytes<d>(pass, dtype == 1));
  RTT_HEAD_DIMS(RTT_CASE)
#undef RTT_CASE
  return -1;
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
