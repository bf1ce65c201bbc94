// Streaming (flash-v2) attention, forward and backward, for Hopper
// (sm_90a): the exact-softmax path that long sequences, sq != sk and
// exact=True take.
//
// Replaces the TPU kernels of ray_tpu/ops/attention.py:
//   _fwd_kernel      (launched by _flash_forward)   -> flash_fwd_*
//   _bwd_dkv_kernel  (launched by _flash_backward)  -> flash_dkv_*
//   _bwd_dq_kernel   (launched by _flash_backward)  -> flash_dq_*
// and computes the same functions on q pre-scaled by sm_scale (the
// wrapper folds the scale into q, as the JAX one does):
//
// forward   s     = q . k^T, f32 accumulation; -1e30 where masked
//           per kv tile: m' = max(m, rowmax s); p = exp(s - m');
//           l = l exp(m - m') + sum p (p unrounded);
//           acc = acc exp(m - m') + (p rounded to the input dtype) . v
//           o = acc / max(l, 1e-30), rounded;  lse = m + log max(l, 1e-30)
// dkv       p  = exp(s - lse) (0 where masked); dp = do . v^T
//           dv = sum_q (p rounded)^T . do;  ds = p (dp - delta), rounded
//           dk = sum_q ds^T . q
// dq        dq = sum_k ds . k
// (delta = rowsum(o * do) comes from the wrapper, as in JAX.) There is
// no logit cap on this path: logits past 50 are exact.
//
// Masking. A query row r attends to key c iff c < sk and, when causal,
// c <= r: the Pallas kernels align the causal mask top-left (no sk - sq
// offset), and so does this file. m starts at -1e30, never -inf: the
// first tile's alpha = exp(-1e30 - m') is exactly 0, where -inf would
// give exp(-inf + inf) = NaN. Key 0 is visible to every row, so m is
// finite after the first tile and a wholly masked later tile adds
// exactly 0.
//
// Bound on this card at Llama-2-7B training's shape (b2 h32 s4096 d128,
// bf16, causal): every kernel is bound by tensor-core operations. The
// forward does 2 products over the 2^29 causal pairs (~275 GFLOP,
// ~0.28 ms at 989 TFLOP/s) on ~270 MB (~0.08 ms of HBM); the dkv pass
// 4 (s, dp, dv, dk: ~0.56 ms), the dq pass 3 (s, dp, dq: ~0.42 ms).
//
// Design. The TPU grid gives a program a 512-row q (or kv) block and
// the whole other side in VMEM, walking 512-wide blocks of it in a
// loop. Here a CTA owns one tile and walks tiles of the other side
// through shared memory:
//   * forward: a CTA per (b*h, 64-row q tile); the running max and sum
//     of its rows stay in registers; kv tiles past the diagonal are not
//     visited; only the diagonal tile and a ragged last tile are
//     masked;
//   * dkv: a CTA per (b*h, kv tile) loops over the q tiles from the
//     diagonal to the end and sums dk, dv in registers (f32, rounded
//     once); dq: a CTA per (b*h, q tile) loops over the kv tiles up to
//     the diagonal. Two launches, as on the TPU: no atomics, and the
//     result does not depend on the order the CTAs run in;
//   * CTAs with the most tiles are launched first.
// Ragged sequences (a multiple of 16, not of the tile) read zeros past
// the slab and mask those rows and keys. f32 runs on the CUDA cores, so
// the f32 checks hold the tiling and masking to f32 rounding.
//
// bf16 backward at d = 64 and 128 (flash_dkv_wgmma, flash_dq_wgmma):
// built for Hopper (hopper.cuh). A CTA has a producer warpgroup, whose
// one thread issues TMA loads, and two consumer warpgroups of 64 rows
// each, so dkv takes 128 keys and dq 128 query rows per CTA (half the
// reloads of the other side that 64-row tiles cost). The CTA's own
// tiles (K, V or Q, dO, lse, delta) arrive once; the other side's
// 64-row tiles stream through a 2-stage ring behind mbarriers, so the
// next tile loads while the tensor cores work on this one. Every
// product is a wgmma (m64n64k16 for s and dp from shared memory,
// m64nDk16 for dv, dk, dq with p or ds as register fragments), and the
// operands that a product needs transposed (dO, Q for dv, dk; K for dq)
// are read MN-major through the descriptor's transpose bit, so no tile
// is stored twice. TMA writes 128B-swizzled tiles, which the
// descriptors read in the same mode. The consumers take 240 registers
// (setmaxnreg), the producer 24: dk and dv at d = 128 are 128 f32 per
// thread beside 64 of scores, with no spill. One CTA per SM (133 KB of
// shared memory at d = 128). Rounding points, masks and the -1e30 fill
// are those of the functions above.
//
// bf16 elsewhere (the forward; the backward at d = 16, 32, whose rows
// are narrower than a 128-byte swizzled block): mma.sync m16n8k16
// with 64-row CTAs of 4 warps (attention_tiles.cuh), loads through
// registers with no overlap: later work.
//
// Plain C interface, loaded with ctypes by ray_tpu_torch/kernels.

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace rtt;

constexpr float kNegInf = -1e30f;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Whether query row `row` attends to key `key` (absolute positions).
__device__ __forceinline__ bool keep(int row, int key, int Sq, int Sk,
                                     int causal) {
  return row < Sq && key < Sk && (!causal || key <= row);
}

// ------------------------------------------------------ f32 path: forward

template <int D>
constexpr size_t fwd_smem_bytes() {
  return (3 * D * kTile + kTile * kTile) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int BH, int Sq, int Sk,
                 int causal) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem_f4[];
  float* Qt = reinterpret_cast<float*>(smem_f4);  // [D][64]
  float* Kt = Qt + D * kTile;                     // [D][64]
  float* Vs = Kt + D * kTile;                     // [64][D]
  float* Et = Vs + kTile * D;                     // [64 keys][64 rows]

  const int nqt = cdiv(Sq, kTile), nkt = cdiv(Sk, kTile);
  const int qt = nqt - 1 - (int)(blockIdx.x / BH);  // longest rows first
  const int bh = blockIdx.x % BH;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;

  tile_cols<D>(q + ((size_t)bh * Sq + (size_t)qt * kTile) * D, Qt,
               min(kTile, Sq - qt * kTile));
  float acc[4][C] = {};
  float m[4], l[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf;
  const int n_kv = causal ? min(qt + 1, nkt) : nkt;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int nk = min(kTile, Sk - kt * kTile);
    __syncthreads();  // the previous tile's readers are done
    tile_cols<D>(kb + (size_t)kt * kTile * D, Kt, nk);
    tile_rows<D>(vb + (size_t)kt * kTile * D, Vs, nk);
    __syncthreads();
    float s[4][4] = {};
    mul_tn<D>(s, Qt, Kt, ty * 4, tx * 4);
    if ((causal && kt == qt) || nk < kTile) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = qt * kTile + ty * 4 + i;
          const int key = kt * kTile + tx * 4 + j;
          // rows past Sq are never stored: mask by key alone there
          if (key >= Sk || (causal && key > row)) s[i][j] = kNegInf;
        }
    }
    // a row's 64 columns are spread over the 16 lanes of a half-warp
    float alpha[4], part[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mx = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - mx);
      m[i] = mx;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float e4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e4[i] = expf(s[i][j] - m[i]);
        part[i] += e4[i];
      }
      *reinterpret_cast<float4*>(Et + (tx * 4 + j) * kTile + ty * 4) =
          make_float4(e4[0], e4[1], e4[2], e4[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = l[i] * alpha[i] + part[i];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha[i];
    }
    __syncthreads();
    mul_pn<D>(acc, Et, Vs, ty * 4, tx * C);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * kTile + ty * 4 + i;
    if (row >= Sq) continue;
    const float li = l[i] < 1e-30f ? 1e-30f : l[i];  // NaN stays NaN
    float* orow = o + ((size_t)bh * Sq + row) * D + tx * C;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[c] = acc[i][c] / li;
    if (tx == 0) lse[(size_t)bh * Sq + row] = m[i] + logf(li);
  }
}

// ----------------------------------------------------- f32 path: backward

template <int D>
constexpr size_t dkv_smem_bytes() {
  // Kt, Vt, Qt|Pt, dOt|dSt, Qs, dOs, lse, delta
  constexpr size_t R = (D > kTile ? D : kTile) * kTile;
  return (4 * D * kTile + 2 * R + 2 * kTile) * sizeof(float);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Qt, dOt, Kt, Vt, Ks, dSt, lse, delta
  return (5 * D * kTile + kTile * kTile + 2 * kTile) * sizeof(float);
}

// Per-row lse and delta of a q tile into shared memory (0 past Sq: the
// rows there are masked).
__device__ __forceinline__ void load_rows(const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int nq, float* lse_s,
                                          float* delta_s) {
  if (threadIdx.x < kTile) {
    const bool in = (int)threadIdx.x < nq;
    lse_s[threadIdx.x] = in ? lse[threadIdx.x] : 0.f;
    delta_s[threadIdx.x] = in ? delta[threadIdx.x] : 0.f;
  }
}

// dk, dv of one kv tile: loop over the q tiles from the diagonal down.
// The thread's 4 x 4 score piece is keys ty*4.. by queries tx*4...
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int BH, int Sq, int Sk,
                 int causal) {
  constexpr int C = D / 16;
  constexpr int R = (D > kTile ? D : kTile) * kTile;
  extern __shared__ float4 smem_f4[];
  float* Kt = reinterpret_cast<float*>(smem_f4);  // [D][64]
  float* Vt = Kt + D * kTile;    // [D][64]
  float* Qt = Vt + D * kTile;    // [D][64]; then Pt [64 q][64 keys]
  float* dOt = Qt + R;           // [D][64]; then dSt [64 q][64 keys]
  float* Qs = dOt + R;           // [64][D]
  float* dOs = Qs + kTile * D;   // [64][D]
  float* lse_s = dOs + kTile * D;
  float* delta_s = lse_s + kTile;
  float* Pt = Qt;
  float* dSt = dOt;

  const int nqt = cdiv(Sq, kTile);
  const int kt = blockIdx.x / BH;  // the first kv tiles have the most work
  const int bh = blockIdx.x % BH;
  const int nk = min(kTile, Sk - kt * kTile);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qb = q + (size_t)bh * Sq * D;
  const float* dob = dout + (size_t)bh * Sq * D;
  const size_t koff = ((size_t)bh * Sk + (size_t)kt * kTile) * D;

  tile_cols<D>(k + koff, Kt, nk);
  tile_cols<D>(v + koff, Vt, nk);
  float dk_acc[4][C] = {};
  float dv_acc[4][C] = {};
  for (int qt = causal ? kt : 0; qt < nqt; ++qt) {
    const int nq = min(kTile, Sq - qt * kTile);
    __syncthreads();
    const size_t off = (size_t)qt * kTile * D;
    tile_cols<D>(qb + off, Qt, nq);
    tile_cols<D>(dob + off, dOt, nq);
    tile_rows<D>(qb + off, Qs, nq);
    tile_rows<D>(dob + off, dOs, nq);
    const size_t roff = (size_t)bh * Sq + (size_t)qt * kTile;
    load_rows(lse + roff, delta + roff, nq, lse_s, delta_s);
    __syncthreads();
    float st[4][4] = {}, dpt[4][4] = {};
    mul_tn<D>(st, Kt, Qt, ty * 4, tx * 4);    // s^T: keys x queries
    mul_tn<D>(dpt, Vt, dOt, ty * 4, tx * 4);  // dp^T
    __syncthreads();  // Qt and dOt are read: Pt and dSt take their place
    const bool edge = (causal && qt == kt) || nq < kTile || nk < kTile;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx * 4 + j;  // query row within the tile
      float p4[4], s4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = expf(st[i][j] - lse_s[r]);
        if (edge && !keep(qt * kTile + r, kt * kTile + ty * 4 + i, Sq, Sk,
                          causal))
          p = 0.f;
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
    if (ty * 4 + i >= nk) continue;
    const size_t row = koff + (size_t)(ty * 4 + i) * D + tx * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[row + c] = dk_acc[i][c];
      dv[row + c] = dv_acc[i][c];
    }
  }
}

// dq of one q tile: loop over the kv tiles up to the diagonal. The
// thread's 4 x 4 score piece is queries ty*4.. by keys tx*4...
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int BH, int Sq, int Sk, int causal) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem_f4[];
  float* Qt = reinterpret_cast<float*>(smem_f4);  // [D][64]
  float* dOt = Qt + D * kTile;   // [D][64]
  float* Kt = dOt + D * kTile;   // [D][64]
  float* Vt = Kt + D * kTile;    // [D][64]
  float* Ks = Vt + D * kTile;    // [64][D]
  float* dSt = Ks + kTile * D;   // [64 keys][64 rows]
  float* lse_s = dSt + kTile * kTile;
  float* delta_s = lse_s + kTile;

  const int nqt = cdiv(Sq, kTile), nkt = cdiv(Sk, kTile);
  const int qt = nqt - 1 - (int)(blockIdx.x / BH);  // longest rows first
  const int bh = blockIdx.x % BH;
  const int nq = min(kTile, Sq - qt * kTile);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qoff = ((size_t)bh * Sq + (size_t)qt * kTile) * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;

  tile_cols<D>(q + qoff, Qt, nq);
  tile_cols<D>(dout + qoff, dOt, nq);
  const size_t roff = (size_t)bh * Sq + (size_t)qt * kTile;
  load_rows(lse + roff, delta + roff, nq, lse_s, delta_s);
  float acc[4][C] = {};
  const int n_kv = causal ? min(qt + 1, nkt) : nkt;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int nk = min(kTile, Sk - kt * kTile);
    __syncthreads();
    const size_t off = (size_t)kt * kTile * D;
    tile_cols<D>(kb + off, Kt, nk);
    tile_cols<D>(vb + off, Vt, nk);
    tile_rows<D>(kb + off, Ks, nk);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mul_tn<D>(s, Qt, Kt, ty * 4, tx * 4);
    mul_tn<D>(dp, dOt, Vt, ty * 4, tx * 4);
    const bool edge = (causal && kt == qt) || nq < kTile || nk < kTile;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        float p = expf(s[i][j] - lse_s[r]);
        if (edge && !keep(qt * kTile + r, kt * kTile + tx * 4 + j, Sq, Sk,
                          causal))
          p = 0.f;
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
    if (ty * 4 + i >= nq) continue;
    float* row = dq + qoff + (size_t)(ty * 4 + i) * D + tx * C;
#pragma unroll
    for (int c = 0; c < C; ++c) row[c] = acc[i][c];
  }
}

// ------------------------------------------------ tensor-core path (bf16)

template <int D>
constexpr size_t fwd_mma_smem_bytes() {
  return (2 * kTile * (D + 8) + D * kLdT) * sizeof(bf16);
}

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K, V, Q, dO row-major; Q, dO transposed; lse, delta
  return (4 * kTile * (D + 8) + 2 * D * kLdT) * sizeof(bf16) +
         2 * kTile * sizeof(float);
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // Q, dO, K, V row-major; K transposed; lse, delta
  return (4 * kTile * (D + 8) + D * kLdT) * sizeof(bf16) +
         2 * kTile * sizeof(float);
}

// The row and key (within the warp's 16 x 64 block) of element i of
// score fragment n: rows g, g + 8; columns n*8 + 2q, +1.
__device__ __forceinline__ int frag_row(int r0, int g, int i) {
  return r0 + g + (i >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int n, int qd, int i) {
  return n * 8 + 2 * qd + (i & 1);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int BH, int Sq, int Sk, int causal) {
  constexpr int ld = D + 8;
  extern __shared__ float4 smem_f4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_f4);  // [64][D + 8]
  bf16* Ks = Qs + kTile * ld;                   // [64][D + 8]
  bf16* Vt = Ks + kTile * ld;                   // [D][64 + 8]

  const int nqt = cdiv(Sq, kTile), nkt = cdiv(Sk, kTile);
  const int qt = nqt - 1 - (int)(blockIdx.x / BH);  // longest rows first
  const int bh = blockIdx.x % BH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = warp * 16;  // the warp's first row in the tile
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;

  mma_rows<D>(q + ((size_t)bh * Sq + (size_t)qt * kTile) * D, Qs,
              min(kTile, Sq - qt * kTile));
  float acc[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {};
  const int n_kv = causal ? min(qt + 1, nkt) : nkt;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int nk = min(kTile, Sk - kt * kTile);
    __syncthreads();
    mma_rows<D>(kb + (size_t)kt * kTile * D, Ks, nk);
    mma_cols<D>(vb + (size_t)kt * kTile * D, Vt, nk);
    __syncthreads();
    float s[8][4] = {};
    mma_abt<D>(s, Qs, Ks, r0, g, qd);
    if ((causal && kt == qt) || nk < kTile) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kt * kTile + frag_col(n, qd, i);
          const int row = qt * kTile + frag_row(r0, g, i);
          // rows past Sq are never stored: mask by key alone there
          if (key >= Sk || (causal && key > row)) s[n][i] = kNegInf;
        }
    }
    // a row's columns are spread over the 4 lanes of a quad
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[h] = expf(m[h] - mx);
      m[h] = mx;
    }
    uint32_t p[4][4];
    float part[2] = {};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = expf(s[n][i] - m[i >> 1]);
      part[0] += e[0] + e[1];
      part[1] += e[2] + e[3];
      to_frag(p, n, e[0], e[1], e[2], e[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + part[h];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
    mma_pm<D>(acc, p, Vt, g, qd);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qt * kTile + r0 + g + h * 8;
    if (row >= Sq) continue;
    const float lh = l[h] < 1e-30f ? 1e-30f : l[h];  // NaN stays NaN
    bf16* orow = o + ((size_t)bh * Sq + row) * D + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8) =
          pack2(acc[dn][2 * h] / lh, acc[dn][2 * h + 1] / lh);
    if (qd == 0) lse[(size_t)bh * Sq + row] = m[h] + logf(lh);
  }
}

// The mma.sync backward serves d = 16 and 32 (dkv, dq below).
// dk, dv of one kv tile; warp w owns keys 16w..16w+15 of it and, per
// q tile, the 16 x 64 block s^T (keys x queries). p overwrites s in
// f32 (ds needs it unrounded); its bf16 fragments feed dv and are then
// reused for ds, which keeps the registers of the d = 128 instance down.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int Sq,
              int Sk, int causal) {
  constexpr int ld = D + 8;
  extern __shared__ float4 smem_f4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_f4);  // [64][D + 8]
  bf16* Vs = Ks + kTile * ld;
  bf16* Qs = Vs + kTile * ld;
  bf16* dOs = Qs + kTile * ld;
  bf16* Qt = dOs + kTile * ld;  // [D][64 + 8]
  bf16* dOt = Qt + D * kLdT;
  float* lse_s = reinterpret_cast<float*>(dOt + D * kLdT);
  float* delta_s = lse_s + kTile;

  const int nqt = cdiv(Sq, kTile);
  const int kt = blockIdx.x / BH;  // the first kv tiles have the most work
  const int bh = blockIdx.x % BH;
  const int nk = min(kTile, Sk - kt * kTile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = warp * 16;
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* dob = dout + (size_t)bh * Sq * D;
  const size_t koff = ((size_t)bh * Sk + (size_t)kt * kTile) * D;

  mma_rows<D>(k + koff, Ks, nk);
  mma_rows<D>(v + koff, Vs, nk);
  float dk_acc[D / 8][4] = {};
  float dv_acc[D / 8][4] = {};
  for (int qt = causal ? kt : 0; qt < nqt; ++qt) {
    const int nq = min(kTile, Sq - qt * kTile);
    __syncthreads();
    const size_t off = (size_t)qt * kTile * D;
    mma_rows<D>(qb + off, Qs, nq);
    mma_rows<D>(dob + off, dOs, nq);
    mma_cols<D>(qb + off, Qt, nq);
    mma_cols<D>(dob + off, dOt, nq);
    const size_t roff = (size_t)bh * Sq + (size_t)qt * kTile;
    load_rows(lse + roff, delta + roff, nq, lse_s, delta_s);
    __syncthreads();
    const bool edge = (causal && qt == kt) || nq < kTile || nk < kTile;
    float pt[8][4] = {};
    mma_abt<D>(pt, Ks, Qs, r0, g, qd);  // s^T: keys x queries
    uint32_t pf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = frag_row(r0, g, i), row = frag_col(n, qd, i);
        float p = expf(pt[n][i] - lse_s[row]);
        if (edge && !keep(qt * kTile + row, kt * kTile + key, Sq, Sk, causal))
          p = 0.f;
        pt[n][i] = p;
      }
      to_frag(pf, n, pt[n][0], pt[n][1], pt[n][2], pt[n][3]);
    }
    mma_pm<D>(dv_acc, pf, dOt, g, qd);
    float dpt[8][4] = {};
    mma_abt<D>(dpt, Vs, dOs, r0, g, qd);  // dp^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d4[i] = pt[n][i] * (dpt[n][i] - delta_s[frag_col(n, qd, i)]);
      to_frag(pf, n, d4[0], d4[1], d4[2], d4[3]);
    }
    mma_pm<D>(dk_acc, pf, Qt, g, qd);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = r0 + g + h * 8;
    if (key >= nk) continue;
    const size_t row = koff + (size_t)key * D + 2 * qd;
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
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int BH, int Sq, int Sk, int causal) {
  constexpr int ld = D + 8;
  extern __shared__ float4 smem_f4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_f4);  // [64][D + 8]
  bf16* dOs = Qs + kTile * ld;
  bf16* Ks = dOs + kTile * ld;
  bf16* Vs = Ks + kTile * ld;
  bf16* Kt = Vs + kTile * ld;   // [D][64 + 8]
  float* lse_s = reinterpret_cast<float*>(Kt + D * kLdT);
  float* delta_s = lse_s + kTile;

  const int nqt = cdiv(Sq, kTile), nkt = cdiv(Sk, kTile);
  const int qt = nqt - 1 - (int)(blockIdx.x / BH);  // longest rows first
  const int bh = blockIdx.x % BH;
  const int nq = min(kTile, Sq - qt * kTile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = warp * 16;
  const size_t qoff = ((size_t)bh * Sq + (size_t)qt * kTile) * D;
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;

  mma_rows<D>(q + qoff, Qs, nq);
  mma_rows<D>(dout + qoff, dOs, nq);
  const size_t roff = (size_t)bh * Sq + (size_t)qt * kTile;
  load_rows(lse + roff, delta + roff, nq, lse_s, delta_s);
  float acc[D / 8][4] = {};
  const int n_kv = causal ? min(qt + 1, nkt) : nkt;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int nk = min(kTile, Sk - kt * kTile);
    __syncthreads();
    const size_t off = (size_t)kt * kTile * D;
    mma_rows<D>(kb + off, Ks, nk);
    mma_rows<D>(vb + off, Vs, nk);
    mma_cols<D>(kb + off, Kt, nk);
    __syncthreads();
    const bool edge = (causal && kt == qt) || nq < kTile || nk < kTile;
    float p[8][4] = {};
    mma_abt<D>(p, Qs, Ks, r0, g, qd);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = frag_row(r0, g, i), key = frag_col(n, qd, i);
        p[n][i] = expf(p[n][i] - lse_s[row]);
        if (edge && !keep(qt * kTile + row, kt * kTile + key, Sq, Sk, causal))
          p[n][i] = 0.f;
      }
    float dp[8][4] = {};
    mma_abt<D>(dp, dOs, Vs, r0, g, qd);
    uint32_t ds[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d4[i] = p[n][i] * (dp[n][i] - delta_s[frag_row(r0, g, i)]);
      to_frag(ds, n, d4[0], d4[1], d4[2], d4[3]);
    }
    mma_pm<D>(acc, ds, Kt, g, qd);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + g + h * 8 >= nq) continue;
    bf16* row = dq + qoff + (size_t)(r0 + g + h * 8) * D + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(row + dn * 8) =
          pack2(acc[dn][2 * h], acc[dn][2 * h + 1]);
  }
}

// ------------------------------------ backward on Hopper: TMA + wgmma (bf16)

// The dkv and dq bodies for d = 64 and 128. A CTA is three warpgroups:
// two consumers (threads 0-255; warpgroup w owns 64 rows of the CTA's
// 128-row tile) and a producer (256-383) whose first thread issues
// every TMA load. Tiles sit in shared memory as TMA writes them
// (hopper.cuh: 128B swizzle, 64-column blocks). The CTA's own tile is
// loaded once; the other side's 64-row tiles stream through a ring of
// kStages stages, `full` barriers counting TMA bytes and `empty`
// barriers counting the 256 consumer threads that are done with a
// stage. One CTA per SM (kMinSmem): with two, each CTA's consumers
// could wait in setmaxnreg.inc for registers the other CTA holds.
constexpr int kStages = 2;
constexpr int kWgThreads = 3 * 128;
constexpr int kConsumers = 256;
constexpr int kRowBytes = 128;               // 64 bf16: one swizzled row
constexpr size_t kMinSmem = 116 * 1024;      // > half an SM's 228 KB

// Byte offsets of a CTA's shared memory: its own tiles, kOwnRows rows
// of two tensors (K, V or Q, dO); the ring, 64 rows of two tensors per
// stage; kRingF32 rows per stage of each of lse and delta (dkv) or
// kOwnF32 of the CTA's own (dq); then the barriers.
template <int D, int kOwnRows, int kRingF32, int kOwnF32>
struct BwdSmem {
  static constexpr int kC = D / 64;                   // column blocks
  static constexpr int kOwnBlock = kOwnRows * kRowBytes;
  static constexpr int kRingBlock = kTile * kRowBytes;
  static constexpr int kOwn0 = 0;                     // K | Q
  static constexpr int kOwn1 = kC * kOwnBlock;        // V | dO
  static constexpr int kRing0 = 2 * kC * kOwnBlock;   // Q | K, per stage
  static constexpr int kRing1 = kRing0 + kStages * kC * kRingBlock;
  static constexpr int kF32 = kRing1 + kStages * kC * kRingBlock;
  static constexpr int kRingLse = kF32;
  static constexpr int kRingDelta = kRingLse + kStages * kRingF32 * 4;
  static constexpr int kOwnLse = kRingDelta + kStages * kRingF32 * 4;
  static constexpr int kOwnDelta = kOwnLse + kOwnF32 * 4;
  static constexpr int kBars = kOwnDelta + kOwnF32 * 4;
  static constexpr int kUsed = kBars + (1 + 2 * kStages) * 8;
  // + 1 KB to align the base to the swizzle atom
  static constexpr size_t kBytes =
      (size_t)kUsed + 1024 > kMinSmem ? (size_t)kUsed + 1024 : kMinSmem;
  static_assert(kOwn1 % 1024 == 0 && kRing0 % 1024 == 0 &&
                    kRing1 % 1024 == 0 && kF32 % 128 == 0,
                "swizzled tiles start on 1024-byte boundaries");
};

template <int D>
using DkvSmem = BwdSmem<D, 2 * kTile, kTile, 0>;  // K, V; Q, dO ring
template <int D>
using DqSmem = BwdSmem<D, 2 * kTile, 0, 2 * kTile>;  // Q, dO; K, V ring

__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// One 64-row x D tile by TMA, one box per 64-column block.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, int block_bytes,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row, int bh) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_3d(dst + c * block_bytes, map, bar, c * 64, row, bh);
}

// s (64 x 64) = A . B^T over the head dim: A the warpgroup's 64 rows at
// shared address a (column blocks a_block bytes apart), B 64 rows at b.
template <int D>
__device__ __forceinline__ void mma_scores(float (&s)[32], uint32_t a,
                                           int a_block, uint32_t b,
                                           int b_block) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s,
                 desc_b128(a + (kk / 4) * a_block + (kk % 4) * 32, 16, 1024),
                 desc_b128(b + (kk / 4) * b_block + (kk % 4) * 32, 16, 1024),
                 kk > 0);
}

// acc (64 x D) += P . M: P's 64 columns as 4 A fragments in registers,
// M a 64-row x D tile at shared address m read MN-major (no transposed
// copy), its column blocks m_block bytes apart.
template <int D>
__device__ __forceinline__ void mma_pm_rs(float (&acc)[D / 2],
                                          const uint32_t (&p)[4][4],
                                          uint32_t m, int m_block) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_mn<D>(acc, p[kk], desc_b128(m + kk * 16 * kRowBytes, m_block,
                                         1024), 1);
}

// Stores a 64 x D f32 accumulator as bf16 rows 0..n-1 of `out` (row
// stride D).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2],
                                           int n, int r0, int g, int qd) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + h * 8;
    if (r >= n) continue;
    bf16* row = out + (size_t)r * D + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          pack2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// dk, dv of one 128-key tile. Consumer warpgroup w owns keys 64w..64w+63
// of it; per 64-row q tile it computes s^T and dp^T (keys x queries),
// then dv += p^T . dO and dk += ds^T . Q with p^T, ds^T as register
// fragments and dO, Q read MN-major from the stage they arrived in.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_lse,
                const __grid_constant__ CUtensorMap tm_delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int Sq,
                int Sk, int causal) {
  using L = DkvSmem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = align_1k(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int kt = blockIdx.x / BH;  // the first kv tiles have the most work
  const int bh = blockIdx.x % BH;
  const int qt0 = causal ? 2 * kt : 0;  // the first q tile that sees a key
  const int n_tiles = max(cdiv(Sq, kTile) - qt0, 0);
  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers);
    }
    bar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      bar_expect_tx(kv_full, 2 * L::kC * L::kOwnBlock);
      load_tile<D>(sm + L::kOwn0, L::kOwnBlock, &tm_k, kv_full, kt * 2 * kTile,
                   bh);
      load_tile<D>(sm + L::kOwn1, L::kOwnBlock, &tm_v, kv_full, kt * 2 * kTile,
                   bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        bar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        bar_expect_tx(&full[s], 2 * L::kC * L::kRingBlock + 2 * kTile * 4);
        const int row = (qt0 + i) * kTile;
        const int st = s * L::kC * L::kRingBlock;
        load_tile<D>(sm + L::kRing0 + st, L::kRingBlock, &tm_q, &full[s], row,
                     bh);
        load_tile<D>(sm + L::kRing1 + st, L::kRingBlock, &tm_do, &full[s],
                     row, bh);
        tma_load_2d(sm + L::kRingLse + s * kTile * 4, &tm_lse, &full[s], row,
                    bh);
        tma_load_2d(sm + L::kRingDelta + s * kTile * 4, &tm_delta, &full[s],
                    row, bh);
      }
    }
    return;
  }

  // consumers
  regs_inc<240>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = warp * 16;
  const int key0 = kt * 2 * kTile + wg * kTile;  // the warpgroup's first key
  const int nk = min(kTile, Sk - key0);          // <= 0: no key to compute
  const uint32_t k_addr = smem_u32(sm + L::kOwn0) + wg * kTile * kRowBytes;
  const uint32_t v_addr = smem_u32(sm + L::kOwn1) + wg * kTile * kRowBytes;
  float dk_acc[D / 2] = {};
  float dv_acc[D / 2] = {};
  if (n_tiles > 0) bar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, qt = qt0 + i;
    bar_wait(&full[s], (i / kStages) & 1);
    // causal: the warpgroup's keys start past the tile's last row
    const bool live = nk > 0 && !(causal && qt < 2 * kt + wg);
    if (live) {
      const int st = s * L::kC * L::kRingBlock;
      const uint32_t q_addr = smem_u32(sm + L::kRing0 + st);
      const uint32_t do_addr = smem_u32(sm + L::kRing1 + st);
      const float* lse_s =
          reinterpret_cast<const float*>(sm + L::kRingLse) + s * kTile;
      const float* delta_s =
          reinterpret_cast<const float*>(sm + L::kRingDelta) + s * kTile;
      const int nq = min(kTile, Sq - qt * kTile);
      const bool edge = (causal && qt == 2 * kt + wg) || nq < kTile ||
                        nk < kTile;
      float pt[32], dpt[32];
      wgmma_fence();
      mma_scores<D>(pt, k_addr, L::kOwnBlock, q_addr, L::kRingBlock);
      wgmma_commit();
      mma_scores<D>(dpt, v_addr, L::kOwnBlock, do_addr, L::kRingBlock);
      wgmma_commit();
      wgmma_wait<1>();  // s^T is in; dp^T may still run
      fence_regs(pt);
      uint32_t pf[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_s + n * 8 + 2 * qd);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = frag_row(r0, g, e), row = frag_col(n, qd, e);
          float p = expf(pt[4 * n + e] - ((e & 1) ? l2.y : l2.x));
          if (edge && !keep(qt * kTile + row, key0 + key, Sq, Sk, causal))
            p = 0.f;
          pt[4 * n + e] = p;
        }
        to_frag(pf, n, pt[4 * n], pt[4 * n + 1], pt[4 * n + 2],
                pt[4 * n + 3]);
      }
      wgmma_fence();
      mma_pm_rs<D>(dv_acc, pf, do_addr, L::kRingBlock);
      wgmma_commit();
      wgmma_wait<1>();  // dp^T is in; dv may still run
      fence_regs(dpt);
      uint32_t dsf[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(delta_s + n * 8 + 2 * qd);
        float d4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d4[e] = pt[4 * n + e] * (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x));
        to_frag(dsf, n, d4[0], d4[1], d4[2], d4[3]);
      }
      wgmma_fence();
      mma_pm_rs<D>(dk_acc, dsf, q_addr, L::kRingBlock);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pf);
      fence_regs(dsf);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
    }
    bar_arrive(&empty[s]);
  }
  const size_t off = ((size_t)bh * Sk + key0) * D;
  store_rows<D>(dk + off, dk_acc, nk, r0, g, qd);
  store_rows<D>(dv + off, dv_acc, nk, r0, g, qd);
}

// dq of one 128-row q tile. Consumer warpgroup w owns rows 64w..64w+63;
// per 64-key kv tile it computes s and dp, then dq += ds . K with ds as
// register fragments and K read MN-major from its stage.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_lse,
               const __grid_constant__ CUtensorMap tm_delta,
               bf16* __restrict__ dq, int BH, int Sq, int Sk, int causal) {
  using L = DqSmem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = align_1k(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int nqt = cdiv(Sq, 2 * kTile), nkt = cdiv(Sk, kTile);
  const int qt = nqt - 1 - (int)(blockIdx.x / BH);  // longest rows first
  const int bh = blockIdx.x % BH;
  const int row0 = qt * 2 * kTile;
  const int last_row = min(row0 + 2 * kTile, Sq) - 1;
  const int n_kv = causal ? min(last_row / kTile + 1, nkt) : nkt;
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers);
    }
    bar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 256) {
      bar_expect_tx(q_full, 2 * L::kC * L::kOwnBlock + 2 * 2 * kTile * 4);
      load_tile<D>(sm + L::kOwn0, L::kOwnBlock, &tm_q, q_full, row0, bh);
      load_tile<D>(sm + L::kOwn1, L::kOwnBlock, &tm_do, q_full, row0, bh);
      tma_load_2d(sm + L::kOwnLse, &tm_lse, q_full, row0, bh);
      tma_load_2d(sm + L::kOwnDelta, &tm_delta, q_full, row0, bh);
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % kStages;
        bar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        bar_expect_tx(&full[s], 2 * L::kC * L::kRingBlock);
        const int st = s * L::kC * L::kRingBlock;
        load_tile<D>(sm + L::kRing0 + st, L::kRingBlock, &tm_k, &full[s],
                     i * kTile, bh);
        load_tile<D>(sm + L::kRing1 + st, L::kRingBlock, &tm_v, &full[s],
                     i * kTile, bh);
      }
    }
    return;
  }

  // consumers
  regs_inc<240>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = warp * 16;
  const int wrow0 = row0 + wg * kTile;        // the warpgroup's first row
  const int nq = min(kTile, Sq - wrow0);      // <= 0: no row to compute
  const uint32_t q_addr = smem_u32(sm + L::kOwn0) + wg * kTile * kRowBytes;
  const uint32_t do_addr = smem_u32(sm + L::kOwn1) + wg * kTile * kRowBytes;
  bar_wait(q_full, 0);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * kTile + r0 + g + h * 8;
    lse_r[h] = reinterpret_cast<const float*>(sm + L::kOwnLse)[r];
    delta_r[h] = reinterpret_cast<const float*>(sm + L::kOwnDelta)[r];
  }
  float acc[D / 2] = {};
  for (int i = 0; i < n_kv; ++i) {
    const int s = i % kStages;
    bar_wait(&full[s], (i / kStages) & 1);
    // causal: the tile's first key is past the warpgroup's last row
    const bool live = nq > 0 && !(causal && i > 2 * qt + wg);
    if (live) {
      const int st = s * L::kC * L::kRingBlock;
      const uint32_t k_addr = smem_u32(sm + L::kRing0 + st);
      const uint32_t v_addr = smem_u32(sm + L::kRing1 + st);
      const int nk = min(kTile, Sk - i * kTile);
      const bool edge = (causal && i == 2 * qt + wg) || nq < kTile ||
                        nk < kTile;
      float p[32], dp[32];
      wgmma_fence();
      mma_scores<D>(p, q_addr, L::kOwnBlock, k_addr, L::kRingBlock);
      wgmma_commit();
      mma_scores<D>(dp, do_addr, L::kOwnBlock, v_addr, L::kRingBlock);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(p);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = frag_row(r0, g, e), key = frag_col(n, qd, e);
          float x = expf(p[4 * n + e] - lse_r[e >> 1]);
          if (edge && !keep(wrow0 + row, i * kTile + key, Sq, Sk, causal))
            x = 0.f;
          p[4 * n + e] = x;
        }
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t dsf[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float d4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d4[e] = p[4 * n + e] * (dp[4 * n + e] - delta_r[e >> 1]);
        to_frag(dsf, n, d4[0], d4[1], d4[2], d4[3]);
      }
      wgmma_fence();
      mma_pm_rs<D>(acc, dsf, k_addr, L::kRingBlock);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dsf);
      fence_regs(acc);
    }
    bar_arrive(&empty[s]);
  }
  store_rows<D>(dq + ((size_t)bh * Sq + wrow0) * D, acc, nq, r0, g, qd);
}

// ----------------------------------------------------------------- launch

// Sets the kernel's dynamic shared memory, then launches it; returns
// the cudaError_t of either step.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int grid, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd(int bf16_in, const void* q, const void* k, const void* v, void* o,
        void* lse, int BH, int Sq, int Sk, int causal, cudaStream_t s) {
  const int grid = BH * cdiv(Sq, kTile);
  if (bf16_in)
    return launch(flash_fwd_mma<D>, grid, kMmaThreads, fwd_mma_smem_bytes<D>(),
                  s, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(o),
                  static_cast<float*>(lse), BH, Sq, Sk, causal);
  return launch(flash_fwd_kernel<D>, grid, kThreads, fwd_smem_bytes<D>(), s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o),
                static_cast<float*>(lse), BH, Sq, Sk, causal);
}

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint so
// that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A bf16 [BH, S, D] slab as a 3-D tensor map: boxes of `rows` x 64
// columns, 128B-swizzled; rows past S read as zeros.
bool tile_map(CUtensorMap* map, const void* base, int BH, int S, int D,
              int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// f32 rows [BH, S] (lse, delta) as a 2-D tensor map, boxes of `rows`.
bool row_map(CUtensorMap* map, const void* base, int BH, int S, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[1] = {(cuuint64_t)S * 4};
  const cuuint32_t box[2] = {(cuuint32_t)rows, 1};
  const cuuint32_t unit[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The six tensor maps of a backward launch: q, do (and lse, delta) in
// boxes of q_rows, k, v in boxes of k_rows.
struct BwdMaps {
  CUtensorMap q, k, v, dout, lse, delta;
};

template <int D>
bool bwd_maps(BwdMaps* m, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta, int BH,
              int Sq, int Sk, int q_rows, int k_rows) {
  return encode_tiled() != nullptr &&
         tile_map(&m->q, q, BH, Sq, D, q_rows) &&
         tile_map(&m->k, k, BH, Sk, D, k_rows) &&
         tile_map(&m->v, v, BH, Sk, D, k_rows) &&
         tile_map(&m->dout, dout, BH, Sq, D, q_rows) &&
         row_map(&m->lse, lse, BH, Sq, q_rows) &&
         row_map(&m->delta, delta, BH, Sq, q_rows);
}

// bf16 at d = 64, 128: the TMA + wgmma bodies (128-key / 128-row CTAs);
// d = 16, 32: the mma.sync bodies (64-row CTAs). f32: CUDA cores.
template <int D>
int dkv(int bf16_in, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dk,
        void* dv, int BH, int Sq, int Sk, int causal, cudaStream_t s) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (bf16_in) {
    if constexpr (D >= 64) {
      BwdMaps m;
      if (!bwd_maps<D>(&m, q, k, v, dout, lse, delta, BH, Sq, Sk, kTile,
                       2 * kTile))
        return static_cast<int>(cudaErrorInvalidValue);
      return launch(flash_dkv_wgmma<D>, BH * cdiv(Sk, 2 * kTile), kWgThreads,
                    DkvSmem<D>::kBytes, s, m.q, m.k, m.v,
                    m.dout, m.lse, m.delta, static_cast<bf16*>(dk),
                    static_cast<bf16*>(dv), BH, Sq, Sk, causal);
    } else {
      return launch(flash_dkv_mma<D>, BH * cdiv(Sk, kTile), kMmaThreads,
                    dkv_mma_smem_bytes<D>(), s, static_cast<const bf16*>(q),
                    static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                    static_cast<const bf16*>(dout), l, dl,
                    static_cast<bf16*>(dk), static_cast<bf16*>(dv), BH, Sq,
                    Sk, causal);
    }
  }
  return launch(flash_dkv_kernel<D>, BH * cdiv(Sk, kTile), kThreads,
                dkv_smem_bytes<D>(), s, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(dout), l, dl,
                static_cast<float*>(dk), static_cast<float*>(dv), BH, Sq, Sk,
                causal);
}

template <int D>
int dq(int bf16_in, const void* q, const void* k, const void* v,
       const void* dout, const void* lse, const void* delta, void* dq_out,
       int BH, int Sq, int Sk, int causal, cudaStream_t s) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (bf16_in) {
    if constexpr (D >= 64) {
      BwdMaps m;
      if (!bwd_maps<D>(&m, q, k, v, dout, lse, delta, BH, Sq, Sk, 2 * kTile,
                       kTile))
        return static_cast<int>(cudaErrorInvalidValue);
      return launch(flash_dq_wgmma<D>, BH * cdiv(Sq, 2 * kTile), kWgThreads,
                    DqSmem<D>::kBytes, s, m.q, m.k,
                    m.v, m.dout, m.lse, m.delta, static_cast<bf16*>(dq_out),
                    BH, Sq, Sk, causal);
    } else {
      return launch(flash_dq_mma<D>, BH * cdiv(Sq, kTile), kMmaThreads,
                    dq_mma_smem_bytes<D>(), s, static_cast<const bf16*>(q),
                    static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                    static_cast<const bf16*>(dout), l, dl,
                    static_cast<bf16*>(dq_out), BH, Sq, Sk, causal);
    }
  }
  return launch(flash_dq_kernel<D>, BH * cdiv(Sq, kTile), kThreads,
                dq_smem_bytes<D>(), s, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(dout), l, dl,
                static_cast<float*>(dq_out), BH, Sq, Sk, causal);
}

// Dynamic shared memory per CTA that a launch of `pass` (0 forward,
// 1 dkv, 2 dq) sets.
template <int D>
size_t smem_bytes(int pass, int bf16_in) {
  if (!bf16_in)
    return pass == 0 ? fwd_smem_bytes<D>()
                     : pass == 1 ? dkv_smem_bytes<D>() : dq_smem_bytes<D>();
  if (pass == 0) return fwd_mma_smem_bytes<D>();
  if constexpr (D >= 64)
    return pass == 1 ? DkvSmem<D>::kBytes : DqSmem<D>::kBytes;
  else
    return pass == 1 ? dkv_mma_smem_bytes<D>() : dq_mma_smem_bytes<D>();
}

#define RTT_HEAD_DIMS(X) X(16) X(32) X(64) X(128)

}  // namespace

extern "C" {

// Tensors are contiguous: q, o, do, dq [BH, Sq, D]; k, v, dk, dv
// [BH, Sk, D]; lse, delta [BH, Sq] f32. dtype: 0 = float32, 1 =
// bfloat16; D in {16, 32, 64, 128}; Sq, Sk >= 1 (any length: ragged
// tiles are masked). Each returns the cudaError_t of its launch (0 on
// success); the caller checked shapes, types and alignment.
int rtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int dtype, int BH, int Sq,
                            int Sk, int D, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_CASE(d) \
  if (D == d) return fwd<d>(dtype == 1, q, k, v, o, lse, BH, Sq, Sk, causal, s);
  RTT_HEAD_DIMS(RTT_CASE)
#undef RTT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int rtt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int dtype, int BH, int Sq, int Sk, int D,
                                int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_CASE(d)                                                         \
  if (D == d)                                                               \
    return dkv<d>(dtype == 1, q, k, v, dout, lse, delta, dk, dv, BH, Sq, Sk, \
                  causal, s);
  RTT_HEAD_DIMS(RTT_CASE)
#undef RTT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int rtt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq_out, int dtype,
                               int BH, int Sq, int Sk, int D, int causal,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_CASE(d)                                                         \
  if (D == d)                                                               \
    return dq<d>(dtype == 1, q, k, v, dout, lse, delta, dq_out, BH, Sq, Sk, \
                 causal, s);
  RTT_HEAD_DIMS(RTT_CASE)
#undef RTT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory per CTA of a launch (pass 0 forward,
// 1 dkv, 2 dq; dtype as above); -1 for a head dim the kernels do not
// take.
long long rtt_flash_attention_smem_bytes(int pass, int dtype, int D) {
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
