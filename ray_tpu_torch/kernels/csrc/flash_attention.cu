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
// (delta = rowsum(o * do) is an input: attention_delta.cu.) There is
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
// 4 (s, dp, dv, dk: ~0.56 ms), the dq pass 3 (s, dp, dq: ~0.42 ms). So
// what matters is keeping the tensor cores fed: wgmma, loads that
// overlap the products, and no work on the side of them that the
// function does not need.
//
// Design. The TPU grid gives a program a 512-row q (or kv) block and
// the whole other side in VMEM, walking 512-wide blocks of it in a
// loop. Here a CTA owns one tile and walks tiles of the other side
// through shared memory; kv tiles past the diagonal are not visited,
// only diagonal and ragged tiles are masked, and the CTAs with the
// most tiles are launched first (the bf16 forward's within each head). The backward is two launches, as on
// the TPU (dkv: a CTA per kv tile loops over the q tiles from the
// diagonal down and sums dk, dv in f32, rounded once; dq: a CTA per q
// tile): no atomics, and the result does not depend on the order the
// CTAs run in. Ragged sequences (a multiple of 16, not of the tile)
// read zeros past the slab and mask those rows and keys.
//
// bf16 at d = 64 and 128 (the training path; flash_fwd_wgmma,
// flash_dkv_wgmma and flash_dq_wgmma here run the bodies of
// attention_wgmma.cuh, shared with the whole-kv kernels): built for
// Hopper (hopper.cuh). A CTA has a producer
// warpgroup, whose one thread issues TMA loads, and two consumer
// warpgroups of 64 rows each, so a CTA owns 128 query rows (forward,
// dq) or 128 keys (dkv), and the other side is read half as often as
// with 64-row CTAs. The CTA's own tiles arrive once; the other side's
// tiles stream through a 2-stage ring behind mbarriers, so the next
// tile loads while the tensor cores work on this one. Every product is
// a wgmma: s (and dp) from shared memory with both operands K-major;
// p . v, dv, dk, dq with p or ds as register fragments (the wgmma
// accumulator's layout is the mma.sync m16n8 one, so to_frag turns it
// into A fragments) and the other operand read MN-major through the
// descriptor's transpose bit, so no tile is stored twice (no
// transposed V, Q, dO or K). The forward takes kv tiles of 128 keys (s
// is one m64n128 wgmma chain; 64 were slower) and waits for each
// product in turn: issuing tile i's s before tile i-1's p . v (FA3's
// overlap within a warpgroup) was slower on the card. The
// running max and sum stay in registers. While one consumer warpgroup
// runs its softmax, the other's products keep the tensor cores busy.
// Its CTAs go head by head (a head's q tiles adjacent, longest first),
// so the CTAs running together share their heads' K and V in L2. The
// consumers take 240 registers (setmaxnreg), the producer 24; one CTA
// per SM (kMinSmem). Rounding points, masks and the -1e30 fill are
// those of the functions above.
//
// bf16 at d = 16, 32 (rows narrower than a 128-byte swizzled block; no
// main path runs them): mma.sync m16n8k16 with 64-row CTAs of 4 warps
// (attention_tiles.cuh), loads through registers. f32 runs on the CUDA
// cores, so the f32 checks hold the tiling and masking to f32
// rounding.
//
// Plain C interface, loaded with ctypes by ray_tpu_torch/kernels.

#include "attention_wgmma.cuh"

namespace {

using namespace rtt;

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

// ------------------------------------------ Hopper bodies: TMA + wgmma (bf16)

// The streaming backward at d = 64, 128: attention_wgmma.cuh's bodies
// without the logit cap, one CTA per 128-key (dkv) or 128-row (dq)
// tile.
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
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the first kv tiles have the most work
  dkv_wgmma<D, false>(align_1k(smem_raw), &tm_q, &tm_k, &tm_v, &tm_do,
                      &tm_lse, &tm_delta, dk, dv, blockIdx.x / BH,
                      blockIdx.x % BH, Sq, Sk, causal);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_lse,
               const __grid_constant__ CUtensorMap tm_delta,
               bf16* __restrict__ dq, int BH, int Sq, int Sk, int causal) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // longest rows first
  dq_wgmma<D, false>(align_1k(smem_raw), &tm_q, &tm_k, &tm_v, &tm_do,
                     &tm_lse, &tm_delta, dq,
                     cdiv(Sq, 2 * kTile) - 1 - (int)(blockIdx.x / BH),
                     blockIdx.x % BH, Sq, Sk, causal);
}

// One CTA per (b*h, 128-row q tile): attention_wgmma.cuh's forward
// body without the cap (a running max and sum per row). The CTAs go
// head by head (a head's q tiles adjacent, so the CTAs running together
// share its K and V in L2), the longest rows first.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                bf16* __restrict__ o, float* __restrict__ lse, int BH,
                int Sq, int Sk, int causal) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int nqt = cdiv(Sq, 2 * kTile);
  auto item = [&](int j, int& qt, int& bh) {
    qt = nqt - 1 - (int)(blockIdx.x % nqt);
    bh = blockIdx.x / nqt;
    return j == 0;
  };
  fwd_wgmma<D, false>(align_1k(smem_raw), &tm_q, &tm_k, &tm_v, o, lse, item,
                      Sq, Sk, causal);
}

// ----------------------------------------------------------------- launch

// bf16 at d = 64, 128: the TMA + wgmma bodies (128-row CTAs); d = 16,
// 32: the mma.sync bodies (64-row CTAs). f32: CUDA cores.
template <int D>
int fwd(int bf16_in, const void* q, const void* k, const void* v, void* o,
        void* lse, int BH, int Sq, int Sk, int causal, cudaStream_t s) {
  const int grid = BH * cdiv(Sq, kTile);
  if (bf16_in) {
    if constexpr (D >= 64) {
      CUtensorMap tq, tk, tv;
      if (encode_tiled() == nullptr ||
          !tile_map(&tq, q, BH, Sq, D, 2 * kTile) ||
          !tile_map(&tk, k, BH, Sk, D, kFwdKeys) ||
          !tile_map(&tv, v, BH, Sk, D, kFwdKeys))
        return static_cast<int>(cudaErrorInvalidValue);
      return launch(flash_fwd_wgmma<D>, BH * cdiv(Sq, 2 * kTile), kWgThreads,
                    FwdSmem<D>::kBytes, s, tq, tk, tv,
                    static_cast<bf16*>(o), static_cast<float*>(lse), BH, Sq,
                    Sk, causal);
    } else {
      return launch(flash_fwd_mma<D>, grid, kMmaThreads,
                    fwd_mma_smem_bytes<D>(), s, static_cast<const bf16*>(q),
                    static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                    static_cast<bf16*>(o), static_cast<float*>(lse), BH, Sq,
                    Sk, causal);
    }
  }
  return launch(flash_fwd_kernel<D>, grid, kThreads, fwd_smem_bytes<D>(), s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o),
                static_cast<float*>(lse), BH, Sq, Sk, causal);
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
  if constexpr (D >= 64)
    return pass == 0   ? FwdSmem<D>::kBytes
           : pass == 1 ? DkvSmem<D>::kBytes
                       : DqSmem<D>::kBytes;
  else
    return pass == 0   ? fwd_mma_smem_bytes<D>()
           : pass == 1 ? dkv_mma_smem_bytes<D>()
                       : dq_mma_smem_bytes<D>();
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
