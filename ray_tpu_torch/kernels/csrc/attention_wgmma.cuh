// The attention bodies for Hopper (TMA + wgmma, bf16, d = 64 and 128),
// one source for each pass of both training paths, which differ only
// in the logit cap (kCap): the forward (flash_attention.cu:
// flash_fwd_wgmma; whole_attention.cu: whole_fwd_wgmma), the dk, dv
// pass and the dq pass (flash_dkv_wgmma, flash_dq_wgmma;
// whole_bwd_wgmma, which runs both).
//
// A CTA is three warpgroups: two consumers (threads 0-255; warpgroup w
// owns 64 rows of the CTA's 128-row tile) and a producer (256-383)
// whose first thread issues every TMA load. Tiles sit in shared memory
// as TMA writes them (hopper.cuh: 128B swizzle, 64-column blocks). The
// CTA's own tile is loaded once; the other side's 64-row tiles stream
// through a ring of kStages stages, `full` barriers counting TMA bytes
// and `empty` barriers counting the 256 consumer threads that are done
// with a stage. One CTA per SM (kMinSmem): with two, each CTA's
// consumers could wait in setmaxnreg.inc for registers the other CTA
// holds.
//
// Masking: a query row r attends to key c iff c < Sk and, when causal,
// c <= r (top-left; Sq = Sk on the whole-kv path). Rows and keys past
// a length read TMA's zeros; only tiles on the diagonal or a ragged
// edge are masked.

#pragma once

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace rtt {

constexpr float kNegInf = -1e30f;
constexpr float kCapHi = 50.f;
constexpr int kStages = 2;
constexpr int kWgThreads = 3 * 128;
constexpr int kConsumers = 256;
constexpr int kRowBytes = 128;               // 64 bf16: one swizzled row
constexpr size_t kMinSmem = 116 * 1024;      // > half an SM's 228 KB

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Whether query row `row` attends to key `key` (absolute positions).
__device__ __forceinline__ bool keep(int row, int key, int Sq, int Sk,
                                     int causal) {
  return row < Sq && key < Sk && (!causal || key <= row);
}

// min(s, 50) that keeps a NaN a NaN, as jnp.minimum does.
__device__ __forceinline__ float cap(float s) {
  return s > kCapHi ? kCapHi : s;
}

// The row and key (within the warp's 16 x N block) of element i of
// score fragment n: rows g, g + 8; columns n*8 + 2q, +1.
__device__ __forceinline__ int frag_row(int r0, int g, int i) {
  return r0 + g + (i >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int n, int qd, int i) {
  return n * 8 + 2 * qd + (i & 1);
}

// Byte offsets of a backward CTA's shared memory: its own tiles,
// kOwnRows rows of two tensors (K, V or Q, dO); the ring, 64 rows of two
// tensors per stage; kRingF32 rows per stage of each of lse and delta
// (dkv) or kOwnF32 of the CTA's own (dq); then the barriers.
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

// One tile of D columns by TMA, one box per 64-column block.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, int block_bytes,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row, int bh) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_3d(dst + c * block_bytes, map, bar, c * 64, row, bh);
}

// s (64 x N) = A . B^T over the head dim: A the warpgroup's 64 rows at
// shared address a (column blocks a_block bytes apart), B N rows at b.
template <int D, int N = 64>
__device__ __forceinline__ void mma_scores(float (&s)[N / 2], uint32_t a,
                                           int a_block, uint32_t b,
                                           int b_block) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(s,
                desc_b128(a + (kk / 4) * a_block + (kk % 4) * 32, 16, 1024),
                desc_b128(b + (kk / 4) * b_block + (kk % 4) * 32, 16, 1024),
                kk > 0);
}

// acc (64 x D) += P . M: P's K columns as K/16 A fragments in
// registers, M a K-row x D tile at shared address m read MN-major (no
// transposed copy), its column blocks m_block bytes apart.
template <int D, int K = 64>
__device__ __forceinline__ void mma_pm_rs(float (&acc)[D / 2],
                                          const uint32_t (&p)[K / 16][4],
                                          uint32_t m, int m_block) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
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

// p = exp(s - lse), with s capped at 50 on the whole-kv path.
template <bool kCap>
__device__ __forceinline__ float prob(float s, float lse) {
  return expf((kCap ? cap(s) : s) - lse);
}

// dk, dv of one 128-key tile kt of head bh. Consumer warpgroup w owns
// keys 64w..64w+63 of it; per 64-row q tile it computes s^T and dp^T
// (keys x queries), then dv += p^T . dO and dk += ds^T . Q with p^T,
// ds^T as register fragments and dO, Q read MN-major from the stage
// they arrived in. Maps: q, do, lse, delta in boxes of 64 rows; k, v
// of 128. `sm` is the CTA's shared memory, 1024-byte aligned.
template <int D, bool kCap>
__device__ __forceinline__ void dkv_wgmma(
    uint8_t* sm, const CUtensorMap* tm_q, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const CUtensorMap* tm_do,
    const CUtensorMap* tm_lse, const CUtensorMap* tm_delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int kt, int bh, int Sq,
    int Sk, int causal) {
  using L = DkvSmem<D>;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

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
      load_tile<D>(sm + L::kOwn0, L::kOwnBlock, tm_k, kv_full, kt * 2 * kTile,
                   bh);
      load_tile<D>(sm + L::kOwn1, L::kOwnBlock, tm_v, kv_full, kt * 2 * kTile,
                   bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        bar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        bar_expect_tx(&full[s], 2 * L::kC * L::kRingBlock + 2 * kTile * 4);
        const int row = (qt0 + i) * kTile;
        const int st = s * L::kC * L::kRingBlock;
        load_tile<D>(sm + L::kRing0 + st, L::kRingBlock, tm_q, &full[s], row,
                     bh);
        load_tile<D>(sm + L::kRing1 + st, L::kRingBlock, tm_do, &full[s],
                     row, bh);
        tma_load_2d(sm + L::kRingLse + s * kTile * 4, tm_lse, &full[s], row,
                    bh);
        tma_load_2d(sm + L::kRingDelta + s * kTile * 4, tm_delta, &full[s],
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
          float p = prob<kCap>(pt[4 * n + e], (e & 1) ? l2.y : l2.x);
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

// dq of one 128-row q tile qt of head bh. Consumer warpgroup w owns rows
// 64w..64w+63; per 64-key kv tile it computes s and dp, then dq += ds .
// K with ds as register fragments and K read MN-major from its stage.
// Maps: q, do, lse, delta in boxes of 128 rows; k, v of 64.
template <int D, bool kCap>
__device__ __forceinline__ void dq_wgmma(
    uint8_t* sm, const CUtensorMap* tm_q, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const CUtensorMap* tm_do,
    const CUtensorMap* tm_lse, const CUtensorMap* tm_delta,
    bf16* __restrict__ dq, int qt, int bh, int Sq, int Sk, int causal) {
  using L = DqSmem<D>;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int nkt = cdiv(Sk, kTile);
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
      load_tile<D>(sm + L::kOwn0, L::kOwnBlock, tm_q, q_full, row0, bh);
      load_tile<D>(sm + L::kOwn1, L::kOwnBlock, tm_do, q_full, row0, bh);
      tma_load_2d(sm + L::kOwnLse, tm_lse, q_full, row0, bh);
      tma_load_2d(sm + L::kOwnDelta, tm_delta, q_full, row0, bh);
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % kStages;
        bar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        bar_expect_tx(&full[s], 2 * L::kC * L::kRingBlock);
        const int st = s * L::kC * L::kRingBlock;
        load_tile<D>(sm + L::kRing0 + st, L::kRingBlock, tm_k, &full[s],
                     i * kTile, bh);
        load_tile<D>(sm + L::kRing1 + st, L::kRingBlock, tm_v, &full[s],
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
          float x = prob<kCap>(p[4 * n + e], lse_r[e >> 1]);
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

// ----------------------------------------------------------------- forward
//
// One body for the streaming forward (flash_attention.cu:
// flash_fwd_wgmma) and the whole-kv forward (whole_attention.cu:
// whole_fwd_wgmma), which differ in the softmax (kCap):
//   streaming  a running max m and sum l per row; acc is rescaled by
//              alpha = exp(m_old - m) at every tile; lse = m + log l;
//   whole-kv   the static shift with the cap, e = exp(min(s, 50) - 25):
//              no max and no rescale, so the tiles of a row only add
//              (tile i's p . V does not wait on tile i+1's softmax);
//              lse = log l + 25.
// Both: 128 q rows per CTA (consumer warpgroup w owns rows 64w..),
// kv tiles of kFwdKeys = 128 keys through the TMA ring (s is one
// m64n128 wgmma chain per warpgroup; 64 keys were slower), l summed
// from the unrounded p (or e), p rounded to bf16 as the A operand of
// acc += p . V with V read MN-major, o = acc / max(l, 1e-30) rounded.
// A CTA walks the work items (q tile, head) that `item(j, qt, bh)`
// yields for j = 0, 1, ... until it returns false; its ring position
// carries over from one item to the next.

constexpr int kFwdKeys = 2 * kTile;
constexpr float kCapShift = 25.f;   // whole-kv: e = exp(min(s, 50) - 25)

// Byte offsets: the CTA's 128 q rows, then K and V rings of kStages
// tiles of kN rows, then the barriers (q_full[kQBars], full, empty).
template <int D, int kQBars = 1>
struct FwdSmem {
  static constexpr int kN = kFwdKeys;
  static constexpr int kC = D / 64;
  static constexpr int kQBlock = 2 * kTile * kRowBytes;
  static constexpr int kKvBlock = kN * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kC * kQBlock;
  static constexpr int kV = kK + kStages * kC * kKvBlock;
  static constexpr int kBars = kV + kStages * kC * kKvBlock;
  static constexpr int kUsed = kBars + (kQBars + 2 * kStages) * 8;
  static constexpr size_t kBytes =
      (size_t)kUsed + 1024 > kMinSmem ? (size_t)kUsed + 1024 : kMinSmem;
  static_assert(kK % 1024 == 0 && kV % 1024 == 0 && kKvBlock % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
};

// The whole-kv forward's layout: a second q barrier (q_empty: the
// consumers are done with an item's Q, so the next item's may load).
template <int D>
using WholeFwdSmem = FwdSmem<D, 2>;

// One kv tile's softmax step for the warpgroup's rows (thread rows
// row + 0, row + 8): masks s where `edge`, updates the running max m
// and sum l, returns alpha = exp(m_old - m) and p = exp(s - m) as bf16
// A fragments (l sums p unrounded).
template <int kN>
__device__ __forceinline__ void softmax_step(float (&s)[kN / 2],
                                             uint32_t (&p)[kN / 16][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge,
                                             int row, int key0, int Sk,
                                             int causal, int qd) {
  if (edge) {
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + frag_col(n, qd, e);
        // rows past Sq are never stored: mask by key alone there
        if (key >= Sk || (causal && key > row + (e >> 1) * 8))
          s[4 * n + e] = kNegInf;
      }
  }
  // a row's columns are spread over the 4 lanes of a quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
      mx = fmaxf(mx, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[h] = expf(m[h] - mx);
    m[h] = mx;
  }
  float part[2] = {};
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = expf(s[4 * n + i] - m[i >> 1]);
    part[0] += e[0] + e[1];
    part[1] += e[2] + e[3];
    to_frag(p, n, e[0], e[1], e[2], e[3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + part[h];
}

// The whole-kv step of one kv tile for the warpgroup's rows: masks s
// where `edge` (-1e30, so e is exactly 0), returns e = exp(min(s, 50)
// - 25) as bf16 A fragments and adds it, unrounded, to l.
template <int kN>
__device__ __forceinline__ void capped_step(float (&s)[kN / 2],
                                            uint32_t (&p)[kN / 16][4],
                                            float (&l)[2], bool edge,
                                            int row, int key0, int Sk,
                                            int causal, int qd) {
  if (edge) {
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + frag_col(n, qd, e);
        if (key >= Sk || (causal && key > row + (e >> 1) * 8))
          s[4 * n + e] = kNegInf;
      }
  }
  float part[2] = {};
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = expf(cap(s[4 * n + i]) - kCapShift);
    part[0] += e[0] + e[1];
    part[1] += e[2] + e[3];
    to_frag(p, n, e[0], e[1], e[2], e[3]);
  }
  l[0] += part[0];
  l[1] += part[1];
}

// The forward over the work items of `item` (above). The producer
// warpgroup's first thread loads each item's Q once (after the
// consumers released the previous one: q_empty, whole-kv only) and
// streams its K and V tiles up to the diagonal through the ring.
template <int D, bool kCap, typename Item>
__device__ __forceinline__ void fwd_wgmma(
    uint8_t* sm, const CUtensorMap* tm_q, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, bf16* __restrict__ o, float* __restrict__ lse,
    Item item, int Sq, int Sk, int causal) {
  constexpr int kN = kFwdKeys;
  using L = FwdSmem<D, kCap ? 2 : 1>;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* q_empty = q_full + 1;   // whole-kv only
  uint64_t* full = q_full + (kCap ? 2 : 1);
  uint64_t* empty = full + kStages;

  const int nkt = cdiv(Sk, kN);
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    if constexpr (kCap) bar_init(q_empty, kConsumers);
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
      int it = 0;   // ring position
      int qt, bh;
      for (int j = 0; item(j, qt, bh); ++j) {
        const int row0 = qt * 2 * kTile;
        const int last_row = min(row0 + 2 * kTile, Sq) - 1;
        const int n_kv = causal ? min(last_row / kN + 1, nkt) : nkt;
        if constexpr (kCap)
          if (j > 0) bar_wait(q_empty, (j - 1) & 1);
        bar_expect_tx(q_full, L::kC * L::kQBlock);
        load_tile<D>(sm + L::kQ, L::kQBlock, tm_q, q_full, row0, bh);
        for (int i = 0; i < n_kv; ++i, ++it) {
          const int s = it % kStages;
          bar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          bar_expect_tx(&full[s], 2 * L::kC * L::kKvBlock);
          const int st = s * L::kC * L::kKvBlock;
          load_tile<D>(sm + L::kK + st, L::kKvBlock, tm_k, &full[s], i * kN,
                       bh);
          load_tile<D>(sm + L::kV + st, L::kKvBlock, tm_v, &full[s], i * kN,
                       bh);
        }
      }
    }
    return;
  }

  // consumers
  regs_inc<240>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = warp * 16;
  const uint32_t q_addr = smem_u32(sm + L::kQ) + wg * kTile * kRowBytes;
  const uint32_t k_base = smem_u32(sm + L::kK);
  const uint32_t v_base = smem_u32(sm + L::kV);
  int it = 0;   // ring position of the item's first tile
  int qt, bh;
  for (int j = 0; item(j, qt, bh); ++j) {
    const int row0 = qt * 2 * kTile;
    const int last_row = min(row0 + 2 * kTile, Sq) - 1;
    const int n_kv = causal ? min(last_row / kN + 1, nkt) : nkt;
    const int wrow0 = row0 + wg * kTile;      // the warpgroup's first row
    const int nq = min(kTile, Sq - wrow0);    // <= 0: no row to compute
    // the tiles the warpgroup computes are a prefix of the item's:
    // causal skips those whose first key is past the warpgroup's last
    // row. Whole-kv: a warpgroup with no row (past Sq) still computes
    // tile 0, on TMA's zero rows and stored nowhere, so that no wgmma
    // sits under a condition that varies from item to item (C7518)
    const int n_live = nq <= 0 ? (kCap ? 1 : 0)
                       : causal ? min(n_kv, (wrow0 + kTile - 1) / kN + 1)
                                : n_kv;
    const int row = wrow0 + r0 + g;           // the thread's first row
    float acc[D / 2] = {};
    float m[2] = {kNegInf, kNegInf}, l[2] = {};
    uint32_t pf[kN / 16][4];   // p of a tile, as A fragments

    auto wait_full = [&](int i) {
      bar_wait(&full[(it + i) % kStages], ((it + i) / kStages) & 1);
    };
    auto release = [&](int i) { bar_arrive(&empty[(it + i) % kStages]); };
    // issues s = Q . K^T of tile i (not waited for)
    auto issue_s = [&](float (&sc)[kN / 2], int i) {
      wgmma_fence();
      mma_scores<D, kN>(sc, q_addr, L::kQBlock,
                        k_base + ((it + i) % kStages) * L::kC * L::kKvBlock,
                        L::kKvBlock);
      wgmma_commit();
    };
    // issues acc += p . V of tile i, p from pf (not waited for)
    auto issue_pv = [&](int i) {
      wgmma_fence();
      mma_pm_rs<D, kN>(acc, pf,
                       v_base + ((it + i) % kStages) * L::kC * L::kKvBlock,
                       L::kKvBlock);
      wgmma_commit();
    };
    auto wait_pv = [&] {
      wgmma_wait<0>();
      fence_regs(pf);
      fence_regs(acc);
    };
    // whether tile i needs a mask: the causal diagonal or keys past Sk
    auto edge_of = [&](int i) {
      const int key0 = i * kN;
      return (causal && key0 + kN - 1 > wrow0) || key0 + kN > Sk;
    };

    if constexpr (kCap) {
      // the capped step of tile i on its waited-for scores
      auto step = [&](float (&sc)[kN / 2], int i) {
        fence_regs(sc);
        capped_step<kN>(sc, pf, l, edge_of(i), row, i * kN, Sk, causal, qd);
      };
      // every consumer waits for every item's Q, so that the parity it
      // waits on is never a phase behind
      bar_wait(q_full, j & 1);
      for (int i = 0; i < n_live; ++i) {
        wait_full(i);
        float sc[kN / 2];
        issue_s(sc, i);
        wgmma_wait<0>();
        step(sc, i);
        issue_pv(i);
        wait_pv();
        release(i);
      }
      bar_arrive(q_empty);   // done with the item's Q
    } else {
      // the softmax step of tile i on its waited-for scores
      auto softmax = [&](float (&sc)[kN / 2], uint32_t (&p)[kN / 16][4],
                         float (&alpha)[2], int i) {
        fence_regs(sc);
        softmax_step<kN>(sc, p, m, l, alpha, edge_of(i), row, i * kN, Sk,
                         causal, qd);
      };
      // Each tile's products are waited for in turn (issuing tile i's s
      // before tile i-1's p . V was slower on the card). Tile 0 is
      // peeled: acc is 0, so its rescale is skipped.
      if (n_live > 0) {
        bar_wait(q_full, 0);
        wait_full(0);
        {
          float sc[kN / 2], alpha[2];
          issue_s(sc, 0);
          wgmma_wait<0>();
          softmax(sc, pf, alpha, 0);
        }
        issue_pv(0);
        wait_pv();
        release(0);
        for (int i = 1; i < n_live; ++i) {
          wait_full(i);
          float sc[kN / 2], alpha[2];
          issue_s(sc, i);
          wgmma_wait<0>();
          softmax(sc, pf, alpha, i);
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj) {
            acc[4 * jj] *= alpha[0];
            acc[4 * jj + 1] *= alpha[0];
            acc[4 * jj + 2] *= alpha[1];
            acc[4 * jj + 3] *= alpha[1];
          }
          issue_pv(i);
          wait_pv();
          release(i);
        }
      }
    }
    for (int i = n_live; i < n_kv; ++i) {  // tiles the warpgroup skips
      wait_full(i);
      release(i);
    }
    it += n_kv;

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = l[h] < 1e-30f ? 1e-30f : l[h];  // NaN stays NaN
    }
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      acc[4 * jj] /= l[0];
      acc[4 * jj + 1] /= l[0];
      acc[4 * jj + 2] /= l[1];
      acc[4 * jj + 3] /= l[1];
    }
    store_rows<D>(o + ((size_t)bh * Sq + wrow0) * D, acc, nq, r0, g, qd);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qd == 0 && r0 + g + h * 8 < nq)
        lse[(size_t)bh * Sq + row + h * 8] =
            kCap ? logf(l[h]) + kCapShift : m[h] + logf(l[h]);
  }
}

// ---------------------------------------------------------------- host side

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

// A bf16 [BH, S, D] slab as a 3-D tensor map: boxes of `rows` x 64
// columns, 128B-swizzled; rows past S read as zeros.
inline bool tile_map(CUtensorMap* map, const void* base, int BH, int S, int D,
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
inline bool row_map(CUtensorMap* map, const void* base, int BH, int S,
                    int rows) {
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

// The six tensor maps of a backward body: q, do (and lse, delta) in
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

}  // namespace rtt
