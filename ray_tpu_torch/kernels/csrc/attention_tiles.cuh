// Tile helpers shared by the attention kernels (whole_attention.cu,
// flash_attention.cu): 64-row tiles of a row-major [S, D] slab moved
// into shared memory, and the products on them.
//
// f32 inputs run on the CUDA cores: 256 threads (16 x 16), each owning
// a 4 x 4 piece of a 64 x 64 score tile, with fma.
//
// bf16 inputs run on the tensor cores with mma.sync m16n8k16 (bf16 in,
// f32 accumulate). A CTA is 4 warps; each warp owns 16 rows of the
// CTA's 64-row tile and the 16 x 64 score block of those rows against
// a 64-row tile of the other side. Operands sit in shared memory as
// bf16, rows padded by 8 elements so that the fragment loads of a warp
// hit 32 distinct banks; the operands a product needs k-major are
// stored transposed. The score block's accumulator fragment is laid
// out as the A fragment of the next product, so a probability goes
// from f32 registers to bf16 registers (rounded to nearest even)
// without passing through shared memory.
//
// Every loader takes the number of valid rows n (default: all 64) and
// writes zeros to the rows past it, so a ragged last tile of a
// sequence reads nothing past the slab.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace rtt {

constexpr int kTile = 64;       // rows of q and of k/v per tile
constexpr int kThreads = 256;   // f32 path: 16 x 16, each a 4 x 4 piece
constexpr int kMmaThreads = 128;
constexpr int kLdT = kTile + 8;  // row stride of a transposed bf16 tile

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------------------------- f32 tiles

// A 64 x D tile of a row-major [S, D] slab into shared memory,
// row-major: dst[r * D + c].
template <int D>
__device__ __forceinline__ void tile_rows(const float* __restrict__ src,
                                          float* dst, int n = kTile) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    *reinterpret_cast<float4*>(dst + r * D + c) =
        r < n ? ld4(src + (size_t)r * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The same tile transposed: dst[c * 64 + r]. Rows run fastest across
// threads, so the scalar stores of a warp land in distinct banks.
template <int D>
__device__ __forceinline__ void tile_cols(const float* __restrict__ src,
                                          float* dst, int n = kTile) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i % kTile, c = (i / kTile) * 4;
    const float4 x =
        r < n ? ld4(src + (size_t)r * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
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

// ------------------------------------------------ bf16 tensor-core tiles

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
                                         bf16* dst, int n = kTile) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kTile * kVec; i += kMmaThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) =
        r < n ? *reinterpret_cast<const uint4*>(src + (size_t)r * D + c)
              : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The same tile transposed: shared [D][64 + 8]; rows run fastest
// across threads, so a warp's 2-byte stores fill 16 distinct words.
template <int D>
__device__ __forceinline__ void mma_cols(const bf16* __restrict__ src,
                                         bf16* dst, int n = kTile) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kTile * kVec; i += kMmaThreads) {
    const int r = i % kTile, c = (i / kTile) * 8;
    const uint4 u = r < n
        ? *reinterpret_cast<const uint4*>(src + (size_t)r * D + c)
        : make_uint4(0u, 0u, 0u, 0u);
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
template <int K>
__device__ __forceinline__ void to_frag(uint32_t (&p)[K][4], int n, float v0,
                                        float v1, float v2, float v3) {
  p[n / 2][(n % 2) * 2] = pack2(v0, v1);
  p[n / 2][(n % 2) * 2 + 1] = pack2(v2, v3);
}

}  // namespace rtt
