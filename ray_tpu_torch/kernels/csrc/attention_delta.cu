// The attention backward's row term delta = rowsum(o * do), in f32, for
// Hopper (sm_90a): one pass over o and do. Both training-attention
// backwards take it as an input (whole_attention.cu, flash_attention.cu),
// as the JAX package's do (ray_tpu/ops/attention.py: jnp.sum outside its
// Pallas backward kernels, in _whole_backward and _flash_backward).
//
// Bound on this card: 2 * D flops per row against 2 * D * sizeof(dtype)
// bytes read, so it is bound by HBM bytes: o and do read once, delta
// written once. Each thread loads 16 bytes of a row of o and of do and
// multiplies them in f32; the D / (16 / sizeof(dtype)) threads of a row
// (a power of two, at most a warp) sum by shuffles.
//
// Plain C interface, loaded with ctypes by ray_tpu_torch/kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  constexpr int kVec = 16 / sizeof(T);           // elements per thread
  constexpr int kThr = D / kVec;                 // threads per row
  static_assert(kThr >= 1 && kThr <= 32 && (kThr & (kThr - 1)) == 0,
                "a row is a power-of-two number of 16-byte pieces");
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int r = t / kThr;
  float sum = 0.f;
  if (r < rows) {
    const size_t off = (size_t)r * D + (t % kThr) * kVec;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + off);
    T x[kVec], y[kVec];
    memcpy(x, &a, 16);
    memcpy(y, &b, 16);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if constexpr (sizeof(T) == 2)
        sum += __bfloat162float(x[i]) * __bfloat162float(y[i]);
      else
        sum += x[i] * y[i];
    }
  }
#pragma unroll
  for (int off = kThr / 2; off >= 1; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (r < rows && t % kThr == 0) delta[r] = sum;
}

template <typename T, int D>
int launch(const void* o, const void* dout, void* delta, int rows,
           cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / (D * sizeof(T) / 16);
  attention_delta_kernel<T, D>
      <<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, stream>>>(
          static_cast<const T*>(o), static_cast<const T*>(dout),
          static_cast<float*>(delta), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// o, do contiguous [rows, D], 16-byte aligned; delta [rows] f32. dtype:
// 0 = float32, 1 = bfloat16; D in {16, 32, 64, 128}. Returns the
// cudaError_t of the launch (0 on success); the caller checked shapes,
// types and alignment.
int rtt_attention_delta(const void* o, const void* dout, void* delta,
                        int dtype, int rows, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_CASE(d)                                                 \
  if (D == d)                                                       \
    return dtype == 1 ? launch<__nv_bfloat16, d>(o, dout, delta, rows, s) \
                      : launch<float, d>(o, dout, delta, rows, s);
  RTT_CASE(16) RTT_CASE(32) RTT_CASE(64) RTT_CASE(128)
#undef RTT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
