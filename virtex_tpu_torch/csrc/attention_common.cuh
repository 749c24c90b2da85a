// Pieces shared by the attention kernels K1 (attention_fwd.cu) and K2
// (attention_bwd.cu): dtype conversions, warp reductions, and the stride
// records the host passes by value.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace virtex {

constexpr float kMaskedLogit = -1e9f;  // virtex_tpu NEG_INF, not -inf

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Strides {  // in elements; the D stride is 1
  long long b, t, n;
};

struct MaskStrides {  // in elements of a 1-byte bool tensor
  long long b, h, q, k;
};

}  // namespace virtex
