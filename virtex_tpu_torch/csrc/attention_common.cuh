// Pieces shared by the attention kernels K1 (attention_fwd.cu) and K2
// (attention_bwd.cu): dtype conversions, warp reductions, the stride
// records the host passes by value, and the PTX wrappers of the bf16
// tensor-core variants.
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

// The dropout seed lives on the device (so a training step never reads it
// back to the host); only its low 32 bits key the Philox stream. Read only
// when dropout is on: the pointer may be null otherwise.
__device__ __forceinline__ uint32_t load_seed(const long long* seed,
                                              bool dropout) {
  return dropout ? static_cast<uint32_t>(*seed) : 0u;
}

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) / 16 * 16;
}

// -- tensor-core pieces of the bf16 variants (sm_80+ mma.sync, ldmatrix,
// cp.async; all present on sm_90a) ------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; with valid false it reads
// nothing and writes 16 zero bytes (src must still be a legal address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Closes this thread's current group of cp.async copies.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight;
// the caller then syncs the threads that read the data.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits for every cp.async this thread issued; the caller then syncs the
// threads that read the data (__syncwarp or __syncthreads).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row (l % 8) of matrix
// l / 8, and register m receives matrix m in the mma fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate. With
// g = lane / 4 and t = lane % 4: a[0] holds (row g, cols 2t, 2t+1), a[1]
// (row g+8, same cols), a[2] and a[3] the same rows at cols 2t+8, 2t+9;
// b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g); d[0], d[1] (row g, cols
// 2t, 2t+1), d[2], d[3] (row g+8, same cols).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed, the first in the low half (the
// lower column of a fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two fp32 values x0, x1 as two-term bf16 splits, packed as pack_bf16
// packs: x = hi + lo to ~2^-16 relative, hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const float h0 = __bfloat162float(__float2bfloat16_rn(x0));
  const float h1 = __bfloat162float(__float2bfloat16_rn(x1));
  hi = pack_bf16(h0, h1);  // exact: h0, h1 are bf16 values
  lo = pack_bf16(x0 - h0, x1 - h1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace virtex
