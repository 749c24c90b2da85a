// K4: the per-channel sums of the train-mode BatchNorm backward, for
// Hopper (sm_90a).
//
// Replaces virtex_tpu/ops/batchnorm.py::_reduce_kernel (the Pallas TPU
// kernel reached through _sums_call / bn_backward_sums, inside the custom
// VJP of bn_train). One pass over dy and x, both read as row-major (M, C)
// with channels minor (NHWC memory), gives per channel c, in fp32,
//   out[0, c] = sum_m dy[m, c]                     (d beta)
//   out[1, c] = rstd[c] * sum_m dy[m, c] * (x[m, c] - mean[c])   (d gamma)
// dy and x may be bf16 or fp32, each on its own.
//
// What bounds it: bytes. It does 3 flops per 4 bytes read (bf16), far
// below the card's ratio, so its floor is one read of dy and x: at the
// ResNet-50 stem's (128 * 112 * 112, 64) that is 411 MB, ~0.12 ms at
// 3.35 TB/s. On a TPU the grid runs in order on one core and the kernel
// carries the sums from step to step in VMEM; here blocks run in parallel
// in no order, so the reduction has two stages and no float atomics, which
// makes equal inputs give equal bits: stage 1 has a grid of (channel
// tiles of 32, row chunks), each warp of a block walks every 8th row of
// its chunk for 32 neighbouring channels (one 64-byte bf16 segment per row,
// coalesced), and the block's 8 warps are summed in a fixed order into one
// partial per (chunk, channel); stage 2 sums the chunks in order. The
// number of chunks is chosen by the host for about two waves of blocks.
//
// Against its library call, torch.batch_norm_backward_reduce on the same
// channels-last bf16 operands (the same sums without the rstd factor),
// chip_smoke.py phase 9 measured on an H100 SXM at 700 W: 7.53 ms per
// train step for K4 (106 launches, 45% of the 3.40 ms byte bound) against
// 5.80 ms for the library. K4 loses most where C is small: at
// (128 * 56 * 56, 64) it takes 0.126 ms to the library's 0.053, since its
// 32 lanes read one 64-byte segment per row and a block covers only 32
// channels. Wider loads (two or more channels per thread) and fusing the
// dx pass are the next work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;  // channels per block, one per lane
constexpr int kRows = 8;   // warps per block, each on every 8th row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TDY, typename TX>
__global__ void __launch_bounds__(kCols * kRows)
    bn_sums_partial(const TDY* __restrict__ dy, const TX* __restrict__ x,
                    const float* __restrict__ mean,
                    float* __restrict__ partial, long long M, int C,
                    long long rows_per_chunk) {
  __shared__ float s_db[kRows][kCols];
  __shared__ float s_dg[kRows][kCols];
  const int c = blockIdx.x * kCols + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < M ? r0 + rows_per_chunk : M;
  float db = 0.f, dg = 0.f;
  if (c < C) {
    const float mu = mean[c];
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += kRows) {
      const float g = to_f32(dy[r * C + c]);
      db += g;
      dg = fmaf(g, to_f32(x[r * C + c]) - mu, dg);
    }
  }
  s_db[threadIdx.y][threadIdx.x] = db;
  s_dg[threadIdx.y][threadIdx.x] = dg;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int y = 1; y < kRows; ++y) {
      db += s_db[y][threadIdx.x];
      dg += s_dg[y][threadIdx.x];
    }
    float* p = partial + static_cast<size_t>(blockIdx.y) * 2 * C;
    p[c] = db;
    p[C + c] = dg;
  }
}

__global__ void bn_sums_final(const float* __restrict__ partial,
                              const float* __restrict__ rstd,
                              float* __restrict__ out, int C, int chunks) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float db = 0.f, dg = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const float* p = partial + static_cast<size_t>(k) * 2 * C;
    db += p[c];
    dg += p[C + c];
  }
  out[c] = db;
  out[C + c] = dg * rstd[c];
}

template <typename TDY, typename TX>
int launch(const void* dy, const void* x, const float* mean,
           const float* rstd, float* partial, float* out, long long M, int C,
           int chunks, cudaStream_t stream) {
  const long long rows_per_chunk = (M + chunks - 1) / chunks;
  const dim3 grid((C + kCols - 1) / kCols, chunks);
  bn_sums_partial<TDY, TX><<<grid, dim3(kCols, kRows), 0, stream>>>(
      static_cast<const TDY*>(dy), static_cast<const TX*>(x), mean, partial,
      M, C, rows_per_chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_sums_final<<<(C + 255) / 256, 256, 0, stream>>>(partial, rstd, out, C,
                                                     chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dy and x: row-major (M, C); mean, rstd: (C,) fp32; partial: (chunks, 2,
// C) fp32 scratch; out: (2, C) fp32. chunks is at most 65535. Returns
// cudaGetLastError() after the launches (0 on success).
int virtex_bn_backward_sums(const void* dy, const void* x, const void* mean,
                            const void* rstd, void* partial, void* out,
                            long long M, int C, int chunks, int dy_is_bf16,
                            int x_is_bf16, void* stream) {
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dy_is_bf16 && x_is_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(dy, x, mu, rs, part, o, M, C,
                                                chunks, s);
  if (dy_is_bf16)
    return launch<__nv_bfloat16, float>(dy, x, mu, rs, part, o, M, C, chunks,
                                        s);
  if (x_is_bf16)
    return launch<float, __nv_bfloat16>(dy, x, mu, rs, part, o, M, C, chunks,
                                        s);
  return launch<float, float>(dy, x, mu, rs, part, o, M, C, chunks, s);
}

}  // extern "C"
