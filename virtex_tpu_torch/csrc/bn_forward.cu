// BatchNorm's forward for Hopper (sm_90a), in two launches: the per-channel
// statistics of x, and the fused apply y = (x − μ)·(γ·rstd) + β.
//
// Replaces no TPU kernel: the JAX package leaves this forward
// (virtex_tpu/modules/normalization.py, virtex_tpu/ops/batchnorm.py
// bn_train) to XLA, which fuses it into about two passes over x on the TPU.
// Eager PyTorch does not fuse: its forward widened x to fp32, reduced it
// twice, squared it and ran three broadcast ops in the output's type, about
// 28 launches and five times the bytes of these two kernels. x is read as
// row-major (M, C), channels minor (NHWC memory), bf16 or fp32.
//   stats   out[0, c] = Σ_m x[m, c] / M                       (E[x], fp32)
//           out[1, c] = Σ_m x[m, c]² / M                      (E[x²])
//           and, when finalising (no data-parallel group):
//           out[2, c] = var = max(E[x²] − E[x]², 0)
//           out[3, c] = rstd = 1 / sqrt(var + eps)
//           and, given the running statistics, their update
//           rmean[c] ← m·rmean[c] + (1 − m)·E[x]
//           rvar[c] ← m·rvar[c] + (1 − m)·var·n/(n − 1), count += 1
//   apply   y[m, c] = rnd(rnd(rnd(rnd(x) − μ_d) · s_d) + β_d)
//           with μ_d = rnd(μ), s_d = rnd(rstd·γ), β_d = rnd(β) and rnd the
//           rounding to y's type,
// which are ops/batchnorm.py's torch formulas operation for operation: the
// finalisation and each step of the apply round as torch's kernels do
// (IEEE fp32 with no contraction into an FMA, then round to nearest even
// into bf16), so y equals the torch ops' bit for bit given the same
// statistics, and var, rstd and the running statistics equal torch's
// finalisation and update from the same means. The sums themselves run in
// another order than torch's reduction.
//
// What bounds it: bytes. The statistics do 3 flops per 2 bytes read (bf16)
// and the apply 3 per 4 bytes moved, far below the card's ratio, so the
// floors are one read of x, and one read of x and one write of y. The
// design is K4's (bn_backward_sums.cu), with one operand:
// - Vector variants: 16-byte loads (8 bf16 or 4 fp32 channels; 8 bytes of a
//   bf16 operand beside an fp32 one), kUnroll rows of them in flight per
//   thread, a block of 256 threads over a tile of kTileCols vectors by
//   256 / kTileCols row lanes, and the host's grid (k4_plan) one wave of
//   two blocks per SM.
// - The statistics reduce without float atomics, so equal inputs give equal
//   bits: row lanes summed in a fixed order in shared memory, one partial
//   per (chunk, channel), and the last block of a column tile (an integer
//   ticket) sums the chunks' partials in a fixed order and writes the
//   means, and var, rstd and the running statistics when finalising (which
//   saves the ~10 small launches of their update in torch). The ticket
//   counters reset themselves and are K4's, so launches that share them run
//   in order (one stream per device).
// - The apply computes each block's per-channel factors once into shared
//   memory, rounds two elements per bf16 conversion (cvt.rn.bf16x2.f32; the
//   conversions, three an element, cost as much as the arithmetic), and
//   writes y with 16-byte stores.
// - Scalar variants, for C not a multiple of the vector width or x not
//   16-byte aligned: the statistics in two launches (a block of 32
//   channels by 8 warps over row chunks, then one thread per channel over
//   the chunks), the apply one element per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bn_common.cuh"

namespace {

using namespace virtex_bn;

constexpr int kUnroll = 8;     // rows of loads a thread keeps in flight

// v rounded to T and widened back: torch's round into a bf16 result.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// v rounded to T in place, two elements per conversion.
template <typename T, int N>
__device__ __forceinline__ void rnd_all(float (&v)[N]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const uint32_t w = bf16x2(v[i], v[i + 1]);
      v[i] = bf16_lo(w);
      v[i + 1] = bf16_hi(w);
    }
  }
}

// The running statistics a finalising launch updates (null mean: none),
// with torch's fp32 scalars: m, 1 − m and the Bessel factor n / (n − 1).
struct Running {
  float* mean;
  float* var;
  long long* count;  // num_batches_tracked
  float m, om, bessel;
};

// Channel c's means from its sums, and var and rstd when finalising, as
// ops/batchnorm.py _finalise computes them in torch, then the running
// statistics as update_running_reference does: each operation rounded on
// its own.
__device__ __forceinline__ void write_stats(float sum, float sum2, float m,
                                            float eps, int finalise,
                                            const Running& run, int C, int c,
                                            float* __restrict__ out) {
  const float mean = __fdiv_rn(sum, m);
  const float mean2 = __fdiv_rn(sum2, m);
  out[c] = mean;
  out[C + c] = mean2;
  if (finalise) {
    float var = __fsub_rn(mean2, __fmul_rn(mean, mean));
    var = var < 0.f ? 0.f : var;  // torch.clamp(min=0), NaN kept
    out[2 * C + c] = var;
    out[3 * C + c] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    if (run.mean != nullptr) {
      run.mean[c] = __fadd_rn(__fmul_rn(run.m, run.mean[c]),
                              __fmul_rn(run.om, mean));
      run.var[c] = __fadd_rn(__fmul_rn(run.m, run.var[c]),
                             __fmul_rn(__fmul_rn(run.om, var), run.bessel));
      if (c == 0) *run.count += 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Statistics, vector variant.

template <typename TX, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    bn_fwd_stats_vec(const TX* __restrict__ x, float* __restrict__ partial,
                     unsigned* __restrict__ tickets, float* __restrict__ out,
                     long long M, int C, long long rows_per_chunk, float eps,
                     int finalise, Running run) {
  using VX = Vec<TX, VEC>;
  // Row-lane sums of the block, then the last block's chunk sums.
  __shared__ float4 s_buf[2 * kThreads * VEC / 4];
  __shared__ bool s_last;
  float* s_s1 = reinterpret_cast<float*>(s_buf);
  float* s_s2 = s_s1 + kThreads * VEC;
  const Tile t = tile_of<VEC>(C);

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s1[v] = s2[v] = 0.f;
  if (t.active) {
    long long r0, r1;
    chunk_rows(M, rows_per_chunk, &r0, &r1);
    // Rows r, r + rpb, ... in order; up to kUnroll of them loaded at once.
    for (long long r = r0 + t.lane; r < r1; r += kUnroll * t.rpb) {
      typename VX::Raw xr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = r + u * t.rpb;
        if (row < r1)
          xr[u] = *reinterpret_cast<const typename VX::Raw*>(x + row * C +
                                                             t.c0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * t.rpb < r1) {
          float xf[VEC];
          VX::unpack(xr[u], xf);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            s1[v] += xf[v];
            s2[v] = fmaf(xf[v], xf[v], s2[v]);
          }
        }
      }
    }
  }

  // The block's row lanes, summed per channel in lane order.
  if (t.lane < t.rpb) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      s_s1[t.lane * t.nch + t.col * VEC + v] = s1[v];
      s_s2[t.lane * t.nch + t.col * VEC + v] = s2[v];
    }
  }
  __syncthreads();
  float* p = partial + static_cast<size_t>(blockIdx.y) * 2 * C + t.tile_c0;
  for (int j = threadIdx.x; j < 2 * t.tile_n; j += kThreads) {
    const int which = j / t.tile_n;
    const int k = j - which * t.tile_n;
    const float* src = (which ? s_s2 : s_s1) + k;
    float acc = 0.f;
    for (int lane = 0; lane < t.rpb; ++lane) acc += src[lane * t.nch];
    p[static_cast<size_t>(which) * C + k] = acc;
  }

  // Take a ticket; the tile's last block goes on.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The chunks' partials of this tile: groups of threads each sum every
  // groups-th chunk in order, four channels per load, then the groups are
  // summed in order into s_buf's first width float4s (each thread's own).
  const int q = t.tile_n / 4;  // float4s of one sum over the tile
  const int width = 2 * q;     // Σx's, then Σx²'s
  const int groups = kThreads / width;
  const int col4 = threadIdx.x % width;
  const int group = threadIdx.x / width;
  if (group < groups) {
    const int which = col4 / q;
    const float4* src = reinterpret_cast<const float4*>(
                            partial + static_cast<size_t>(which) * C +
                            t.tile_c0) + (col4 - which * q);
    const size_t chunk4 = static_cast<size_t>(C) / 2;  // 2C floats per chunk
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = group; k < static_cast<int>(gridDim.y); k += groups) {
      const float4 v = __ldcg(src + k * chunk4);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    s_buf[group * width + col4] = acc;
  }
  __syncthreads();
  if (threadIdx.x < width) {
    float4 acc = s_buf[threadIdx.x];
    for (int g = 1; g < groups; ++g) {
      const float4 v = s_buf[g * width + threadIdx.x];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    s_buf[threadIdx.x] = acc;  // read by no other thread before the barrier
  }
  __syncthreads();
  // s_s1[j]: Σx of the tile's channel j; s_s1[tile_n + j]: its Σx².
  const float m = static_cast<float>(M);
  for (int j = threadIdx.x; j < t.tile_n; j += kThreads)
    write_stats(s_s1[j], s_s1[t.tile_n + j], m, eps, finalise, run, C,
                t.tile_c0 + j, out);
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;  // for the next launch
}

// ---------------------------------------------------------------------------
// Statistics, scalar variant (two launches).

template <typename TX>
__global__ void __launch_bounds__(kCols * kRows)
    bn_fwd_stats_partial(const TX* __restrict__ x, float* __restrict__ partial,
                         long long M, int C, long long rows_per_chunk) {
  __shared__ float s_s1[kRows][kCols];
  __shared__ float s_s2[kRows][kCols];
  const int c = blockIdx.x * kCols + threadIdx.x;
  long long r0, r1;
  chunk_rows(M, rows_per_chunk, &r0, &r1);
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += kRows) {
      const float v = to_f32(x[r * C + c]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
  }
  s_s1[threadIdx.y][threadIdx.x] = s1;
  s_s2[threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int y = 1; y < kRows; ++y) {
      s1 += s_s1[y][threadIdx.x];
      s2 += s_s2[y][threadIdx.x];
    }
    float* p = partial + static_cast<size_t>(blockIdx.y) * 2 * C;
    p[c] = s1;
    p[C + c] = s2;
  }
}

__global__ void bn_fwd_stats_final(const float* __restrict__ partial,
                                   float* __restrict__ out, long long M,
                                   int C, int chunks, float eps,
                                   int finalise, Running run) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s1 = 0.f, s2 = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const float* p = partial + static_cast<size_t>(k) * 2 * C;
    s1 += p[c];
    s2 += p[C + c];
  }
  write_stats(s1, s2, static_cast<float>(M), eps, finalise, run, C, c,
              out);
}

// ---------------------------------------------------------------------------
// Apply.

// μ_d, s_d, β_d of channel c, each a value of TY held in fp32.
template <typename TY>
__device__ __forceinline__ void factors(const float* __restrict__ mean,
                                        const float* __restrict__ rstd,
                                        const float* __restrict__ weight,
                                        const float* __restrict__ bias, int c,
                                        float* mu, float* s, float* b) {
  *mu = rnd<TY>(mean[c]);
  *s = rnd<TY>(__fmul_rn(rstd[c], weight[c]));
  *b = rnd<TY>(bias[c]);
}

// Whether x has to be rounded to y's type first: fp32 x into a bf16 y.
template <typename TX, typename TY>
__host__ __device__ constexpr bool narrows() {
  return std::is_same<TX, float>::value &&
         std::is_same<TY, __nv_bfloat16>::value;
}

template <typename TX, typename TY, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    bn_fwd_apply_vec(const TX* __restrict__ x, const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias, TY* __restrict__ y,
                     long long M, int C, long long rows_per_chunk) {
  using VX = Vec<TX, VEC>;
  using VY = Vec<TY, VEC>;
  __shared__ float s_coef[3][kTileCols * VEC];  // μ_d, s_d, β_d of the tile
  const Tile t = tile_of<VEC>(C);
  for (int j = threadIdx.x; j < t.tile_n; j += kThreads)
    factors<TY>(mean, rstd, weight, bias, t.tile_c0 + j, &s_coef[0][j],
                &s_coef[1][j], &s_coef[2][j]);
  __syncthreads();
  if (!t.active) return;
  float mu[VEC], s[VEC], b[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int j = t.col * VEC + v;
    mu[v] = s_coef[0][j];
    s[v] = s_coef[1][j];
    b[v] = s_coef[2][j];
  }
  long long r0, r1;
  chunk_rows(M, rows_per_chunk, &r0, &r1);
  for (long long r = r0 + t.lane; r < r1; r += kUnroll * t.rpb) {
    typename VX::Raw xr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * t.rpb;
      if (row < r1)
        xr[u] = *reinterpret_cast<const typename VX::Raw*>(x + row * C +
                                                           t.c0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * t.rpb;
      if (row < r1) {
        float o[VEC];
        VX::unpack(xr[u], o);
        if constexpr (narrows<TX, TY>()) rnd_all<TY>(o);
#pragma unroll
        for (int v = 0; v < VEC; ++v) o[v] = __fsub_rn(o[v], mu[v]);
        rnd_all<TY>(o);
#pragma unroll
        for (int v = 0; v < VEC; ++v) o[v] = __fmul_rn(o[v], s[v]);
        rnd_all<TY>(o);
#pragma unroll
        for (int v = 0; v < VEC; ++v) o[v] = __fadd_rn(o[v], b[v]);
        *reinterpret_cast<typename VY::Raw*>(y + row * C + t.c0) =
            VY::pack(o);
      }
    }
  }
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_apply_scalar(const TX* __restrict__ x,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ weight,
                        const float* __restrict__ bias, TY* __restrict__ y,
                        long long n, int C) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += step) {
    float mu, s, b;
    factors<TY>(mean, rstd, weight, bias, static_cast<int>(i % C), &mu, &s,
                &b);
    const float xf = to_f32(x[i]);
    const float xv = narrows<TX, TY>() ? rnd<TY>(xf) : xf;
    const float d = rnd<TY>(__fsub_rn(xv, mu));
    y[i] = from_f32<TY>(__fadd_rn(rnd<TY>(__fmul_rn(d, s)), b));
  }
}

// ---------------------------------------------------------------------------
// Host side.

template <typename TX>
int stats_typed(const void* x, float* partial, void* tickets, float* out,
                long long M, int C, int chunks, int vec, float eps,
                int finalise, const Running& run, cudaStream_t s) {
  const TX* xv = static_cast<const TX*>(x);
  const long long rows_per_chunk = (M + chunks - 1) / chunks;
  if (vec == 1) {
    const dim3 grid((C + kCols - 1) / kCols, chunks);
    bn_fwd_stats_partial<TX><<<grid, dim3(kCols, kRows), 0, s>>>(
        xv, partial, M, C, rows_per_chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bn_fwd_stats_final<<<(C + 255) / 256, 256, 0, s>>>(
        partial, out, M, C, chunks, eps, finalise, run);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int V = vec_width<TX, TX>();
  if (vec != V || C % V != 0 || !aligned16(x) || !aligned16(partial) ||
      tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tile_columns(C, V), chunks);
  bn_fwd_stats_vec<TX, V><<<grid, kThreads, 0, s>>>(
      xv, partial, static_cast<unsigned*>(tickets), out, M, C,
      rows_per_chunk, eps, finalise, run);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TY>
int apply_typed(const void* x, const float* mean, const float* rstd,
                const float* weight, const float* bias, void* y, long long M,
                int C, int chunks, int vec, cudaStream_t s) {
  const TX* xv = static_cast<const TX*>(x);
  TY* out = static_cast<TY*>(y);
  if (vec == 1) {
    const long long n = M * C;
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
    bn_fwd_apply_scalar<TX, TY><<<blocks, kThreads, 0, s>>>(
        xv, mean, rstd, weight, bias, out, n, C);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int V = vec_width<TX, TY>();
  if (vec != V || C % V != 0 || !aligned16(x) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tile_columns(C, V), chunks);
  bn_fwd_apply_vec<TX, TY, V><<<grid, kThreads, 0, s>>>(
      xv, mean, rstd, weight, bias, out, M, C, (M + chunks - 1) / chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: row-major (M, C); partial: (chunks, 2, C) fp32 scratch; tickets: at
// least as many zeroed uint32 as column tiles (vector variant; left
// zeroed); out: (2, C) fp32, or (4, C) when finalise is set (rows E[x],
// E[x²], var, rstd; eps read only then). When finalising with
// running_mean set, the (C,) fp32 running_mean and running_var and the
// int64 count are updated as ops/batchnorm.py update_running_reference
// does, from the fp32 momentum, one_minus_momentum and bessel (null
// running_mean: not read). vec: 1 for the scalar variant, else the vector
// width of x's type. chunks is at most 65535 and leaves no chunk empty.
// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for operands the vector variant cannot read.
int virtex_bn_forward_stats(const void* x, void* partial, void* tickets,
                            void* out, void* running_mean, void* running_var,
                            void* count, long long M, int C, int chunks,
                            int vec, float eps, int finalise, float momentum,
                            float one_minus_momentum, float bessel,
                            int x_is_bf16, void* stream) {
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  const Running run{static_cast<float*>(running_mean),
                    static_cast<float*>(running_var),
                    static_cast<long long*>(count), momentum,
                    one_minus_momentum, bessel};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return stats_typed<__nv_bfloat16>(x, part, tickets, o, M, C, chunks, vec,
                                      eps, finalise, run, s);
  return stats_typed<float>(x, part, tickets, o, M, C, chunks, vec, eps,
                            finalise, run, s);
}

// x: row-major (M, C); mean, rstd, weight, bias: (C,) fp32; y: row-major
// (M, C) of y's type. vec and chunks as k4_plan gives them for the wider
// of x's and y's types (the scalar variant does not read chunks).
int virtex_bn_forward_apply(const void* x, const void* mean, const void* rstd,
                            const void* weight, const void* bias, void* y,
                            long long M, int C, int chunks, int vec,
                            int x_is_bf16, int y_is_bf16, void* stream) {
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_is_bf16 && y_is_bf16)
    return apply_typed<bf16, bf16>(x, mu, rs, w, b, y, M, C, chunks, vec, s);
  if (x_is_bf16)
    return apply_typed<bf16, float>(x, mu, rs, w, b, y, M, C, chunks, vec, s);
  if (y_is_bf16)
    return apply_typed<float, bf16>(x, mu, rs, w, b, y, M, C, chunks, vec, s);
  return apply_typed<float, float>(x, mu, rs, w, b, y, M, C, chunks, vec, s);
}

}  // extern "C"
