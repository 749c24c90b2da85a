// K4: the train-mode BatchNorm backward for Hopper (sm_90a), in two
// launches: the per-channel sums (stage 1) and the input gradient (stage 2).
//
// Replaces virtex_tpu/ops/batchnorm.py::_reduce_kernel (the Pallas TPU
// kernel reached through _sums_call / bn_backward_sums, inside the custom
// VJP of bn_train) and the jnp dx stage beside it (_bn_train_bwd, :278-287),
// which XLA fuses into one pass on the TPU; in eager PyTorch only a kernel
// fuses it. dy and x are read as row-major (M, C), channels minor (NHWC
// memory); each may be bf16 or fp32 on its own. In fp32:
//   stage 1  out[0, c] = sum_m dy[m, c]                                (dβ)
//            out[1, c] = rstd[c] * sum_m dy[m, c] * (x[m, c] - mean[c])  (dγ)
//   stage 2  dx[m, c] = γ[c]·rstd[c] · (dy[m, c] - dβ[c]/M
//                                        - (x[m, c] - mean[c])·rstd[c] · dγ[c]/M)
// and dx is rounded once to x's type. This is _bn_train_bwd's formula term
// for term; its gmean and gvar terms are zero here, because the port marks
// the returned mean and var non-differentiable. The stages stay two
// launches so that a multi-GPU step can all-reduce the (2, C) sums between
// them, as the JAX package psums them.
//
// What bounds it: bytes. Stage 1 does 3 flops per 4 bytes read (bf16),
// stage 2 six per 6 bytes moved, far below the card's ratio, so the floors
// are one read of dy and x (stage 1) and that plus one write of dx (stage 2).
// The design is about bytes in flight:
// - Vector variants. Each thread reads 16 bytes of a row per load (8 bf16 or
//   4 fp32 channels; 8 bytes of a bf16 operand beside an fp32 one) and keeps
//   up to kUnroll rows of dy and x loads in flight before it adds, the last
//   rows of its chunk too. A block of 256 threads covers a tile of
//   kTileCols such vectors (128 bytes of a row of the wider operand) and
//   256 / kTileCols rows at once: at C = 64 bf16 a warp reads four whole
//   rows per load. The host sizes the grid (column tiles × row chunks) to
//   one wave of two blocks per SM where the rows allow (at least four rows
//   per row lane): 64 KB in flight per SM. Narrow column tiles keep many
//   blocks per channel group, so the final reduction of each tile stays
//   short.
// - Stage 1 reduces without float atomics, so equal inputs give equal bits:
//   each block sums its row lanes in a fixed order in shared memory and
//   writes one partial per (chunk, channel); the last block of a column tile
//   to finish (an integer ticket) sums the chunks' partials in a fixed order
//   and applies rstd, which saves a second launch. The ticket counters
//   reset themselves, so launches that share them must run in order (one
//   stream per device).
// - Stage 2 computes its per-channel coefficients (μ, rstd, γ·rstd, dβ/M,
//   dγ/M) once per block into shared memory, keeps its thread's in
//   registers, and writes dx with 16-byte stores.
// - Scalar variants, for C not a multiple of the vector width or operands
//   that are not 16-byte aligned: stage 1 is the first port's kernel (a
//   block of 32 channels, one per lane, by 8 warps, then a second launch
//   over the chunks); stage 2 one element per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bn_common.cuh"

namespace {

using namespace virtex_bn;

constexpr int kUnroll = 4;     // rows of loads a thread keeps in flight

__device__ __forceinline__ void store_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// Stage 1, vector variant.

template <typename VDY, typename VX, int VEC>
__device__ __forceinline__ void accumulate(const typename VDY::Raw& g,
                                           const typename VX::Raw& xr,
                                           const float (&mu)[VEC],
                                           float (&db)[VEC], float (&dg)[VEC]) {
  float gf[VEC], xf[VEC];
  VDY::unpack(g, gf);
  VX::unpack(xr, xf);
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    db[v] += gf[v];
    dg[v] = fmaf(gf[v], xf[v] - mu[v], dg[v]);
  }
}

template <typename TDY, typename TX, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    bn_sums_vec(const TDY* __restrict__ dy, const TX* __restrict__ x,
                const float* __restrict__ mean, const float* __restrict__ rstd,
                float* __restrict__ partial, unsigned* __restrict__ tickets,
                float* __restrict__ out, long long M, int C,
                long long rows_per_chunk) {
  using VDY = Vec<TDY, VEC>;
  using VX = Vec<TX, VEC>;
  // Row-lane sums of the block, then the last block's chunk sums.
  __shared__ float4 s_buf[2 * kThreads * VEC / 4];
  __shared__ bool s_last;
  float* s_db = reinterpret_cast<float*>(s_buf);
  float* s_dg = s_db + kThreads * VEC;
  const Tile t = tile_of<VEC>(C);

  float db[VEC], dg[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) db[v] = dg[v] = 0.f;
  if (t.active) {
    float mu[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) mu[v] = mean[t.c0 + v];
    long long r0, r1;
    chunk_rows(M, rows_per_chunk, &r0, &r1);
    // Rows r, r + rpb, ... in order; up to kUnroll of them loaded at once.
    for (long long r = r0 + t.lane; r < r1; r += kUnroll * t.rpb) {
      typename VDY::Raw g[kUnroll];
      typename VX::Raw xr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = r + u * t.rpb;
        if (row < r1) {
          g[u] = load_vec<VDY>(dy + row * C + t.c0);
          xr[u] = load_vec<VX>(x + row * C + t.c0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * t.rpb < r1)
          accumulate<VDY, VX, VEC>(g[u], xr[u], mu, db, dg);
    }
  }

  // The block's row lanes, summed per channel in lane order.
  if (t.lane < t.rpb) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      s_db[t.lane * t.nch + t.col * VEC + v] = db[v];
      s_dg[t.lane * t.nch + t.col * VEC + v] = dg[v];
    }
  }
  __syncthreads();
  float* p = partial + static_cast<size_t>(blockIdx.y) * 2 * C + t.tile_c0;
  for (int j = threadIdx.x; j < 2 * t.tile_n; j += kThreads) {
    const int which = j / t.tile_n;
    const int k = j - which * t.tile_n;
    const float* src = (which ? s_dg : s_db) + k;
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
  // summed in order.
  const int q = t.tile_n / 4;  // float4s of one sum over the tile
  const int width = 2 * q;     // dβ's, then dγ's
  const int groups = kThreads / width;
  const int col4 = threadIdx.x % width;
  const int group = threadIdx.x / width;
  const int which = col4 / q;
  const int k4 = col4 - which * q;
  if (group < groups) {
    const float4* src = reinterpret_cast<const float4*>(
                            partial + static_cast<size_t>(which) * C +
                            t.tile_c0) + k4;
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
    const int c = t.tile_c0 + 4 * k4;
    if (which == 0) {
      *reinterpret_cast<float4*>(out + c) = acc;
    } else {
      *reinterpret_cast<float4*>(out + C + c) =
          make_float4(acc.x * rstd[c], acc.y * rstd[c + 1],
                      acc.z * rstd[c + 2], acc.w * rstd[c + 3]);
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;  // for the next launch
}

// ---------------------------------------------------------------------------
// Stage 1, scalar variant (two launches).

template <typename TDY, typename TX>
__global__ void __launch_bounds__(kCols * kRows)
    bn_sums_partial(const TDY* __restrict__ dy, const TX* __restrict__ x,
                    const float* __restrict__ mean,
                    float* __restrict__ partial, long long M, int C,
                    long long rows_per_chunk) {
  __shared__ float s_db[kRows][kCols];
  __shared__ float s_dg[kRows][kCols];
  const int c = blockIdx.x * kCols + threadIdx.x;
  long long r0, r1;
  chunk_rows(M, rows_per_chunk, &r0, &r1);
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

// ---------------------------------------------------------------------------
// Stage 2.

// The per-element formula of the header, in fp32.
__device__ __forceinline__ float dx_of(float g, float xv, float mu, float rs,
                                       float gr, float dbm, float dgm) {
  const float xhat = (xv - mu) * rs;
  return gr * ((g - dbm) - xhat * dgm);
}

// One row's VEC channels of dx, stored as one vector.
template <typename VDY, typename VX, int VEC, typename TX>
__device__ __forceinline__ void dx_row(
    const typename VDY::Raw& g, const typename VX::Raw& xr,
    const float (&mu)[VEC], const float (&rs)[VEC], const float (&gr)[VEC],
    const float (&dbm)[VEC], const float (&dgm)[VEC], TX* p) {
  float gf[VEC], xf[VEC], o[VEC];
  VDY::unpack(g, gf);
  VX::unpack(xr, xf);
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    o[v] = dx_of(gf[v], xf[v], mu[v], rs[v], gr[v], dbm[v], dgm[v]);
  *reinterpret_cast<typename VX::Raw*>(p) = VX::pack(o);
}

template <typename TDY, typename TX, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    bn_dx_vec(const TDY* __restrict__ dy, const TX* __restrict__ x,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ weight, const float* __restrict__ sums,
              TX* __restrict__ dx, long long M, int C, float inv_m,
              long long rows_per_chunk) {
  using VDY = Vec<TDY, VEC>;
  using VX = Vec<TX, VEC>;
  // μ, rstd, γ·rstd, dβ/M, dγ/M of the tile's channels.
  __shared__ float s_coef[5][kTileCols * VEC];
  const Tile t = tile_of<VEC>(C);
  for (int j = threadIdx.x; j < t.tile_n; j += kThreads) {
    const int c = t.tile_c0 + j;
    const float rs = rstd[c];
    s_coef[0][j] = mean[c];
    s_coef[1][j] = rs;
    s_coef[2][j] = weight[c] * rs;
    s_coef[3][j] = sums[c] * inv_m;
    s_coef[4][j] = sums[C + c] * inv_m;
  }
  __syncthreads();
  if (!t.active) return;
  float mu[VEC], rs[VEC], gr[VEC], dbm[VEC], dgm[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int j = t.col * VEC + v;
    mu[v] = s_coef[0][j];
    rs[v] = s_coef[1][j];
    gr[v] = s_coef[2][j];
    dbm[v] = s_coef[3][j];
    dgm[v] = s_coef[4][j];
  }
  long long r0, r1;
  chunk_rows(M, rows_per_chunk, &r0, &r1);
  for (long long r = r0 + t.lane; r < r1; r += kUnroll * t.rpb) {
    typename VDY::Raw g[kUnroll];
    typename VX::Raw xr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * t.rpb;
      if (row < r1) {
        g[u] = load_vec<VDY>(dy + row * C + t.c0);
        xr[u] = load_vec<VX>(x + row * C + t.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * t.rpb;
      if (row < r1)
        dx_row<VDY, VX, VEC>(g[u], xr[u], mu, rs, gr, dbm, dgm,
                             dx + row * C + t.c0);
    }
  }
}

template <typename TDY, typename TX>
__global__ void __launch_bounds__(kThreads)
    bn_dx_scalar(const TDY* __restrict__ dy, const TX* __restrict__ x,
                 const float* __restrict__ mean,
                 const float* __restrict__ rstd,
                 const float* __restrict__ weight,
                 const float* __restrict__ sums, TX* __restrict__ dx,
                 long long n, int C, float inv_m) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += step) {
    const int c = static_cast<int>(i % C);
    const float rs = rstd[c];
    store_f32(dx_of(to_f32(dy[i]), to_f32(x[i]), mean[c], rs, weight[c] * rs,
                    sums[c] * inv_m, sums[C + c] * inv_m),
              dx + i);
  }
}

// ---------------------------------------------------------------------------
// Host side.

// Whether the vector variants take these operands (else the launch is
// refused): the wrapper's variant rule, k4_vector_width.
template <typename TDY, typename TX>
bool vector_ok(int vec, int C, const void* dy, const void* x,
               const void* extra) {
  return vec == vec_width<TDY, TX>() && C % vec == 0 && aligned16(dy) &&
         aligned16(x) && aligned16(extra);
}

template <typename TDY, typename TX>
int sums_typed(const void* dy, const void* x, const float* mean,
               const float* rstd, float* partial, void* tickets, float* out,
               long long M, int C, int chunks, int vec, cudaStream_t s) {
  const TDY* g = static_cast<const TDY*>(dy);
  const TX* xv = static_cast<const TX*>(x);
  const long long rows_per_chunk = (M + chunks - 1) / chunks;
  if (vec == 1) {
    const dim3 grid((C + kCols - 1) / kCols, chunks);
    bn_sums_partial<TDY, TX><<<grid, dim3(kCols, kRows), 0, s>>>(
        g, xv, mean, partial, M, C, rows_per_chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bn_sums_final<<<(C + 255) / 256, 256, 0, s>>>(partial, rstd, out, C,
                                                  chunks);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int V = vec_width<TDY, TX>();
  if (!vector_ok<TDY, TX>(vec, C, dy, x, partial) || tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tile_columns(C, V), chunks);
  bn_sums_vec<TDY, TX, V><<<grid, kThreads, 0, s>>>(
      g, xv, mean, rstd, partial, static_cast<unsigned*>(tickets), out, M, C,
      rows_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename TDY, typename TX>
int dx_typed(const void* dy, const void* x, const float* mean,
             const float* rstd, const float* weight, const float* sums,
             void* dx, long long M, int C, long long m_total, int chunks,
             int vec, cudaStream_t s) {
  const TDY* g = static_cast<const TDY*>(dy);
  const TX* xv = static_cast<const TX*>(x);
  TX* out = static_cast<TX*>(dx);
  const float inv_m = 1.0f / static_cast<float>(m_total);
  if (vec == 1) {
    const long long n = M * C;
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
    bn_dx_scalar<TDY, TX><<<blocks, kThreads, 0, s>>>(
        g, xv, mean, rstd, weight, sums, out, n, C, inv_m);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int V = vec_width<TDY, TX>();
  if (!vector_ok<TDY, TX>(vec, C, dy, x, dx))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tile_columns(C, V), chunks);
  bn_dx_vec<TDY, TX, V><<<grid, kThreads, 0, s>>>(
      g, xv, mean, rstd, weight, sums, out, M, C, inv_m,
      (M + chunks - 1) / chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dy and x: row-major (M, C); mean, rstd: (C,) fp32; partial: (chunks, 2,
// C) fp32 scratch; tickets: at least as many zeroed uint32 as column tiles
// (vector variant; left zeroed); out: (2, C) fp32. vec: 1 for the scalar
// variant, else the vector width of the operands' types. chunks is at most
// 65535 and leaves no chunk empty. Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for operands the
// vector variant cannot read.
int virtex_bn_backward_sums(const void* dy, const void* x, const void* mean,
                            const void* rstd, void* partial, void* tickets,
                            void* out, long long M, int C, int chunks,
                            int vec, int dy_is_bf16, int x_is_bf16,
                            void* stream) {
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dy_is_bf16 && x_is_bf16)
    return sums_typed<bf16, bf16>(dy, x, mu, rs, part, tickets, o, M, C,
                                  chunks, vec, s);
  if (dy_is_bf16)
    return sums_typed<bf16, float>(dy, x, mu, rs, part, tickets, o, M, C,
                                   chunks, vec, s);
  if (x_is_bf16)
    return sums_typed<float, bf16>(dy, x, mu, rs, part, tickets, o, M, C,
                                   chunks, vec, s);
  return sums_typed<float, float>(dy, x, mu, rs, part, tickets, o, M, C,
                                  chunks, vec, s);
}

// dy and x: row-major (M, C); mean, rstd, weight: (C,) fp32; sums: (2, C)
// fp32 from virtex_bn_backward_sums; dx: row-major (M, C) of x's type.
// m_total: the count the sums and statistics run over, M itself on one
// device, the global batch's count under data parallelism (sums reduced
// over the ranks). vec and chunks as there (the scalar variant does not
// read chunks).
int virtex_bn_backward_dx(const void* dy, const void* x, const void* mean,
                          const void* rstd, const void* weight,
                          const void* sums, void* dx, long long M, int C,
                          long long m_total, int chunks, int vec,
                          int dy_is_bf16, int x_is_bf16, void* stream) {
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  const float* w = static_cast<const float*>(weight);
  const float* sm = static_cast<const float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dy_is_bf16 && x_is_bf16)
    return dx_typed<bf16, bf16>(dy, x, mu, rs, w, sm, dx, M, C, m_total,
                                chunks, vec, s);
  if (dy_is_bf16)
    return dx_typed<bf16, float>(dy, x, mu, rs, w, sm, dx, M, C, m_total,
                                 chunks, vec, s);
  if (x_is_bf16)
    return dx_typed<float, bf16>(dy, x, mu, rs, w, sm, dx, M, C, m_total,
                                 chunks, vec, s);
  return dx_typed<float, float>(dy, x, mu, rs, w, sm, dx, M, C, m_total,
                                chunks, vec, s);
}

}  // extern "C"
