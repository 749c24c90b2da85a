// Decode attention for Hopper (sm_90a): one new query token per row
// against a K/V cache, read where it lies, in bf16.
//
// Replaces no TPU kernel: the JAX package's decode step
// (virtex_tpu/modules/transformer.py, decode_self and attend_kv) is plain
// einsum attention that XLA fuses. Eager PyTorch does not fuse it: the
// plain path widened q and both caches to fp32, permuted the copies for a
// batched GEMV and read all Tmax self positions under a mask, and the
// caption loop tiled each image's cross K/V to its beams. Per query row r
// and head h this kernel computes, over the positions j < n_valid of K/V
// row b = r / rows_per_kv,
//   s_j = (q · k_j) / sqrt(D)                fp32 from the bf16 operands
//   p_j = rnd(exp(s_j − max s) / Σ exp(s − max s))    fp32, rnd to bf16
//   out = rnd(Σ_j p_j v_j)                   fp32 sum, rnd to bf16,
// which is ops/decode_attention.py's plain version operation for
// operation (positions it does not read stand for the plain version's
// −1e9 logits, whose probabilities underflow to exactly 0) except for the
// order of the sums.
// Layouts: q (R, 1, N, D) by (row, head) strides; k and v (rows, Tk, N, D)
// by (row, position, head) strides, all with unit stride along D and
// 16-byte aligned (the wrapper copies an operand that is not); out
// (R, 1, N, D) contiguous.
//
// What bounds it: bytes. A query does 4·D FLOPs per position against the
// 4·D bytes of that position's K and V, ~1 FLOP a byte, far below the
// card's ~20 (fp32) or ~295 (bf16 tensor cores). The floor is one read of
// q, of the valid K/V positions of every K/V row and one write of out. The
// design:
// - One warp per (K/V row, head) pair, which serves every query row of
//   that K/V row (an image's beams in cross-attention) from the same loads,
//   so each K/V position is read once per image and not once per beam. A
//   block is four independent warps (no block barrier).
// - A lane reads 16 bytes (8 bf16) of one position: D / 8 lanes cover a
//   position, so a warp reads 32 / (D / 8) positions with each load
//   instruction, every group of lanes one whole 128-byte line at D 64, and
//   keeps kUnroll such loads in flight. The dot products reduce over the
//   D / 8 lanes by shuffles; the logits go to shared memory, where the
//   warp's softmax reads them lane-strided; P · V accumulates in registers,
//   8 dims by query per lane, and reduces over the position groups by
//   shuffles before one 16-byte store per lane of the first group.
// - Only the valid positions are read: the self cache's first
//   position + 1, never its masked tail.
// - Two query widths: one row per K/V row (self-attention, nucleus
//   sampling) keeps 8 fp32 of q per lane; up to kQ rows (the beams) keep
//   8·kQ, and more rows are taken kQ at a time.
// Measured (H100 SXM, 700 W; 1280 query rows, 32 heads of 64): the self
// launch at 30 valid positions at 88% of its bytes bound and at 1 at 16%
// (three dependent loads a warp, latency rather than bytes); the cross
// launch, 5 rows per K/V row over 49 positions, at ~41%, bound by the
// warps' latency (its per-warp work is five queries' dot products and
// softmax) rather than by its 113 MB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_common.cuh"

namespace {

constexpr int kWarps = 4;    // warps per block, one (K/V row, head) each
constexpr int kQ = 8;        // query rows a warp serves per pass over K/V
constexpr int kUnroll = 8;   // 16-byte loads a lane keeps in flight

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  long long q_sr, q_sn;          // q strides (row, head), in elements
  long long k_sr, k_st, k_sn;    // k strides (row, position, head)
  long long v_sr, v_st, v_sn;
  int kv_rows, rows_per_kv, n_valid, N;
  float sqrt_d;
};

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// kUnroll loads of one lane, 16 bytes at positions j, j + P, j + 2P, ...
// (zeros at and past n).
template <int P>
__device__ __forceinline__ void load_positions(uint4 (&out)[kUnroll],
                                               const __nv_bfloat16* p,
                                               long long stride, int j,
                                               int n) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u, j += P)
    out[u] = j < n ? load16(p + j * stride) : make_uint4(0, 0, 0, 0);
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

// Q: the most query rows a warp serves per pass (1 or kQ). The register
// caps (80 and 128 a thread: 6 and 4 blocks an SM) keep more warps in
// flight; uncapped, the kQ width took 162 registers, three blocks an SM,
// and its cross-attention launch 104 µs against 82 at the cap, with no
// spill (H100, 1280 query rows, 32 heads, 49 positions).
template <int D, int Q>
__global__ void __launch_bounds__(kWarps * 32, Q == 1 ? 6 : 4)
decode_attention_kernel(const Args a) {
  constexpr int kLanes = D / 8;        // lanes over one position's D
  constexpr int kPos = 32 / kLanes;    // positions one load instruction reads
  constexpr int kStep = kPos * kUnroll;
  extern __shared__ float logits[];    // per warp: min(rows_per_kv, Q) × n
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane / kLanes, sub = lane % kLanes;
  const long long pair = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (pair >= static_cast<long long>(a.kv_rows) * a.N) return;
  const int row = static_cast<int>(pair / a.N);
  const int head = static_cast<int>(pair % a.N);
  const int n = a.n_valid;
  const int per_pass = min(a.rows_per_kv, Q);
  float* s = logits + static_cast<size_t>(warp) * per_pass * n;
  const __nv_bfloat16* kp = a.k + row * a.k_sr + head * a.k_sn + sub * 8;
  const __nv_bfloat16* vp = a.v + row * a.v_sr + head * a.v_sn + sub * 8;

  for (int i0 = 0; i0 < a.rows_per_kv; i0 += Q) {
    const int nq = min(Q, a.rows_per_kv - i0);
    const long long r0 = static_cast<long long>(row) * a.rows_per_kv + i0;
    float qf[Q][8];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      if (i < nq) {
        widen(load16(a.q + (r0 + i) * a.q_sr + head * a.q_sn + sub * 8),
              qf[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qf[i][e] = 0.f;
      }
    }

    // q · k_j, into shared memory.
    for (int j0 = 0; j0 < n; j0 += kStep) {
      uint4 kv[kUnroll];
      load_positions<kPos>(kv, kp, a.k_st, j0 + group, n);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u * kPos >= n) break;  // warp-uniform
        const int j = j0 + u * kPos + group;
        float kf[8];
        widen(kv[u], kf);
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          if (i >= nq) break;  // warp-uniform
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qf[i][e], kf[e], dot);
#pragma unroll
          for (int off = kLanes / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (sub == 0 && j < n) s[i * n + j] = dot;
        }
      }
    }
    // V's first positions in flight while the softmax runs.
    uint4 vv[kUnroll];
    load_positions<kPos>(vv, vp, a.v_st, group, n);
    __syncwarp();

    // s_j = q · k_j / sqrt(D); p_j = rnd(exp(s_j − max) / Σ exp(s − max)),
    // in place, the query rows side by side.
    float m[Q], sum[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) m[i] = -INFINITY, sum[i] = 0.f;
    for (int j = lane; j < n; j += 32) {
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        if (i >= nq) break;
        const float x = s[i * n + j] / a.sqrt_d;
        s[i * n + j] = x;
        m[i] = fmaxf(m[i], x);
      }
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) m[i] = warp_max(m[i]);
    for (int j = lane; j < n; j += 32) {
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        if (i >= nq) break;
        const float e = expf(s[i * n + j] - m[i]);
        s[i * n + j] = e;
        sum[i] += e;
      }
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) sum[i] = warp_sum(sum[i]);
    for (int j = lane; j < n; j += 32) {
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        if (i >= nq) break;
        s[i * n + j] =
            __bfloat162float(__float2bfloat16_rn(s[i * n + j] / sum[i]));
      }
    }
    __syncwarp();

    // out = Σ_j p_j v_j in fp32.
    float acc[Q][8];
#pragma unroll
    for (int i = 0; i < Q; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
    for (int j0 = 0; j0 < n; j0 += kStep) {
      if (j0 > 0) load_positions<kPos>(vv, vp, a.v_st, j0 + group, n);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kPos + group;
        if (j0 + u * kPos >= n) break;  // warp-uniform
        float vf[8];
        widen(vv[u], vf);
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          if (i >= nq) break;
          const float p = j < n ? s[i * n + j] : 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      if (i >= nq) break;
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int off = kLanes; off < 32; off <<= 1)
          acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
      if (group == 0) {
        uint4 packed;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[e] = __floats2bfloat162_rn(acc[i][2 * e], acc[i][2 * e + 1]);
        *reinterpret_cast<uint4*>(
            a.out + ((r0 + i) * a.N + head) * D + sub * 8) = packed;
      }
    }
    __syncwarp();  // the next pass rewrites s
  }
}

size_t smem_bytes(int rows_per_kv, int n_valid) {
  const int per_pass = rows_per_kv < kQ ? rows_per_kv : kQ;
  return static_cast<size_t>(kWarps) * per_pass * n_valid * sizeof(float);
}

template <int D, int Q>
int launch(const Args& a, cudaStream_t stream) {
  const long long pairs = static_cast<long long>(a.kv_rows) * a.N;
  const unsigned blocks = static_cast<unsigned>((pairs + kWarps - 1) / kWarps);
  const size_t smem = smem_bytes(a.rows_per_kv, a.n_valid);
  const cudaError_t err =
      virtex::opt_in_smem(decode_attention_kernel<D, Q>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_kernel<D, Q><<<blocks, kWarps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_width(const Args& a, cudaStream_t stream) {
  return a.rows_per_kv > 1 ? launch<D, kQ>(a, stream)
                           : launch<D, 1>(a, stream);
}

}  // namespace

extern "C" {

// Shared memory one launch asks for: the logits of a pass's query rows,
// per warp.
unsigned long long virtex_decode_attention_smem_bytes(int rows_per_kv,
                                                      int n_valid) {
  return smem_bytes(rows_per_kv, n_valid);
}

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for D outside {8, 16, 32, 64, 128, 256}.
int virtex_decode_attention(const void* q, const void* k, const void* v,
                            void* out, int kv_rows, int rows_per_kv,
                            int n_valid, int N, int D, long long q_sr,
                            long long q_sn, long long k_sr, long long k_st,
                            long long k_sn, long long v_sr, long long v_st,
                            long long v_sn, float sqrt_d, void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<__nv_bfloat16*>(out),
               q_sr, q_sn, k_sr, k_st, k_sn, v_sr, v_st, v_sn,
               kv_rows, rows_per_kv, n_valid, N, sqrt_d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch_width<8>(a, s);
    case 16: return launch_width<16>(a, s);
    case 32: return launch_width<32>(a, s);
    case 64: return launch_width<64>(a, s);
    case 128: return launch_width<128>(a, s);
    case 256: return launch_width<256>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
