// K1: fused scaled-dot-product attention forward for Hopper (sm_90a).
//
// Replaces virtex_tpu/ops/attention.py::_fwd_kernel (the Pallas TPU kernel
// reached through _call_fwd / fused_attention). Per batch element b and
// head h it computes
//   S = Q K^T * scale (fp32), S = -1e9 where the bool mask is False,
//   P = softmax(S) in fp32, optional dropout (keep iff u >= rate, scaled by
//   1 / (1 - rate)), P cast to V's dtype, O = P V accumulated in fp32,
//   O stored in Q's dtype.
// Layouts: q (B, Tq, N, D), k and v (B, Tk, N, D), each with unit stride
// along D and any strides along B, T and N (so the packed q/k/v projection
// is read in place); mask (B, 1|N, Tq, Tk) bool by strides, a stride of 0
// broadcasting, a null pointer meaning all True; out (B, Tq, N, D)
// contiguous.
//
// What bounds it: at the model's shapes (Tq = 30, Tk = 30 or 49, D = 64)
// one (b, h) pair is ~0.4 MFLOP over ~20 KB of operands. A whole call at
// batch 32 (512 pairs) is ~0.2 GFLOP and ~10 MB: a few microseconds at the
// card's fp32 FMA rate or its memory bandwidth, the same order as a kernel
// launch. So the kernel is bound by launch and latency, not by FLOPs or
// bytes: the tiles are far too small for tensor cores to pay, and what
// matters is that one launch does the whole call with no round trip of
// the (N, Tq, Tk) probabilities through device memory. The design keeps
// to that: one block per (b, h) holds K and V whole in shared memory
// (fp32, K rows padded by one word so that lanes walking different keys
// hit different banks), one warp per query row computes its logits, takes
// max and sum with warp shuffles and writes the output row, and the
// probabilities never leave shared memory. At batch 32 the B * N blocks of
// four warps fit in one wave on the 132 SMs. Inside a block the scalar
// loops execute two shared-memory loads per FMA, which is where the time
// goes now; vector loads, several rows per warp, mma.sync or wgmma and
// multi-head blocks are later work.
//
// Dropout draws from the stateless Philox4x32-10 in philox.cuh, keyed on
// (seed, b) and counted on (head, q, k), so the backward kernel can
// regenerate the same mask. It does not reproduce the TPU's bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "philox.cuh"

namespace {

using namespace virtex;

constexpr int kWarps = 4;

size_t smem_bytes(int Tk, int D) {
  return sizeof(float) *
         (static_cast<size_t>(Tk) * (D + 1) + static_cast<size_t>(Tk) * D +
          static_cast<size_t>(kWarps) * (D + Tk));
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         T* __restrict__ out, int N, int Tq, int Tk, int D,
                         Strides sq, Strides sk, Strides sv, MaskStrides sm,
                         float scale, float rate, uint32_t threshold,
                         uint32_t seed) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / N;
  const int h = blockIdx.x - b * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k_row = D + 1;  // padded: conflict-free column walks
  float* k_s = smem;                              // Tk x (D + 1)
  float* v_s = k_s + static_cast<size_t>(Tk) * k_row;   // Tk x D
  float* q_w = v_s + static_cast<size_t>(Tk) * D + warp * (D + Tk);
  float* p_w = q_w + D;                           // this warp's S / P row

  const T* kb = k + b * sk.b + h * sk.n;
  const T* vb = v + b * sv.b + h * sv.n;
  for (int e = threadIdx.x; e < Tk * D; e += blockDim.x) {
    const int j = e / D, d = e - j * D;
    k_s[j * k_row + d] = to_f32(kb[j * sk.t + d]);
    v_s[j * D + d] = to_f32(vb[j * sv.t + d]);
  }
  __syncthreads();

  const bool dropout = rate > 0.f;
  const float keep_div = 1.f - rate;
  for (int i = warp; i < Tq; i += kWarps) {
    const T* qi = q + b * sq.b + i * sq.t + h * sq.n;
    for (int d = lane; d < D; d += 32) q_w[d] = to_f32(qi[d]);
    __syncwarp();

    const uint8_t* mi =
        mask == nullptr ? nullptr : mask + b * sm.b + h * sm.h + i * sm.q;
    float row_max = -INFINITY;
    for (int j = lane; j < Tk; j += 32) {
      const float* kj = k_s + j * k_row;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(q_w[d], kj[d], s);
      s *= scale;
      if (mi != nullptr && !mi[j * sm.k]) s = kMaskedLogit;
      p_w[j] = s;
      row_max = fmaxf(row_max, s);
    }
    row_max = warp_max(row_max);

    float row_sum = 0.f;
    for (int j = lane; j < Tk; j += 32) {
      const float e = expf(p_w[j] - row_max);
      p_w[j] = e;
      row_sum += e;
    }
    row_sum = warp_sum(row_sum);

    for (int j = lane; j < Tk; j += 32) {
      float p = p_w[j] / row_sum;
      if (dropout)
        p = virtex::attention_dropout_keep(seed, b, h, i, j, threshold)
                ? p / keep_div
                : 0.f;
      p_w[j] = to_f32(from_f32<T>(p));  // P in V's dtype before P V
    }
    __syncwarp();

    T* oi = out + ((static_cast<long long>(b) * Tq + i) * N + h) * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Tk; ++j) acc = fmaf(p_w[j], v_s[j * D + d], acc);
      oi[d] = from_f32<T>(acc);
    }
    __syncwarp();  // q_w / p_w are rewritten by the next row
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int B, int Tq, int Tk, int N, int D, Strides sq,
           Strides sk, Strides sv, MaskStrides sm, float scale, float rate,
           uint32_t threshold, uint32_t seed, cudaStream_t stream) {
  const size_t smem = smem_bytes(Tk, D);
  // Above 48 KB a kernel must opt in; once per size reached, so a launch
  // inside a CUDA-graph capture makes no attribute call.
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  attention_fwd_kernel<T><<<B * N, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), N, Tq, Tk, D, sq, sk, sv, sm, scale, rate,
      threshold, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). is_bf16
// selects bf16 operands; otherwise fp32.
int virtex_attention_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* out, int B, int Tq, int Tk,
                         int N, int D, int is_bf16, long long q_sb,
                         long long q_st, long long q_sn, long long k_sb,
                         long long k_st, long long k_sn, long long v_sb,
                         long long v_st, long long v_sn, long long m_sb,
                         long long m_sh, long long m_sq, long long m_sk,
                         float scale, float rate, unsigned int threshold,
                         unsigned int seed, void* stream) {
  const virtex::Strides sq{q_sb, q_st, q_sn}, sk{k_sb, k_st, k_sn},
      sv{v_sb, v_st, v_sn};
  const virtex::MaskStrides sm{m_sb, m_sh, m_sq, m_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, B, Tq, Tk, N, D, sq, sk,
                                 sv, sm, scale, rate, threshold, seed, s);
  return launch<float>(q, k, v, mask, out, B, Tq, Tk, N, D, sq, sk, sv, sm,
                       scale, rate, threshold, seed, s);
}

// Bytes of dynamic shared memory one block needs at (Tk, D).
unsigned long long virtex_attention_fwd_smem_bytes(int Tk, int D) {
  return smem_bytes(Tk, D);
}

const char* virtex_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
