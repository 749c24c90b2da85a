// K2: fused scaled-dot-product attention backward for Hopper (sm_90a).
//
// Replaces virtex_tpu/ops/attention.py::_bwd_kernel (the Pallas TPU kernel
// reached through _fused_bwd, the custom VJP of fused_attention). Given the
// forward's operands and the output gradient g, per batch element b and
// head h it recomputes
//   S = Q K^T * scale, S = -1e9 where the mask is False, P = softmax(S),
// regenerates K1's dropout keep mask from the same seed, and computes, all
// in fp32,
//   Pd = keep * P / (1 - rate),            dV = Pd^T g,
//   dP = keep * (g V^T) / (1 - rate),
//   dS = P * (dP - sum_k dP * P), 0 where the mask is False, times scale,
//   dQ = dS K,                             dK = dS^T Q,
// storing dQ, dK, dV in the operands' dtype. Layouts as in K1: q and g
// (B, Tq, N, D), k and v (B, Tk, N, D), each with unit stride along D and
// any strides along B, T and N; mask (B, 1|N, Tq, Tk) bool by strides (a
// stride of 0 broadcasts, a null pointer means all True); dq (B, Tq, N, D)
// and dk, dv (B, Tk, N, D) contiguous.
//
// What bounds it: as K1, latency and the block's own inner loops, not FLOPs
// or bytes. At the train step's shapes (Tq = 30, Tk = 30 or 49, D = 64) one
// (b, h) pair is ~1 MFLOP over ~30 KB of operands; a call at batch 128 is
// ~2 GFLOP and ~40 MB. The design is K1's: one block per (b, h) holds Q, g,
// K and V whole in shared memory as fp32 (rows padded by one word so lanes
// walking different rows hit different banks). One warp per query row
// recomputes its logits and softmax, computes g V^T, dS and that row of dQ;
// P and dS never leave shared memory. After a block barrier, each thread
// owns (key, d) entries of dK and dV and sums over the query rows. At the
// cross shape the block needs ~53 KB of shared memory, over the 48 KB a
// launch gets without opting in, so the launcher raises the kernel's limit
// with cudaFuncSetAttribute. Tensor cores (mma.sync / wgmma), several heads
// per block and a packed dqkv output are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "philox.cuh"

namespace {

using namespace virtex;

constexpr int kWarps = 4;

size_t smem_bytes(int Tq, int Tk, int D) {
  const size_t row = static_cast<size_t>(D) + 1;
  const size_t tq = Tq, tk = Tk;
  return sizeof(float) *
         (2 * tq * row + 2 * tk * row + 2 * tq * tk + kWarps * tk);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         const T* __restrict__ g, T* __restrict__ dq,
                         T* __restrict__ dk, T* __restrict__ dv, int N, int Tq,
                         int Tk, int D, Strides sq, Strides sk, Strides sv,
                         Strides sg, MaskStrides sm, float scale, float rate,
                         uint32_t threshold, uint32_t seed) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / N;
  const int h = blockIdx.x - b * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = D + 1;  // padded: conflict-free walks across rows
  float* q_s = smem;                                    // Tq x (D + 1)
  float* g_s = q_s + static_cast<size_t>(Tq) * row;     // Tq x (D + 1)
  float* k_s = g_s + static_cast<size_t>(Tq) * row;     // Tk x (D + 1)
  float* v_s = k_s + static_cast<size_t>(Tk) * row;     // Tk x (D + 1)
  float* ds_s = v_s + static_cast<size_t>(Tk) * row;    // Tq x Tk: P, then dS
  float* pd_s = ds_s + static_cast<size_t>(Tq) * Tk;    // Tq x Tk: dropped P
  float* dp_w = pd_s + static_cast<size_t>(Tq) * Tk + warp * Tk;  // dP row

  const T* qb = q + b * sq.b + h * sq.n;
  const T* gb = g + b * sg.b + h * sg.n;
  const T* kb = k + b * sk.b + h * sk.n;
  const T* vb = v + b * sv.b + h * sv.n;
  for (int e = threadIdx.x; e < Tq * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D;
    q_s[i * row + d] = to_f32(qb[i * sq.t + d]);
    g_s[i * row + d] = to_f32(gb[i * sg.t + d]);
  }
  for (int e = threadIdx.x; e < Tk * D; e += blockDim.x) {
    const int j = e / D, d = e - j * D;
    k_s[j * row + d] = to_f32(kb[j * sk.t + d]);
    v_s[j * row + d] = to_f32(vb[j * sv.t + d]);
  }
  __syncthreads();

  const bool dropout = rate > 0.f;
  const float inv_keep = 1.f / (1.f - rate);
  for (int i = warp; i < Tq; i += kWarps) {
    const float* qi = q_s + i * row;
    const float* gi = g_s + i * row;
    float* p_row = ds_s + static_cast<size_t>(i) * Tk;
    float* pd_row = pd_s + static_cast<size_t>(i) * Tk;
    const uint8_t* mi =
        mask == nullptr ? nullptr : mask + b * sm.b + h * sm.h + i * sm.q;

    float row_max = -INFINITY;
    for (int j = lane; j < Tk; j += 32) {
      const float* kj = k_s + j * row;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
      s *= scale;
      if (mi != nullptr && !mi[j * sm.k]) s = kMaskedLogit;
      p_row[j] = s;
      row_max = fmaxf(row_max, s);
    }
    row_max = warp_max(row_max);

    float row_sum = 0.f;
    for (int j = lane; j < Tk; j += 32) {
      const float e = expf(p_row[j] - row_max);
      p_row[j] = e;
      row_sum += e;
    }
    row_sum = warp_sum(row_sum);

    float dp_dot_p = 0.f;  // this lane's part of sum_k dP * P
    for (int j = lane; j < Tk; j += 32) {
      const float p = p_row[j] / row_sum;
      const float* vj = v_s + j * row;
      float dpd = 0.f;
      for (int d = 0; d < D; ++d) dpd = fmaf(gi[d], vj[d], dpd);
      float pd = p, dp = dpd;
      if (dropout) {
        const bool keep =
            attention_dropout_keep(seed, b, h, i, j, threshold);
        pd = keep ? p * inv_keep : 0.f;
        dp = keep ? dpd * inv_keep : 0.f;
      }
      p_row[j] = p;
      pd_row[j] = pd;
      dp_w[j] = dp;
      dp_dot_p = fmaf(dp, p, dp_dot_p);
    }
    dp_dot_p = warp_sum(dp_dot_p);

    for (int j = lane; j < Tk; j += 32) {  // each lane rewrites its own j
      float ds = p_row[j] * (dp_w[j] - dp_dot_p);
      if (mi != nullptr && !mi[j * sm.k]) ds = 0.f;
      p_row[j] = ds * scale;
    }
    __syncwarp();

    T* dqi = dq + ((static_cast<long long>(b) * Tq + i) * N + h) * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Tk; ++j) acc = fmaf(p_row[j], k_s[j * row + d], acc);
      dqi[d] = from_f32<T>(acc);
    }
    __syncwarp();  // dp_w is rewritten by the next row
  }
  __syncthreads();

  for (int e = threadIdx.x; e < Tk * D; e += blockDim.x) {
    const int j = e / D, d = e - j * D;
    float acc_k = 0.f, acc_v = 0.f;
    for (int i = 0; i < Tq; ++i) {
      acc_k = fmaf(ds_s[i * Tk + j], q_s[i * row + d], acc_k);
      acc_v = fmaf(pd_s[i * Tk + j], g_s[i * row + d], acc_v);
    }
    const long long o = ((static_cast<long long>(b) * Tk + j) * N + h) * D + d;
    dk[o] = from_f32<T>(acc_k);
    dv[o] = from_f32<T>(acc_v);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* g, void* dq, void* dk, void* dv, int B, int Tq, int Tk,
           int N, int D, Strides sq, Strides sk, Strides sv, Strides sg,
           MaskStrides sm, float scale, float rate, uint32_t threshold,
           uint32_t seed, cudaStream_t stream) {
  const size_t smem = smem_bytes(Tq, Tk, D);
  // Above 48 KB a kernel must opt in; once per size reached, so a launch
  // inside a CUDA-graph capture makes no attribute call.
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  attention_bwd_kernel<T><<<B * N, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), N, Tq, Tk, D, sq, sk, sv, sg, sm, scale, rate,
      threshold, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). is_bf16
// selects bf16 operands and gradients; otherwise fp32.
int virtex_attention_bwd(const void* q, const void* k, const void* v,
                         const void* mask, const void* g, void* dq, void* dk,
                         void* dv, int B, int Tq, int Tk, int N, int D,
                         int is_bf16, long long q_sb, long long q_st,
                         long long q_sn, long long k_sb, long long k_st,
                         long long k_sn, long long v_sb, long long v_st,
                         long long v_sn, long long g_sb, long long g_st,
                         long long g_sn, long long m_sb, long long m_sh,
                         long long m_sq, long long m_sk, float scale,
                         float rate, unsigned int threshold, unsigned int seed,
                         void* stream) {
  const virtex::Strides sq{q_sb, q_st, q_sn}, sk{k_sb, k_st, k_sn},
      sv{v_sb, v_st, v_sn}, sg{g_sb, g_st, g_sn};
  const virtex::MaskStrides sm{m_sb, m_sh, m_sq, m_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, g, dq, dk, dv, B, Tq, Tk, N,
                                 D, sq, sk, sv, sg, sm, scale, rate, threshold,
                                 seed, s);
  return launch<float>(q, k, v, mask, g, dq, dk, dv, B, Tq, Tk, N, D, sq, sk,
                       sv, sg, sm, scale, rate, threshold, seed, s);
}

// Bytes of dynamic shared memory one block needs at (Tq, Tk, D).
unsigned long long virtex_attention_bwd_smem_bytes(int Tq, int Tk, int D) {
  return smem_bytes(Tq, Tk, D);
}

}  // extern "C"
