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
// and dk, dv (B, Tk, N, D) contiguous. The dropout seed is read from
// device memory.
//
// What bounds it: bytes. At the train step's shapes (Tq = 30, Tk = 30 or
// 49, D = 64) one (b, h) pair is ~1.5 MFLOP over ~27-37 KB of operands and
// gradients, ~40 FLOP per byte, far below the H100's bf16 ridge of ~295. A
// call at batch 128 and 16 heads moves 55.2 MB (self) or 75.0 MB (cross):
// 16.5 or 22.4 us at 3.35 TB/s. The design keeps loads in flight and the
// instruction count per byte low:
//
// - bf16 operands with D a multiple of 16 up to 128 and Tk up to 128 take
//   the tensor-core variant: blocks of two warps, launched once per
//   resident slot, each walking over (b, h) pairs. Q, g, K and V are
//   staged as bf16 with 16-byte cp.async, rows padded by 16 bytes for
//   conflict-free ldmatrix, rows past Tq or Tk zero-filled; Q and g are
//   double-buffered, so the next pair's Q and g load during both phases of
//   this one and its K and V during phase B.
//   Phase A, a warp per 16 query rows: S = Q K^T and dP = g V^T by
//   mma.sync m16n8k16 (bf16 operands, fp32 accumulate: exact products),
//   softmax and dropout on the accumulator fragments, dS and Pd in fp32
//   registers, dQ = dS K at once (K's fragments by ldmatrix.trans), and dS
//   and Pd written once to shared memory. Phase B, a warp per 16 keys:
//   dK = dS^T Q and dV = Pd^T g, whose transposed A fragments come from
//   that copy by ldmatrix.trans. About 55 KB of shared memory at the cross
//   shape, so four blocks share an SM (five at the self shape, 38 KB,
//   where registers bind). Measured by chip_smoke.py on an H100 SXM at
//   700 W (B 128, 16 heads): ~46 us self and ~60 us cross, 35-38% of the
//   byte bound, against 230 and 367 us for the scalar design. With 8-10
//   warps per SM, each running its phase's products and softmax in
//   sequence, latency is what is left.
//   dS and Pd are fp32 in the JAX kernel; a single bf16 rounding would add
//   2^-8 relative error to dQ, dK and dV that it does not have. So each
//   enters its products as a two-term bf16 split (hi = bf16(x),
//   lo = bf16(x - hi)), two mma.sync per tile, which carries x to ~2^-16
//   relative; the rest of the error is fp32 accumulation. On the card
//   (chip_smoke.py) dQ, dK and dV stay within 6.2e-3 of |ref| + 1 of the
//   fp32 plain version at every shape, which is the bf16 rounding of the
//   stored gradients themselves. Padding keys and padding query rows have
//   P = 0 and so add nothing.
// - fp32 operands, and bf16 outside those limits, take the scalar variant:
//   one block per (b, h) holds Q, g, K and V whole in shared memory as
//   fp32 (rows padded by one word), one warp per query row recomputes its
//   logits and softmax, computes g V^T, dS and that row of dQ; after a
//   block barrier each thread owns (key, d) entries of dK and dV and sums
//   over the query rows. ~53 KB of shared memory at the cross shape, opted
//   in with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "launch_common.cuh"
#include "philox.cuh"

namespace {

using namespace virtex;
using bf16 = __nv_bfloat16;

// -- scalar variant -----------------------------------------------------------
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
                         uint32_t threshold,
                         const long long* __restrict__ seed_ptr) {
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
  const uint32_t seed = load_seed(seed_ptr, dropout);
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
           const long long* seed, cudaStream_t stream) {
  const size_t smem = smem_bytes(Tq, Tk, D);
  const cudaError_t err = opt_in_smem(attention_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_kernel<T><<<B * N, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), N, Tq, Tk, D, sq, sk, sv, sg, sm, scale, rate,
      threshold, seed);
  return static_cast<int>(cudaGetLastError());
}

// -- tensor-core variant (bf16, D % 16 == 0, D <= 128, Tk <= 128) ------------
constexpr int kMmaWarps = 2;

size_t mma_smem_bytes(int Tq, int Tk, int D) {
  const size_t tq = round16(Tq), tk = round16(Tk);
  return sizeof(bf16) * ((4 * tq + 2 * tk) * (D + 8) + 4 * tq * (tk + 8));
}

// A fragments of a 16x16 tile of fp32 values held as two accumulator
// n-tiles (lo: columns 0-7, hi: 8-15), split into bf16 hi and lo parts.
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  split_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  split_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  split_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

// The main path's instance (64, 64) is held to 204 registers, so that five
// blocks fit on an SM where shared memory allows (the self shape).
template <int KMAX, int DMAX>
__global__ void __launch_bounds__(kMmaWarps * 32,
                                  KMAX == 64 && DMAX == 64 ? 5 : 1)
    attention_bwd_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const uint8_t* __restrict__ mask,
                             const bf16* __restrict__ g,
                             bf16* __restrict__ dq, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int B, int N, int Tq,
                             int Tk, int D, Strides sq, Strides sk,
                             Strides sv, Strides sg, MaskStrides sm,
                             float scale, float rate, uint32_t threshold,
                             const long long* __restrict__ seed_ptr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq_pad = round16(Tq), tk_pad = round16(Tk);
  const int ld = D + 8, lp = tk_pad + 8;  // row strides: 16 bytes padding
  bf16* qg_s = reinterpret_cast<bf16*>(smem_raw);  // 2 x (Q, g): tq_pad x ld
  bf16* k_s = qg_s + 4 * tq_pad * ld;               // tk_pad x ld
  bf16* v_s = k_s + tk_pad * ld;                    // tk_pad x ld
  bf16* ds_hi = v_s + tk_pad * ld;                  // tq_pad x lp, each
  bf16* ds_lo = ds_hi + tq_pad * lp;
  bf16* pd_hi = ds_lo + tq_pad * lp;
  bf16* pd_lo = pd_hi + tq_pad * lp;

  const int chunks = D / 8;  // 16-byte pieces of a row
  const long long pairs = static_cast<long long>(B) * N;
  // Q and g of pair `pair` into buffer `buf`, K and V into theirs; rows
  // past Tq or Tk zero-filled.
  auto load_qg = [&](long long pair, int buf) {
    if (pair >= pairs) return;
    const int b = static_cast<int>(pair / N), h = static_cast<int>(pair % N);
    const bf16* qb = q + b * sq.b + h * sq.n;
    const bf16* gb = g + b * sg.b + h * sg.n;
    bf16* q_s = qg_s + buf * 2 * tq_pad * ld;
    bf16* g_s = q_s + tq_pad * ld;
    for (int e = threadIdx.x; e < tq_pad * chunks; e += blockDim.x) {
      const int i = e / chunks, c = (e - i * chunks) * 8;
      const bool ok = i < Tq;
      cp_async_16(q_s + i * ld + c, ok ? qb + i * sq.t + c : qb, ok);
      cp_async_16(g_s + i * ld + c, ok ? gb + i * sg.t + c : gb, ok);
    }
  };
  auto load_kv = [&](long long pair) {
    if (pair >= pairs) return;
    const int b = static_cast<int>(pair / N), h = static_cast<int>(pair % N);
    const bf16* kb = k + b * sk.b + h * sk.n;
    const bf16* vb = v + b * sv.b + h * sv.n;
    for (int e = threadIdx.x; e < tk_pad * chunks; e += blockDim.x) {
      const int j = e / chunks, c = (e - j * chunks) * 8;
      const bool ok = j < Tk;
      cp_async_16(k_s + j * ld + c, ok ? kb + j * sk.t + c : kb, ok);
      cp_async_16(v_s + j * ld + c, ok ? vb + j * sv.t + c : vb, ok);
    }
  };

  const bool dropout = rate > 0.f;
  const uint32_t seed = load_seed(seed_ptr, dropout);
  const float inv_keep = 1.f / (1.f - rate);
  const int gr = lane >> 2, t = lane & 3;
  const int nk16 = tk_pad / 16, nd16 = D / 16;
  // ldmatrix lane offsets, as in K1: A and trans-B tiles (a_row, a_col),
  // non-trans B tiles and trans A tiles of a transposed copy (b_row, b_col).
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  int b = 0, h = 0;  // the current pair
  auto masked = [&](int i, int j) {
    return mask != nullptr && i < Tq && j < Tk &&
           !mask[b * sm.b + h * sm.h + i * sm.q + j * sm.k];
  };

  // The block walks over pairs a grid apart. The next pair's Q and g load
  // into the other buffer during this pair's two phases, its K and V
  // during phase B.
  load_qg(blockIdx.x, 0);
  load_kv(blockIdx.x);
  cp_async_commit();
  int buf = 0;
  for (long long pair = blockIdx.x; pair < pairs;
       pair += gridDim.x, buf ^= 1) {
    const long long next = pair + gridDim.x;
    b = static_cast<int>(pair / N);
    h = static_cast<int>(pair % N);
    bf16* q_s = qg_s + buf * 2 * tq_pad * ld;
    bf16* g_s = q_s + tq_pad * ld;
    cp_async_wait_all();
    __syncthreads();  // this pair's operands have landed; the last is done
    load_qg(next, buf ^ 1);
    cp_async_commit();

    // Phase A: a warp per 16 query rows.
    for (int m0 = warp * 16; m0 < tq_pad; m0 += kMmaWarps * 16) {
      float s[KMAX / 8][4], dp[KMAX / 8][4];
#pragma unroll
      for (int nt = 0; nt < KMAX / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      {
        uint32_t qa[DMAX / 16][4];
#pragma unroll
        for (int kk = 0; kk < DMAX / 16; ++kk)
          if (kk < nd16)
            ldmatrix_x4(qa[kk], q_s + (m0 + a_row) * ld + kk * 16 + a_col);
#pragma unroll
        for (int n16 = 0; n16 < KMAX / 16; ++n16) {
          if (n16 >= nk16) break;
#pragma unroll
          for (int kk = 0; kk < DMAX / 16; ++kk) {
            if (kk >= nd16) break;
            uint32_t kf[4];
            ldmatrix_x4(kf, k_s + (n16 * 16 + b_row) * ld + kk * 16 + b_col);
            mma_bf16(s[2 * n16], qa[kk], kf[0], kf[1]);
            mma_bf16(s[2 * n16 + 1], qa[kk], kf[2], kf[3]);
          }
        }
      }
      {
        uint32_t ga[DMAX / 16][4];
#pragma unroll
        for (int kk = 0; kk < DMAX / 16; ++kk)
          if (kk < nd16)
            ldmatrix_x4(ga[kk], g_s + (m0 + a_row) * ld + kk * 16 + a_col);
#pragma unroll
        for (int n16 = 0; n16 < KMAX / 16; ++n16) {
          if (n16 >= nk16) break;
#pragma unroll
          for (int kk = 0; kk < DMAX / 16; ++kk) {
            if (kk >= nd16) break;
            uint32_t vf[4];
            ldmatrix_x4(vf, v_s + (n16 * 16 + b_row) * ld + kk * 16 + b_col);
            mma_bf16(dp[2 * n16], ga[kk], vf[0], vf[1]);
            mma_bf16(dp[2 * n16 + 1], ga[kk], vf[2], vf[3]);
          }
        }
      }

      // Softmax on the fragments: element e of n-tile nt is (row
      // m0 + gr + 8 * (e / 2), key 8 * nt + 2t + e % 2).
      const int rows[2] = {m0 + gr, m0 + gr + 8};
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < KMAX / 8; ++nt) {
        if (nt >= 2 * nk16) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rows[e >> 1], j = nt * 8 + 2 * t + (e & 1);
          float x = -INFINITY;  // a padding key: excluded, not masked
          if (j < Tk) x = masked(i, j) ? kMaskedLogit : s[nt][e] * scale;
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < KMAX / 8; ++nt) {
        if (nt >= 2 * nk16) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
          sum[e >> 1] += s[nt][e];
        }
      }
      // One division per row, then a product per element (within an ulp of
      // the quotient).
      const float inv_sum[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};

      // P (0 on padding rows), dropout, Pd to shared memory, sum_k dP * P.
      float dp_dot_p[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < KMAX / 8; ++nt) {
        if (nt >= 2 * nk16) break;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = rows[r];
          float pd[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * r + c, j = nt * 8 + 2 * t + c;
            const float p = i < Tq ? s[nt][e] * inv_sum[r] : 0.f;
            float d = dp[nt][e];
            pd[c] = p;
            if (dropout) {
              const bool keep = i < Tq && j < Tk &&
                                attention_dropout_keep(seed, b, h, i, j,
                                                       threshold);
              pd[c] = keep ? p * inv_keep : 0.f;
              d = keep ? d * inv_keep : 0.f;
            }
            s[nt][e] = p;
            dp[nt][e] = d;
            dp_dot_p[r] = fmaf(d, p, dp_dot_p[r]);
          }
          uint32_t hi, lo;
          split_bf16x2(pd[0], pd[1], hi, lo);
          const int o = i * lp + nt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(pd_hi + o) = hi;
          *reinterpret_cast<uint32_t*>(pd_lo + o) = lo;
        }
      }
      dp_dot_p[0] = quad_sum(dp_dot_p[0]);
      dp_dot_p[1] = quad_sum(dp_dot_p[1]);

      // dS, in place of P, and to shared memory.
#pragma unroll
      for (int nt = 0; nt < KMAX / 8; ++nt) {
        if (nt >= 2 * nk16) break;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = rows[r];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * r + c, j = nt * 8 + 2 * t + c;
            float x = s[nt][e] * (dp[nt][e] - dp_dot_p[r]);
            if (masked(i, j)) x = 0.f;
            s[nt][e] = x * scale;
          }
          uint32_t hi, lo;
          split_bf16x2(s[nt][2 * r], s[nt][2 * r + 1], hi, lo);
          const int o = i * lp + nt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(ds_hi + o) = hi;
          *reinterpret_cast<uint32_t*>(ds_lo + o) = lo;
        }
      }

      // dQ = dS K: dS from registers (split), K's fragments by ldmatrix.trans.
      float acc[DMAX / 8][4];
#pragma unroll
      for (int dt = 0; dt < DMAX / 8; ++dt)
        acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KMAX / 16; ++kk) {
        if (kk >= nk16) break;
        uint32_t ah[4], al[4];
        split_a(s[2 * kk], s[2 * kk + 1], ah, al);
#pragma unroll
        for (int d16 = 0; d16 < DMAX / 16; ++d16) {
          if (d16 >= nd16) break;
          uint32_t kf[4];
          ldmatrix_x4_trans(kf, k_s + (kk * 16 + a_row) * ld + d16 * 16 + a_col);
          mma_bf16(acc[2 * d16], ah, kf[0], kf[1]);
          mma_bf16(acc[2 * d16], al, kf[0], kf[1]);
          mma_bf16(acc[2 * d16 + 1], ah, kf[2], kf[3]);
          mma_bf16(acc[2 * d16 + 1], al, kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= Tq) continue;
        uint32_t* out = reinterpret_cast<uint32_t*>(
            dq + ((static_cast<long long>(b) * Tq + rows[r]) * N + h) * D);
#pragma unroll
        for (int dt = 0; dt < DMAX / 8; ++dt) {
          if (dt >= 2 * nd16) break;
          out[dt * 4 + t] = pack_bf16(acc[dt][2 * r], acc[dt][2 * r + 1]);
        }
      }
    }
    __syncthreads();  // K and V are read; dS and Pd are in shared memory
    load_kv(next);
    cp_async_commit();

    // Phase B: a warp per 16 keys; dK = dS^T Q, dV = Pd^T g.
    for (int n0 = warp * 16; n0 < tk_pad; n0 += kMmaWarps * 16) {
      float ak[DMAX / 8][4], av[DMAX / 8][4];
#pragma unroll
      for (int dt = 0; dt < DMAX / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ak[dt][e] = av[dt][e] = 0.f;
      for (int q0 = 0; q0 < tq_pad; q0 += 16) {
        const int o = (q0 + b_row) * lp + n0 + b_col;
        uint32_t dh[4], dl[4], ph[4], pl[4];
        ldmatrix_x4_trans(dh, ds_hi + o);
        ldmatrix_x4_trans(dl, ds_lo + o);
        ldmatrix_x4_trans(ph, pd_hi + o);
        ldmatrix_x4_trans(pl, pd_lo + o);
#pragma unroll
        for (int d16 = 0; d16 < DMAX / 16; ++d16) {
          if (d16 >= nd16) break;
          const int od = (q0 + a_row) * ld + d16 * 16 + a_col;
          uint32_t qf[4], gf[4];
          ldmatrix_x4_trans(qf, q_s + od);
          ldmatrix_x4_trans(gf, g_s + od);
          mma_bf16(ak[2 * d16], dh, qf[0], qf[1]);
          mma_bf16(ak[2 * d16], dl, qf[0], qf[1]);
          mma_bf16(ak[2 * d16 + 1], dh, qf[2], qf[3]);
          mma_bf16(ak[2 * d16 + 1], dl, qf[2], qf[3]);
          mma_bf16(av[2 * d16], ph, gf[0], gf[1]);
          mma_bf16(av[2 * d16], pl, gf[0], gf[1]);
          mma_bf16(av[2 * d16 + 1], ph, gf[2], gf[3]);
          mma_bf16(av[2 * d16 + 1], pl, gf[2], gf[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = n0 + gr + 8 * r;
        if (j >= Tk) continue;
        const long long o = ((static_cast<long long>(b) * Tk + j) * N + h) * D;
        uint32_t* out_k = reinterpret_cast<uint32_t*>(dk + o);
        uint32_t* out_v = reinterpret_cast<uint32_t*>(dv + o);
#pragma unroll
        for (int dt = 0; dt < DMAX / 8; ++dt) {
          if (dt >= 2 * nd16) break;
          out_k[dt * 4 + t] = pack_bf16(ak[dt][2 * r], ak[dt][2 * r + 1]);
          out_v[dt * 4 + t] = pack_bf16(av[dt][2 * r], av[dt][2 * r + 1]);
        }
      }
    }
  }
}

template <int KMAX, int DMAX>
int launch_mma(const void* q, const void* k, const void* v, const void* mask,
               const void* g, void* dq, void* dk, void* dv, int B, int Tq,
               int Tk, int N, int D, Strides sq, Strides sk, Strides sv,
               Strides sg, MaskStrides sm, float scale, float rate,
               uint32_t threshold, const long long* seed,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(Tq, Tk, D);
  auto* kernel = attention_bwd_mma_kernel<KMAX, DMAX>;
  // As many blocks as fit on the card at once, each walking its pairs.
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = opt_in_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kMmaWarps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = static_cast<long long>(B) * N;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(pairs < fit ? pairs : fit);
  kernel<<<blocks, kMmaWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, N, Tq, Tk, D, sq, sk,
      sv, sg, sm, scale, rate, threshold, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scalar variant. Returns cudaGetLastError() after the launch (0 on
// success). is_bf16 selects bf16 operands and gradients; otherwise fp32.
// seed points to one int64 on the device, read only when rate > 0.
int virtex_attention_bwd(const void* q, const void* k, const void* v,
                         const void* mask, const void* g, void* dq, void* dk,
                         void* dv, int B, int Tq, int Tk, int N, int D,
                         int is_bf16, long long q_sb, long long q_st,
                         long long q_sn, long long k_sb, long long k_st,
                         long long k_sn, long long v_sb, long long v_st,
                         long long v_sn, long long g_sb, long long g_st,
                         long long g_sn, long long m_sb, long long m_sh,
                         long long m_sq, long long m_sk, float scale,
                         float rate, unsigned int threshold, const void* seed,
                         void* stream) {
  const virtex::Strides sq{q_sb, q_st, q_sn}, sk{k_sb, k_st, k_sn},
      sv{v_sb, v_st, v_sn}, sg{g_sb, g_st, g_sn};
  const virtex::MaskStrides sm{m_sb, m_sh, m_sq, m_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(seed);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, g, dq, dk, dv, B, Tq, Tk, N,
                                 D, sq, sk, sv, sg, sm, scale, rate, threshold,
                                 sp, s);
  return launch<float>(q, k, v, mask, g, dq, dk, dv, B, Tq, Tk, N, D, sq, sk,
                       sv, sg, sm, scale, rate, threshold, sp, s);
}

// Tensor-core variant: bf16, D a multiple of 16 up to 128, Tk up to 128,
// q/k/v/g base pointers and (b, t, n) strides 16-byte aligned. Same
// arguments and return as virtex_attention_bwd, without is_bf16.
int virtex_attention_bwd_mma(const void* q, const void* k, const void* v,
                             const void* mask, const void* g, void* dq,
                             void* dk, void* dv, int B, int Tq, int Tk, int N,
                             int D, long long q_sb, long long q_st,
                             long long q_sn, long long k_sb, long long k_st,
                             long long k_sn, long long v_sb, long long v_st,
                             long long v_sn, long long g_sb, long long g_st,
                             long long g_sn, long long m_sb, long long m_sh,
                             long long m_sq, long long m_sk, float scale,
                             float rate, unsigned int threshold,
                             const void* seed, void* stream) {
  if (D % 16 != 0 || D > 128 || Tk > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const virtex::Strides sq{q_sb, q_st, q_sn}, sk{k_sb, k_st, k_sn},
      sv{v_sb, v_st, v_sn}, sg{g_sb, g_st, g_sn};
  const virtex::MaskStrides sm{m_sb, m_sh, m_sq, m_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(seed);
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, void*, void*, void*, int, int, int, int,
                         int, virtex::Strides, virtex::Strides,
                         virtex::Strides, virtex::Strides,
                         virtex::MaskStrides, float, float, uint32_t,
                         const long long*, cudaStream_t);
  Launch fn = launch_mma<128, 128>;
  if (round16(Tk) <= 64 && D <= 64)
    fn = launch_mma<64, 64>;
  else if (round16(Tk) <= 64)
    fn = launch_mma<64, 128>;
  else if (D <= 64)
    fn = launch_mma<128, 64>;
  return fn(q, k, v, mask, g, dq, dk, dv, B, Tq, Tk, N, D, sq, sk, sv, sg, sm,
            scale, rate, threshold, sp, s);
}

// Bytes of dynamic shared memory one block needs at (Tq, Tk, D): scalar
// and tensor-core variants.
unsigned long long virtex_attention_bwd_smem_bytes(int Tq, int Tk, int D) {
  return smem_bytes(Tq, Tk, D);
}

unsigned long long virtex_attention_bwd_mma_smem_bytes(int Tq, int Tk,
                                                       int D) {
  return mma_smem_bytes(Tq, Tk, D);
}

}  // extern "C"
