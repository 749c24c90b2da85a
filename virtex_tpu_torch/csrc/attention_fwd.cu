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
// contiguous. The dropout seed is read from device memory.
//
// What bounds it: bytes. At the model's shapes (Tq = 30, Tk = 30 or 49,
// D = 64) one (b, h) pair is ~0.5 MFLOP over ~15-20 KB of operands and
// output, 25-30 FLOP per byte, far below the ~295 at which the H100's bf16
// tensor cores rather than its 3.35 TB/s would bind. A call at batch 128
// and 16 heads moves 31.6 MB (self) or 41.4 MB (cross): 9.4 or 12.4 us at
// full bandwidth. So the design aims at keeping loads in flight and at
// spending few instructions per byte:
//
// - bf16 operands (the main path) take the tensor-core variant. A work
//   item is a (b, h) pair and up to 64 of its query rows, with one warp
//   per 16 rows (two at Tq = 30) sharing the pair's K and V; a block takes
//   two items at a time (46 KB of shared memory at the cross shape, four
//   blocks per SM) and, launched once per resident slot, walks over item
//   groups with its loads pipelined: the next group's K and Q are fetched
//   while this group's softmax and P V run, the next V while its output
//   is stored. Operands are staged as bf16 with 16-byte cp.async (rows
//   past Tq or Tk zero-filled), rows padded by 16 bytes so that ldmatrix
//   hits eight distinct bank groups. S = Q K^T is mma.sync m16n8k16 (bf16
//   in, fp32 accumulate: the products are exact); the softmax runs on the
//   accumulator fragments, with quad shuffles for the row max and sum and
//   one division per row; P is rounded to bf16 in registers, which is the
//   semantics, and those registers are the A fragments of O = P V, whose
//   B fragments come from V by ldmatrix.trans. Keys past Tk (the tile's
//   padding) get a -inf logit and probability 0, so a fully masked row
//   spreads uniformly over the Tk real keys only. wgmma is not used: its
//   64-row tile would be more than half padding at Tq = 30.
//   Measured by chip_smoke.py on an H100 SXM at 700 W (B 128, 16 heads):
//   ~18 us self and ~19.5 us cross, 52-63% of the byte bound, against 87
//   and 147 us for the scalar design. Two choices mattered: one division
//   per row instead of one per element, and overlapping a group's loads
//   with the previous group's work instead of loading, then computing.
// - fp32 operands (DTYPE float32 configurations), and bf16 with D not a
//   multiple of 16, above 128, or Tk above 128, take the scalar variant:
//   one block per (b, h), K and V whole in fp32 shared memory, one warp
//   per query row with two shared-memory loads per FMA.
//
// Dropout draws from the stateless Philox4x32-10 in philox.cuh, keyed on
// (seed, b) and counted on (head, q, k); in the tensor-core variant each
// thread draws for the (q, k) its accumulator fragment holds, so both
// variants and K2 give the same keep mask. It does not reproduce the
// TPU's bits.
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
                         const long long* __restrict__ seed_ptr) {
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
  const uint32_t seed = load_seed(seed_ptr, dropout);
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
           uint32_t threshold, const long long* seed, cudaStream_t stream) {
  const size_t smem = smem_bytes(Tk, D);
  const cudaError_t err = opt_in_smem(attention_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_fwd_kernel<T><<<B * N, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), N, Tq, Tk, D, sq, sk, sv, sm, scale, rate,
      threshold, seed);
  return static_cast<int>(cudaGetLastError());
}

// -- tensor-core variant (bf16, D % 16 == 0, D <= 128, Tk <= 128) ------------
constexpr int kMmaMaxWarps = 4;   // warps per block
constexpr int kMmaQRows = 64;     // query rows per work item, 16 per warp
constexpr size_t kMmaSmemTarget = 100 * 1024;

// One work item is a (b, h) pair and a chunk of up to 64 of its query
// rows, one warp per 16 rows; the item's warps share its K and V. A block
// takes `heads` items at a time and walks over such groups a grid apart,
// with the loads pipelined across groups: K and Q of the next group are
// fetched while this group's softmax and P V run, and V of the next while
// this group's output is stored.
struct MmaShape {
  int tk_pad, warps, heads, q_chunks;
  size_t smem;
};

MmaShape mma_shape(int Tq, int Tk, int D) {
  MmaShape s;
  s.tk_pad = round16(Tk);
  s.q_chunks = (Tq + kMmaQRows - 1) / kMmaQRows;
  const int tiles = round16(Tq < kMmaQRows ? Tq : kMmaQRows) / 16;
  s.warps = tiles;
  const size_t row = static_cast<size_t>(D + 8) * sizeof(bf16);
  const size_t per_head = (2 * s.tk_pad + 16 * s.warps) * row;
  const size_t fit = kMmaSmemTarget / per_head;
  const int most = kMmaMaxWarps / s.warps;
  s.heads = fit < 1 ? 1 : (fit > size_t(most) ? most : int(fit));
  s.smem = per_head * s.heads;
  return s;
}

struct Item {  // a block slot's work item, as one warp of it sees it
  bool active;
  int b, h, m0;  // m0: this warp's first query row
};

// KMAX and DMAX bound Tk (padded to 16) and D at compile time, so that the
// fragment arrays stay in registers; the loops stop at the runtime sizes.
// The main path's instance (64, 64) is held to 128 registers, so that four
// blocks fit on an SM.
template <int KMAX, int DMAX>
__global__ void __launch_bounds__(kMmaMaxWarps * 32,
                                  KMAX == 64 && DMAX == 64 ? 4 : 1)
    attention_fwd_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const uint8_t* __restrict__ mask,
                             bf16* __restrict__ out, int B, int N, int Tq,
                             int Tk, int D, Strides sq, Strides sk,
                             Strides sv, MaskStrides sm, float scale,
                             float rate, uint32_t threshold,
                             const long long* __restrict__ seed_ptr,
                             int tk_pad, int warps, int q_chunks,
                             long long groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / warps, wq = warp - slot * warps;
  const int heads = blockDim.x / (32 * warps);
  const long long items = static_cast<long long>(B) * N * q_chunks;
  const int ld = D + 8;  // row stride in elements: 16 bytes of padding
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw) +
              static_cast<size_t>(slot) * (2 * tk_pad + 16 * warps) * ld;
  bf16* v_s = k_s + tk_pad * ld;
  bf16* q_w = v_s + tk_pad * ld + wq * 16 * ld;  // this warp's 16 Q rows
  const int chunks = D / 8;  // 16-byte pieces of a row

  auto item_of = [&](long long group) {
    const long long i = group * heads + slot;
    const long long pair = i / q_chunks;
    return Item{i < items, static_cast<int>(pair / N),
                static_cast<int>(pair % N),
                static_cast<int>(i % q_chunks) * kMmaQRows + wq * 16};
  };
  // K (shared by the item's warps) and this warp's 16 rows of Q; rows past
  // Tk or Tq are zero-filled.
  auto load_kq = [&](const Item& it) {
    if (!it.active) return;
    const bf16* kb = k + it.b * sk.b + it.h * sk.n;
    for (int e = wq * 32 + lane; e < tk_pad * chunks; e += warps * 32) {
      const int j = e / chunks, c = (e - j * chunks) * 8;
      const bool ok = j < Tk;
      cp_async_16(k_s + j * ld + c, ok ? kb + j * sk.t + c : kb, ok);
    }
    if (it.m0 >= Tq) return;
    const bf16* qb = q + it.b * sq.b + it.h * sq.n;
    for (int e = lane; e < 16 * chunks; e += 32) {
      const int i = e / chunks, c = (e - i * chunks) * 8;
      const bool ok = it.m0 + i < Tq;
      cp_async_16(q_w + i * ld + c, ok ? qb + (it.m0 + i) * sq.t + c : qb,
                  ok);
    }
  };
  auto load_v = [&](const Item& it) {
    if (!it.active) return;
    const bf16* vb = v + it.b * sv.b + it.h * sv.n;
    for (int e = wq * 32 + lane; e < tk_pad * chunks; e += warps * 32) {
      const int j = e / chunks, c = (e - j * chunks) * 8;
      const bool ok = j < Tk;
      cp_async_16(v_s + j * ld + c, ok ? vb + j * sv.t + c : vb, ok);
    }
  };

  const bool dropout = rate > 0.f;
  const uint32_t seed = load_seed(seed_ptr, dropout);
  const float keep_div = 1.f - rate;
  const int g = lane >> 2, t = lane & 3;
  const int nk16 = tk_pad / 16, nd16 = D / 16;
  // ldmatrix lane offsets: A (row-major, 16x16) and trans B tiles take
  // rows (lane % 8) + 8 * ((lane / 8) % 2) and column 8 * (lane / 16);
  // non-trans B tiles (two n-tiles of 8) rows (lane % 8) + 8 * (lane / 16)
  // and column 8 * ((lane / 8) % 2).
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  // Commit groups, per thread, in this order: KQ(first), V(first), then
  // per group KQ(next), V(next); so "all but the newest group" is the
  // one each wait below needs.
  Item cur = item_of(blockIdx.x);
  load_kq(cur);
  cp_async_commit();
  load_v(cur);
  cp_async_commit();
  for (long long group = blockIdx.x; group < groups; group += gridDim.x) {
    const Item next = item_of(group + gridDim.x);
    const bool work = cur.active && cur.m0 < Tq;
    const int b = cur.b, h = cur.h, m0 = cur.m0;
    float s[KMAX / 8][4], o[DMAX / 8][4];
#pragma unroll
    for (int nt = 0; nt < KMAX / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int dt = 0; dt < DMAX / 8; ++dt)
      o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

    cp_async_wait<1>();  // this group's K and Q
    __syncthreads();
    if (work) {
      uint32_t qa[DMAX / 16][4];
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk)
        if (kk < nd16)
          ldmatrix_x4(qa[kk], q_w + a_row * ld + kk * 16 + a_col);

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
    __syncthreads();  // every warp is done with K and Q
    load_kq(next);
    cp_async_commit();
    cp_async_wait<1>();  // this group's V
    __syncthreads();
    const int rows[2] = {m0 + g, m0 + g + 8};
    if (work) {
      // Logits, max, exp, sum on the fragments: element e of n-tile nt is
      // (row m0 + g + 8 * (e / 2), key 8 * nt + 2t + e % 2).
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < KMAX / 8; ++nt) {
        if (nt >= 2 * nk16) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rows[e >> 1], j = nt * 8 + 2 * t + (e & 1);
          float x = -INFINITY;  // a padding key: excluded, not masked
          if (j < Tk) {
            x = s[nt][e] * scale;
            if (mask != nullptr && i < Tq &&
                !mask[b * sm.b + h * sm.h + i * sm.q + j * sm.k])
              x = kMaskedLogit;
          }
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
      // the quotient, far below the bf16 rounding of P that follows).
      const float inv_sum[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
      for (int nt = 0; nt < KMAX / 8; ++nt) {
        if (nt >= 2 * nk16) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rows[e >> 1], j = nt * 8 + 2 * t + (e & 1);
          float p = s[nt][e] * inv_sum[e >> 1];
          if (dropout && i < Tq && j < Tk)
            p = attention_dropout_keep(seed, b, h, i, j, threshold)
                    ? p / keep_div
                    : 0.f;
          s[nt][e] = p;
        }
      }

      // O = P V: P's bf16 fragments are the A operand, V's by ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < KMAX / 16; ++kk) {
        if (kk >= nk16) break;
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int d16 = 0; d16 < DMAX / 16; ++d16) {
          if (d16 >= nd16) break;
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, v_s + (kk * 16 + a_row) * ld + d16 * 16 + a_col);
          mma_bf16(o[2 * d16], pa, vf[0], vf[1]);
          mma_bf16(o[2 * d16 + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with V
    load_v(next);
    cp_async_commit();
    if (work) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= Tq) continue;
        uint32_t* orow = reinterpret_cast<uint32_t*>(
            out + ((static_cast<long long>(b) * Tq + rows[r]) * N + h) * D);
#pragma unroll
        for (int dt = 0; dt < DMAX / 8; ++dt) {
          if (dt >= 2 * nd16) break;
          orow[dt * 4 + t] = pack_bf16(o[dt][2 * r], o[dt][2 * r + 1]);
        }
      }
    }
    cur = next;
  }
}

template <int KMAX, int DMAX>
int launch_mma(const void* q, const void* k, const void* v, const void* mask,
               void* out, int B, int Tq, int Tk, int N, int D, Strides sq,
               Strides sk, Strides sv, MaskStrides sm, float scale,
               float rate, uint32_t threshold, const long long* seed,
               cudaStream_t stream) {
  const MmaShape s = mma_shape(Tq, Tk, D);
  auto* kernel = attention_fwd_mma_kernel<KMAX, DMAX>;
  // As many blocks as fit on the card at once, each walking its groups.
  const int threads = s.heads * s.warps * 32;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = opt_in_smem(kernel, s.smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, s.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(B) * N * s.q_chunks;
  const long long groups = (items + s.heads - 1) / s.heads;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(groups < fit ? groups : fit);
  kernel<<<blocks, threads, s.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(out), B, N, Tq, Tk, D, sq, sk, sv, sm, scale, rate,
      threshold, seed, s.tk_pad, s.warps, s.q_chunks, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scalar variant. Returns cudaGetLastError() after the launch (0 on
// success). is_bf16 selects bf16 operands; otherwise fp32. seed points to
// one int64 on the device, read only when rate > 0.
int virtex_attention_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* out, int B, int Tq, int Tk,
                         int N, int D, int is_bf16, long long q_sb,
                         long long q_st, long long q_sn, long long k_sb,
                         long long k_st, long long k_sn, long long v_sb,
                         long long v_st, long long v_sn, long long m_sb,
                         long long m_sh, long long m_sq, long long m_sk,
                         float scale, float rate, unsigned int threshold,
                         const void* seed, void* stream) {
  const virtex::Strides sq{q_sb, q_st, q_sn}, sk{k_sb, k_st, k_sn},
      sv{v_sb, v_st, v_sn};
  const virtex::MaskStrides sm{m_sb, m_sh, m_sq, m_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(seed);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, B, Tq, Tk, N, D, sq, sk,
                                 sv, sm, scale, rate, threshold, sp, s);
  return launch<float>(q, k, v, mask, out, B, Tq, Tk, N, D, sq, sk, sv, sm,
                       scale, rate, threshold, sp, s);
}

// Tensor-core variant: bf16 operands, D a multiple of 16 up to 128, Tk up
// to 128, q/k/v base pointers and (b, t, n) strides 16-byte aligned (the
// wrapper copies an operand that is not). Same arguments and return as
// virtex_attention_fwd, without is_bf16.
int virtex_attention_fwd_mma(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int B, int Tq,
                             int Tk, int N, int D, long long q_sb,
                             long long q_st, long long q_sn, long long k_sb,
                             long long k_st, long long k_sn, long long v_sb,
                             long long v_st, long long v_sn, long long m_sb,
                             long long m_sh, long long m_sq, long long m_sk,
                             float scale, float rate, unsigned int threshold,
                             const void* seed, void* stream) {
  if (D % 16 != 0 || D > 128 || Tk > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const virtex::Strides sq{q_sb, q_st, q_sn}, sk{k_sb, k_st, k_sn},
      sv{v_sb, v_st, v_sn};
  const virtex::MaskStrides sm{m_sb, m_sh, m_sq, m_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(seed);
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         void*, int, int, int, int, int, virtex::Strides,
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
  return fn(q, k, v, mask, out, B, Tq, Tk, N, D, sq, sk, sv, sm, scale, rate,
            threshold, sp, s);
}

// Bytes of dynamic shared memory one block of the scalar variant needs.
unsigned long long virtex_attention_fwd_smem_bytes(int Tk, int D) {
  return smem_bytes(Tk, D);
}

const char* virtex_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
