// Beam search's selection for Hopper (sm_90a): per image, the top P of
// each of its K beams' fp32 log-probability rows and the top K of the
// image's K·P candidates, in one read of the rows.
//
// Replaces no TPU kernel: the JAX package selects in plain jnp
// (virtex_tpu/utils/beam_search.py _topk_small, k passes of argmax over a
// monotone integer view, because XLA's full sort took 43% of the TPU's
// beam decode). The port's plain version (ops/beam_select.py
// beam_select_reference) sorts every row in full to keep P of V values,
// and copies the rows three times around the sort. Per image b, beam row
// r = b·K + k, and each token j < V, this kernel computes
//   v_j = 0 at EOS and −1e18 elsewhere          where last_r is EOS,
//   v_j = x_j + penalty at j = last_r, else x_j otherwise (one fp32 add),
// keeps the row's top P (value, token), forms the candidates
//   c_{k·P + p} = scores_{b,k} + v_{p}           (one fp32 add),
// and keeps the image's top K, writing the new scores, tokens and source
// rows b·K + (k·P + p) / P. Values order as floats with −0.0 equal to +0.0
// and ties to the lowest index, which is the plain version's stable sort
// on the CPU. Across lanes a value and its index pack into one 64-bit key,
// the value's monotone 32-bit view (zeros merged) above the index's
// complement, so each comparison is one unsigned compare and no two keys
// are equal. A selected value is read back from its key, and from memory
// where the key is the merged zero, so the outputs carry the inputs' bits.
// Step 0 runs in a mode of its own (keep_image 0): the top keep_row of one
// row an image, with no penalty, no EOS latch and no merge.
//
// What bounds it: bytes, and then the instructions a value costs. The
// floor is one read of the live rows (a finished row is not read: its top
// is EOS, then the lowest other tokens). The design:
// - One block an image, 16 warps; warp w takes the w-th sixteenth of every
//   live beam row of its image, with 16-byte loads (a warp reads 512
//   contiguous bytes a load instruction); the scalar head and tail of a row
//   that does not start on 16 bytes go to the last warp.
// - A warp streams its (row, run) batches with two register sets of U
//   loads a lane: the next batch is in flight while this one is ranked, so
//   every warp keeps bytes in flight from its first load to its last.
// - A lane keeps its best L (≥ P) values and tokens in registers, sorted.
//   It sees its tokens in increasing order, so a plain float compare ranks
//   them (an equal later value goes after); a value below the lane's L-th
//   costs one compare. The penalty is one test a float4.
// - After a row the warp merges its lanes' lists by P rounds of a shuffle
//   max over keys, each popping the winner's head, into shared memory;
//   after the rows, warp k merges row k's 16 warp lists (P rounds over
//   ≤ 256 keys held 8 a lane), and warp 0 the image's K·P candidates (K
//   rounds).
// - 256 images make 256 blocks of 512 threads, two resident an SM, so the
//   whole grid is in flight at once on 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;                   // warps a block (an image)
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 16;                 // beams an image
constexpr int kMaxKeep = 16;                 // values kept a row
constexpr int kSlots = kWarps * kMaxKeep / 32;  // keys a lane holds in a merge

typedef unsigned long long Key;

struct Args {
  const float* x;
  const long long* last;  // (images · rows) tokens; null in step-0 mode
  const float* scores;    // (images, rows); null in step-0 mode
  float* scores_out;      // (images, keep_image), or (images, keep_row)
  long long* last_out;    // the same shape
  long long* src_out;     // (images · keep_image) rows; null in step-0 mode
  long long image_stride, row_stride;  // in elements
  int rows, V, keep_row, keep_image, eos;
  float penalty, after_end;
};

// The monotone 32-bit view of v, with −0.0 taken as +0.0: a > b as floats
// (no NaNs) iff view(a) > view(b). Every view is above 0.
__device__ __forceinline__ unsigned order_bits(float v) {
  unsigned b = __float_as_uint(v);
  if ((b << 1) == 0u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ Key pack(float v, unsigned i) {
  return (static_cast<Key>(order_bits(v)) << 32) | (0xFFFFFFFFu - i);
}

__device__ __forceinline__ unsigned key_index(Key k) {
  return 0xFFFFFFFFu - static_cast<unsigned>(k);
}

// The value a key was packed from; +0.0 for either zero.
__device__ __forceinline__ float key_value(Key k) {
  const unsigned o = static_cast<unsigned>(k >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ Key warp_max(Key k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Key o = __shfl_xor_sync(0xffffffffu, k, off);
    k = o > k ? o : k;
  }
  return k;
}

// A lane's best L values of one row, largest first, with their tokens.
// A lane offers its elements in increasing token order, so a value equal
// to one kept goes after it: a plain float compare orders them, −0.0 equal
// to +0.0. An empty slot holds NaN, which every value beats.
template <int L>
struct Top {
  float v[L];
  int i[L];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < L; ++k) v[k] = __int_as_float(0x7fffffff), i[k] = 0;
  }

  __device__ __forceinline__ void offer(float x, int j) {
    if (x <= v[L - 1]) return;
    bool placed = false;
#pragma unroll
    for (int k = L - 1; k > 0; --k) {
      if (!placed) {
        if (!(x <= v[k - 1])) {
          v[k] = v[k - 1];
          i[k] = i[k - 1];
        } else {
          v[k] = x;
          i[k] = j;
          placed = true;
        }
      }
    }
    if (!placed) v[0] = x, i[0] = j;
  }

  // The list as keys, largest first; 0 for an empty slot.
  __device__ __forceinline__ void keys(Key (&out)[L]) const {
#pragma unroll
    for (int k = 0; k < L; ++k)
      out[k] = v[k] == v[k] ? pack(v[k], static_cast<unsigned>(i[k])) : 0;
  }
};

template <int L>
__device__ __forceinline__ void pop(Key (&top)[L]) {
#pragma unroll
  for (int i = 0; i + 1 < L; ++i) top[i] = top[i + 1];
  top[L - 1] = 0;
}

// Where a warp's share of a row lies: the scalar head before the first
// 16-byte boundary, the warp's run [v0, v1) of float4s, the scalar tail.
struct Span {
  int head, tail, v0, v1;
};

__device__ __forceinline__ Span span_of(const Args& a, const float* row,
                                        int warp) {
  Span sp;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  sp.head = min(static_cast<int>(((16u - (addr & 15u)) & 15u) >> 2), a.V);
  const int nvec = (a.V - sp.head) >> 2;
  sp.tail = sp.head + 4 * nvec;
  const int per = (nvec + kWarps - 1) / kWarps;
  sp.v0 = min(warp * per, nvec);
  sp.v1 = min(sp.v0 + per, nvec);
  return sp;
}

__device__ __forceinline__ const float* row_ptr(const Args& a, int image,
                                                int r) {
  return a.x + image * a.image_stride + r * a.row_stride;
}

// x_j with the penalty where j is the beam's last token.
__device__ __forceinline__ float penalised(const Args& a, float x, int j,
                                           int last) {
  return j == last ? __fadd_rn(x, a.penalty) : x;
}

// U float4 loads a lane, at [j0, j0 + 32U) of the warp's run (zeros past
// v1).
template <int U>
__device__ __forceinline__ void load(float4 (&q)[U], const float* row,
                                     const Span& sp, int j0) {
  const float4* vec = reinterpret_cast<const float4*>(row + sp.head);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + 32 * u;
    q[u] = j < sp.v1 ? __ldg(vec + j) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int L, int U>
__device__ __forceinline__ void offer_loaded(const Args& a, const float4 (&q)[U],
                                             const Span& sp, int j0, int last,
                                             Top<L>& top) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + 32 * u;
    if (j < sp.v1) {
      const int e = sp.head + 4 * j;
      float4 f = q[u];
      if (static_cast<unsigned>(last - e) < 4u) {  // the penalty lands here
        f.x = penalised(a, f.x, e, last);
        f.y = penalised(a, f.y, e + 1, last);
        f.z = penalised(a, f.z, e + 2, last);
        f.w = penalised(a, f.w, e + 3, last);
      }
      top.offer(f.x, e);
      top.offer(f.y, e + 1);
      top.offer(f.z, e + 2);
      top.offer(f.w, e + 3);
    }
  }
}

// The last warp's scalar element at lane `lane` of the head (lanes 0-3,
// before the run) or of the tail (lanes 4-7, after it), or −1.
__device__ __forceinline__ int scalar_element(const Span& sp, int lane,
                                              bool tail, int V) {
  if (!tail) return lane < sp.head ? lane : -1;
  return lane >= 4 && lane - 4 < V - sp.tail ? sp.tail + lane - 4 : -1;
}

// L: the length of a lane's list (≥ keep_row); U: 16-byte loads a lane
// keeps in flight, in each of two sets, so that the next batch of loads
// is in flight while this one is ranked.
template <int L, int U>
__global__ void __launch_bounds__(kThreads, 2)
beam_select_kernel(const Args a) {
  __shared__ Key seg[kMaxRows][kWarps * kMaxKeep];  // each warp's top, a row
  __shared__ float node_val[kMaxRows * kMaxKeep];   // each row's top
  __shared__ unsigned node_idx[kMaxRows * kMaxKeep];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int image = blockIdx.x;
  const int P = a.keep_row;
  const bool first = a.keep_image == 0;

  // Lane r holds beam r's last token; the rows left to read are the live
  // ones (a finished row's values are known).
  int my_last = -1;
  if (!first && lane < a.rows)
    my_last = static_cast<int>(
        a.last[static_cast<long long>(image) * a.rows + lane]);
  const unsigned live = __ballot_sync(
      0xffffffffu, lane < a.rows && (first || my_last != a.eos));

  // The warp's batches: (live row r, trip t), t over its run in steps of
  // 32U float4s; a row ends with its scalar head and tail, then a merge
  // of the lanes' lists into seg[r].
  // (Rows that start elsewhere than on 16 bytes differ in their runs by
  // one float4 at most; trips covers the longest.)
  const int longest = ((a.V >> 2) + kWarps - 1) / kWarps;
  const int trips = max(1, (longest + 32 * U - 1) / (32 * U));
  int r = live ? __ffs(live) - 1 : a.rows, t = 0;
  float4 cur[U], nxt[U];
  if (r < a.rows) {
    const float* row = row_ptr(a, image, r);
    const Span sp = span_of(a, row, warp);
    load<U>(cur, row, sp, sp.v0 + lane);
  }
  Top<L> top;
  top.clear();
  while (r < a.rows) {
    int nr = r, nt = t + 1;
    if (nt == trips) {
      const unsigned later = live & ~((2u << r) - 1u);
      nr = later ? __ffs(later) - 1 : a.rows;
      nt = 0;
    }
    if (nr < a.rows) {
      const float* row = row_ptr(a, image, nr);
      const Span sp = span_of(a, row, warp);
      load<U>(nxt, row, sp, sp.v0 + lane + nt * 32 * U);
    }
    const float* row = row_ptr(a, image, r);
    const Span sp = span_of(a, row, warp);
    const int last = __shfl_sync(0xffffffffu, my_last, r);
    if (t == 0 && warp == kWarps - 1) {  // the head, before the run
      const int e = scalar_element(sp, lane, false, a.V);
      if (e >= 0) top.offer(penalised(a, row[e], e, last), e);
    }
    offer_loaded<L, U>(a, cur, sp, sp.v0 + lane + t * 32 * U, last, top);
    if (t == trips - 1) {
      if (warp == kWarps - 1) {  // the tail, after the run
        const int e = scalar_element(sp, lane, true, a.V);
        if (e >= 0) top.offer(penalised(a, row[e], e, last), e);
      }
      Key keys[L];
      top.keys(keys);
      for (int p = 0; p < P; ++p) {
        const Key best = warp_max(keys[0]);
        if (keys[0] == best) pop(keys);  // one lane, or only empty lists
        if (lane == 0) seg[r][warp * P + p] = best;
      }
      top.clear();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    r = nr;
    t = nt;
  }
  __syncthreads();

  // Row r's top P: a finished row's is EOS at 0, then the lowest other
  // tokens at after_end; a live row's from its warps' lists.
  for (int r = warp; r < a.rows; r += kWarps) {
    if (!((live >> r) & 1u)) {
      if (lane < P) {
        node_val[r * P + lane] = lane == 0 ? 0.f : a.after_end;
        node_idx[r * P + lane] =
            lane == 0 ? a.eos : (lane - 1 < a.eos ? lane - 1 : lane);
      }
      continue;
    }
    Key c[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = lane + 32 * s;
      c[s] = e < kWarps * P ? seg[r][e] : 0;
    }
    const float* row = row_ptr(a, image, r);
    const int last = __shfl_sync(0xffffffffu, my_last, r);
    for (int p = 0; p < P; ++p) {
      Key m = c[0];
#pragma unroll
      for (int s = 1; s < kSlots; ++s) m = c[s] > m ? c[s] : m;
      const Key best = warp_max(m);
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (c[s] == best) c[s] = 0;
      if (lane == 0) {
        const int j = static_cast<int>(key_index(best));
        float v = key_value(best);
        if (v == 0.f) v = penalised(a, row[j], j, last);  // the zero's sign
        if (first) {
          const long long o = static_cast<long long>(image) * P + p;
          a.scores_out[o] = v;
          a.last_out[o] = j;
        } else {
          node_val[r * P + p] = v;
          node_idx[r * P + p] = j;
        }
      }
    }
  }
  if (first) return;
  __syncthreads();

  // The image's top K of its K·P candidates.
  if (warp == 0) {
    const int n = a.rows * P;
    const long long base = static_cast<long long>(image) * a.rows;
    Key c[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int f = lane + 32 * s;
      c[s] = f < n ? pack(__fadd_rn(a.scores[base + f / P], node_val[f]),
                          static_cast<unsigned>(f))
                   : 0;
    }
    for (int k = 0; k < a.keep_image; ++k) {
      Key m = c[0];
#pragma unroll
      for (int s = 1; s < kSlots; ++s) m = c[s] > m ? c[s] : m;
      const Key best = warp_max(m);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (c[s] == best) {
          c[s] = 0;
          const int f = lane + 32 * s;
          const long long o = static_cast<long long>(image) * a.keep_image + k;
          a.scores_out[o] = __fadd_rn(a.scores[base + f / P], node_val[f]);
          a.last_out[o] = node_idx[f];
          a.src_out[o] = base + f / P;
        }
      }
    }
  }
}

template <int L>
int launch(const Args& a, int images, cudaStream_t stream) {
  constexpr int U = L <= 2 ? 5 : L <= 8 ? 3 : 2;
  beam_select_kernel<L, U><<<images, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// In-loop mode (keep_image = K ≥ 1): x holds images × rows beam rows of V
// fp32 values; last (images · rows) int64, scores (images, rows) fp32;
// writes scores_out, last_out (images, K) and src_out (images · K).
// Step-0 mode (keep_image 0): one row an image, last, scores and src_out
// unused; writes the top keep_row into scores_out, last_out (images,
// keep_row). Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue outside rows ≤ 16, keep_row ≤ 16, keep_image ≤
// rows · keep_row, keep_row ≤ V.
int virtex_beam_select(const void* x, const void* last, const void* scores,
                       void* scores_out, void* last_out, void* src_out,
                       int images, int rows, int V, long long image_stride,
                       long long row_stride, int keep_row, int keep_image,
                       int eos, float penalty, float after_end,
                       void* stream) {
  if (images < 1 || rows < 1 || rows > kMaxRows || keep_row < 1 ||
      keep_row > kMaxKeep || keep_row > V || keep_image < 0 ||
      keep_image > rows * keep_row || (keep_image == 0 && rows != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x),
               static_cast<const long long*>(last),
               static_cast<const float*>(scores),
               static_cast<float*>(scores_out),
               static_cast<long long*>(last_out),
               static_cast<long long*>(src_out),
               image_stride, row_stride, rows, V, keep_row, keep_image, eos,
               penalty, after_end};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (keep_row) {
    case 1: return launch<1>(a, images, s);
    case 2: return launch<2>(a, images, s);
    case 3: return launch<3>(a, images, s);
    case 4: return launch<4>(a, images, s);
    case 5: return launch<5>(a, images, s);
    default: return keep_row <= 8 ? launch<8>(a, images, s)
                                  : launch<16>(a, images, s);
  }
}

}  // extern "C"
