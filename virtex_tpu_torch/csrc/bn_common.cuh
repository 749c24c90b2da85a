// Pieces shared by the BatchNorm kernels, K4's backward
// (bn_backward_sums.cu) and the forward (bn_forward.cu): the block shapes,
// bf16 conversions, 16-byte vectors of channels, a vector variant's tile of
// the row-major (M, C) operands, and the host's operand checks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace virtex_bn {

constexpr int kCols = 32;      // scalar reductions: channels per block, one per lane
constexpr int kRows = 8;       // scalar reductions: warps per block, each on every 8th row
constexpr int kThreads = 256;  // threads per block of every other kernel
constexpr int kTileCols = 8;   // vector columns per block tile (ops/batchnorm.py _TILE_COLS)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// bf16 is the upper half of an fp32: widening is a shift.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// Two floats rounded to nearest even in one conversion, as torch's
// .to(torch.bfloat16); lo at the lower address.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// VEC elements of T moved as one load or store (pack rounds to T).
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[4]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[4]) {
    f[0] = bf16_lo(r.x);
    f[1] = bf16_hi(r.x);
    f[2] = bf16_lo(r.y);
    f[3] = bf16_hi(r.y);
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[4]) {
    return make_uint2(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    f[0] = bf16_lo(r.x);
    f[1] = bf16_hi(r.x);
    f[2] = bf16_lo(r.y);
    f[3] = bf16_hi(r.y);
    f[4] = bf16_lo(r.z);
    f[5] = bf16_hi(r.z);
    f[6] = bf16_lo(r.w);
    f[7] = bf16_hi(r.w);
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[8]) {
    return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                      bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
  }
};

template <typename V, typename T>
__device__ __forceinline__ typename V::Raw load_vec(const T* p) {
  return *reinterpret_cast<const typename V::Raw*>(p);
}

// 8 channels per vector where both operands are bf16, else 4 (16 bytes of
// fp32); ops/batchnorm.py k4_vector_width.
template <typename TA, typename TB>
constexpr int vec_width() {
  return std::is_same<TA, __nv_bfloat16>::value &&
                 std::is_same<TB, __nv_bfloat16>::value
             ? 8
             : 4;
}

// A vector variant's block: a tile of tc vector columns by rpb row lanes.
struct Tile {
  int tc;       // vector columns in a tile
  int rpb;      // row lanes: rows the block reads at once
  int nch;      // channels of a full tile, tc * VEC
  int col;      // this thread's vector column in the tile
  int lane;     // this thread's row lane
  int c0;       // this thread's first channel
  int tile_c0;  // the tile's first channel
  int tile_n;   // the tile's channels (fewer in a ragged last tile)
  bool active;  // whether this thread reads any channel
};

template <int VEC>
__device__ __forceinline__ Tile tile_of(int C) {
  Tile t;
  const int cv = C / VEC;
  t.tc = cv < kTileCols ? cv : kTileCols;
  t.rpb = kThreads / t.tc;
  t.nch = t.tc * VEC;
  t.col = threadIdx.x % t.tc;
  t.lane = threadIdx.x / t.tc;
  const int vcol = blockIdx.x * t.tc + t.col;
  t.c0 = vcol * VEC;
  t.tile_c0 = blockIdx.x * t.nch;
  t.tile_n = C - t.tile_c0 < t.nch ? C - t.tile_c0 : t.nch;
  t.active = t.lane < t.rpb && vcol < cv;
  return t;
}

// The rows [r0, r1) of the block's chunk.
__device__ __forceinline__ void chunk_rows(long long M, long long rows_per_chunk,
                                           long long* r0, long long* r1) {
  *r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  *r1 = *r0 + rows_per_chunk < M ? *r0 + rows_per_chunk : M;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The vector variants' grid.x: column tiles of C / vec vectors.
inline int tile_columns(int C, int vec) {
  const int cv = C / vec;
  const int tc = cv < kTileCols ? cv : kTileCols;
  return (cv + tc - 1) / tc;
}

}  // namespace virtex_bn
