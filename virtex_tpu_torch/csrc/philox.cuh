// Stateless Philox4x32-10 counter-based generator (Salmon et al., SC'11),
// shared by every kernel that draws dropout bits.
//
// The attention dropout stream is keyed on (seed, batch index) and counted
// on (head, query, key), so the forward kernel and the backward kernel that
// recomputes the probabilities regenerate exactly the same keep mask from
// the same seed, without storing it.
#pragma once

#include <stdint.h>

namespace virtex {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t kMul0 = 0xD2511F53u, kMul1 = 0xCD9E8D57u;
  constexpr uint32_t kWeyl0 = 0x9E3779B9u, kWeyl1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kMul0, ctr.x), lo0 = kMul0 * ctr.x;
    const uint32_t hi1 = __umulhi(kMul1, ctr.z), lo1 = kMul1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kWeyl0;
    key.y += kWeyl1;
  }
  return ctr;
}

// Keep iff u >= rate, with u = bits / 2^32 read as UNSIGNED and
// threshold = ceil(rate * 2^32) computed by the host wrapper.
__device__ __forceinline__ bool attention_dropout_keep(
    uint32_t seed, uint32_t b, uint32_t head, uint32_t q, uint32_t k,
    uint32_t threshold) {
  const uint4 bits = philox4x32_10(make_uint4(head, q, k, 0u),
                                   make_uint2(seed, b));
  return bits.x >= threshold;
}

}  // namespace virtex
