// Attention-dropout keep mask shared by the flash kernels K1, K2 and K3.
//
// Replaces the JAX package's ops/flash_attention.py::_keep_mask, the device
// function its three Pallas kernels share: a murmur3 finalizer over the
// GLOBAL (seed words, batch, head, query index, key index) coordinate, so
// the forward and both backward kernels regenerate the identical bit for
// every (q, k) pair whatever their tiling, and nothing of size L x L is
// stored. Everything is uint32_t with natural wraparound, which is exactly
// the JAX function's uint32 arithmetic; keep iff x >= thresh, where the
// host computes thresh = min(2^32 - 1, round_half_even(rate * 2^32)).
#pragma once

#include <stdint.h>

__device__ __forceinline__ bool keep_bit(uint32_t s0, uint32_t s1, uint32_t b,
                                         uint32_t h, uint32_t q, uint32_t k,
                                         uint32_t thresh) {
  uint32_t x = (q * 0x9E3779B1u) ^ (k * 0x85EBCA77u);
  x ^= s0 + b * 0xC2B2AE3Du + h * 0x27D4EB2Fu;
  // The second seed word with its own odd multiplier: the two words act as
  // one 64-bit seed rather than xor-cancelling.
  x += s1 * 0x632BE59Bu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

// Dropout parameters of one kernel launch. seed == nullptr means rate 0:
// the kernels are then instantiated without any hash work.
struct DropParams {
  const int64_t* seed;  // two words, each in [0, 2^32), on the device
  uint32_t thresh;      // keep iff hash >= thresh
  float inv;            // fp32(1 / (1 - rate)), the kept weights' scale
};
