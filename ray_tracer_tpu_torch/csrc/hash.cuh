// The path tracer's sampler on the card: the lowbias32 hash and the
// per-ray sample key, in native uint32_t (wrapping multiplies and adds,
// logical shifts).
//
// Counterpart of ray_tracer_tpu/render/pathtrace.py:_hash_u01 (:67) and
// ray_sample_keys (:87), and bitwise equal to the port's int64-masked
// copies (ray_tracer_tpu_torch/render/pathtrace.py).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSampleSalt = 0x632BE59Bu;  // the per-sample key stride

// lowbias32(x + salt) -> [0, 1) as f32: (h >> 8) * 2^-24 is exact.
__device__ __forceinline__ float hash_u01(uint32_t x, uint32_t salt) {
  x = (x + salt) ^ 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// The key of a ray: a hash of its origin's and direction's f32 bits.
__device__ __forceinline__ uint32_t ray_sample_key(const float o[3], const float d[3]) {
  return (__float_as_uint(d[0]) * 0x85EBCA6Bu) ^ (__float_as_uint(d[1]) * 0xC2B2AE35u) ^
         (__float_as_uint(d[2]) * 0x27D4EB2Fu) ^ (__float_as_uint(o[0]) * 0x165667B1u) ^
         (__float_as_uint(o[1]) * 0x9E3779B1u) ^ (__float_as_uint(o[2]) * 0xFC0589B5u);
}

// Sample samp's key: key0 + kSampleSalt * (samp + 1).
__device__ __forceinline__ uint32_t sample_key(uint32_t key0, int samp) {
  return key0 + kSampleSalt * (uint32_t)(samp + 1);
}

}  // namespace
