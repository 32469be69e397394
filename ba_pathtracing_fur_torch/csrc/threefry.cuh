// jax.random's threefry-2x32 on uint32, for kernels that draw their own
// uniforms bit for bit as the port's core/rng.py (and jax 0.9 with
// jax_threefry_partitionable=True) does:
//
//   * fold_in(key, d)          = threefry2x32(key, (0, d));
//   * draw j of uniform(k, n)  = x0 ^ x1 of threefry2x32(k, (0, j)) (the
//     counter's high word is 0 for n < 2^32), as the float
//     bitcast((bits >> 9) | 0x3f800000) - 1;
//   * bounce_uniform(key, b, j, tag) = draw j of fold_in(key, (b + 1) * 97 + tag),
//     core/rng.bounce_uniform.
//
// A draw depends only on its key and counter, so a kernel makes only the
// draws its branch reads and every draw equals the batched torch one.
// What a draw costs: one threefry is 79 integer operations (20 rounds of
// add, rotate and xor, 5 key injections of 3 adds, 4 for the key schedule
// and the counter); a tag costs one fold_in, and each draw one threefry
// and 3 operations more (xor, shift, or).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tf {

constexpr uint32_t PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// The rotation of round j of group i: (13, 15, 26, 6) in even groups,
// (17, 29, 16, 24) in odd ones (constants once the loops unroll).
__device__ __forceinline__ int rotation(int i, int j) {
  return i % 2 == 0 ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                    : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

// Threefry-2x32, 20 rounds (core/rng.threefry2x32).
__device__ __forceinline__ uint2 threefry2x32(uint2 key, uint2 ctr) {
  const uint32_t ks[3] = {key.x, key.y, key.x ^ key.y ^ PARITY};
  uint32_t x0 = ctr.x + ks[0], x1 = ctr.y + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rotation(i, j)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

__device__ __forceinline__ uint2 fold_in(uint2 key, uint32_t d) {
  return threefry2x32(key, make_uint2(0u, d));
}

// jax's float32 uniform in [0, 1) from 32 random bits.
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __int_as_float(static_cast<int>((bits >> 9) | 0x3f800000u)) - 1.0f;
}

// Draw j of jax.random.uniform(k, (n,)) for any n > j.
__device__ __forceinline__ float uniform_at(uint2 k, uint32_t j) {
  uint2 y = threefry2x32(k, make_uint2(0u, j));
  return unit_float(y.x ^ y.y);
}

// The key of tag `tag` at bounce `bounce` (bounce -1: the camera draws).
__device__ __forceinline__ uint2 bounce_key(uint2 key, int bounce, int tag) {
  return fold_in(key, static_cast<uint32_t>((bounce + 1) * 97 + tag));
}

// A key of the port's [R, 2] int64 key tensors: each word holds 32 bits.
__device__ __forceinline__ uint2 load_key(const long long* keys, int i) {
  return make_uint2(static_cast<uint32_t>(keys[2 * i]), static_cast<uint32_t>(keys[2 * i + 1]));
}

}  // namespace tf
