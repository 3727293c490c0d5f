// The ALDP noise stream shared by upload_fused.cu (K1) and ldp_noise.cu (K5).
//
// Replaces `_hash_uniform` of `repro/kernels/ldp_noise.py` and the Box–Muller
// step both TPU kernels run on it.  The TPU kernels tile each row into
// (256 x 1024) blocks and draw element e of block b from
// murmur(e + u32(seed + b*7919)*2654435761 + stream*0x9E3779B9).  Here a flat
// position p maps to b = p / 2^18 and e = p % 2^18 directly, so the stream is
// the TPU's without its padding.  Both kernels add the noise through
// `ldp_add_noise`, with explicitly rounded multiplies and adds (no
// contraction), so K1 and the unfused K4 -> K5 chain give the same bits.
#pragma once

#include <stdint.h>

namespace repro_ldp {

constexpr int kNoiseBlock = 256 * 1024;

__device__ __forceinline__ uint32_t murmur(uint32_t e, int32_t blk_seed,
                                           uint32_t stream) {
  uint32_t x = e + (uint32_t)blk_seed * 2654435761u + stream * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float unit(uint32_t x) {
  return __fmul_rn((float)(x >> 8), 1.0f / 16777216.0f);  // exact
}

// u + sigma_s * BoxMuller(seed, p): the noised value of flat position p of a
// row seeded with `seed`.
__device__ __forceinline__ float ldp_add_noise(float u, float sigma_s,
                                               int32_t seed, int p) {
  const int blk = p / kNoiseBlock;
  const uint32_t e = (uint32_t)(p - blk * kNoiseBlock);
  const int32_t blk_seed = (int32_t)((uint32_t)seed + (uint32_t)blk * 7919u);
  const float u1 = fmaxf(unit(murmur(e, blk_seed, 1u)), 1e-12f);
  const float u2 = unit(murmur(e, blk_seed, 2u));
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float theta = __fmul_rn(6.2831854820251465f, u2);
  return __fadd_rn(u, __fmul_rn(__fmul_rn(sigma_s, r), cosf(theta)));
}

}  // namespace repro_ldp
