// The ALDP noise stream shared by upload_fused.cu (K1) and ldp_noise.cu (K5).
//
// Replaces `_hash_uniform` of `repro/kernels/ldp_noise.py` and the Box–Muller
// step both TPU kernels run on it.  The TPU kernels tile each row into
// (256 x 1024) blocks and draw element e of block b from
// murmur(e + u32(seed + b*7919)*2654435761 + stream*0x9E3779B9).  Here a flat
// position p maps to b = p >> 18 and e = p - b*2^18, so the stream is the
// TPU's without its padding.  Both kernels add the noise through
// `ldp_noise_add`, with explicitly rounded multiplies and adds (no
// contraction), so K1 and the unfused K4 -> K5 chain give the same bits.
//
// What this header does for the card: the murmur input is rewritten, mod
// 2^32, as p + key_s + b*kTileStep, where key_s = u32(seed)*2654435761 +
// s*0x9E3779B9 depends on the row alone (`noise_keys`, once per row) and
// kTileStep = 7919*2654435761 - 2^18.  Every step is unsigned 32-bit
// arithmetic, so the sum wraps exactly as the TPU's does: the same bits for
// two fewer multiplies and no division an element.  What stays per element
// is the noise itself: two 32-bit hashes, the precise logf, sqrtf and cosf
// (no fast-math forms: they would change bits), and three rounded products.
#pragma once

#include <stdint.h>

namespace repro_ldp {

constexpr uint32_t kTileShift = 18;            // a TPU tile: 2^18 positions
constexpr uint32_t kSeedMul = 2654435761u;
constexpr uint32_t kStreamMul = 0x9E3779B9u;
constexpr uint32_t kTileStep = 7919u * kSeedMul - (1u << kTileShift);

// The per-row parts of the murmur inputs of streams 1 and 2.
struct NoiseKeys {
  uint32_t k1, k2;
};

__device__ __forceinline__ NoiseKeys noise_keys(int32_t seed) {
  const uint32_t s = (uint32_t)seed * kSeedMul;
  return {s + kStreamMul, s + 2u * kStreamMul};
}

__device__ __forceinline__ uint32_t fmix(uint32_t x) {
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

// u + sigma_s * BoxMuller(row keys, p): the noised value of flat position p
// of a row whose keys are `k`.
__device__ __forceinline__ float ldp_noise_add(float u, float sigma_s,
                                               NoiseKeys k, uint32_t p) {
  const uint32_t x = p + (p >> kTileShift) * kTileStep;
  const float u1 = fmaxf(unit(fmix(x + k.k1)), 1e-12f);
  const float u2 = unit(fmix(x + k.k2));
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float theta = __fmul_rn(6.2831854820251465f, u2);
  return __fadd_rn(u, __fmul_rn(__fmul_rn(sigma_s, r), cosf(theta)));
}

}  // namespace repro_ldp
