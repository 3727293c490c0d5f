// ALDP clip scale + Gaussian noise over a stacked (K, N) cohort (Eq. 8).
//
// Replaces the Pallas TPU kernels `repro/kernels/ldp_noise.py`
// (`ldp_perturb_fleet`, body `_fleet_kernel`; `ldp_perturb_flat`, body
// `_kernel`, which is the one-row case here).  Per row i and position p:
//   out = x * scale[i] + sigma_s * BoxMuller(hash(seed_i, p))
// with the noise stream of `ldp_hash.cuh`, which K1 (upload_fused.cu) shares:
// block b = p / 2^18, index e = p % 2^18, block seed int32(seed + b*7919)
// with wrap, streams 1 and 2, u1 = max(u, 1e-12).  sigma_s = 0 scales only.
//
// What bounds it on the card: bytes or the noise's instruction issue.  It
// reads x and writes out, 8 bytes an element: at (1000, 20490) 163.9 MB,
// 0.0489 ms at 3.35 TB/s.  But it draws K1's noise an element at half K1's
// bytes: two 32-bit hashes, the precise logf, sqrtf and cosf and the
// rounded products are roughly a hundred instructions an element, which at
// 20.5 M elements is as long to issue as the bytes take to move.  The
// noise's arithmetic may not change (the precise functions and the rounded
// `__fmul_rn`/`__fadd_rn` keep K5 bit for bit with K1), so the design
// takes everything around it off the issue path, in K1's run layout:
// - each thread owns a run of consecutive elements of one row, eight (two
//   16-byte vectors) with noise and four without, and moves them with
//   16-byte streaming loads and stores (`__ldcs`/`__stcs`), the loads
//   issued before any other work;
// - rows start on any 4-byte boundary (P = 20,490 is 2 mod 4), so each row
//   splits into a scalar head before its first 16-byte boundary, whole
//   runs, and a scalar tail; one thread a row takes the head and the tail
//   (input and output share a head, so the wrapper hands the kernel
//   16-byte aligned arrays);
// - each thread reads its row's seed and scale once and makes the row's
//   noise keys once (`noise_keys`); indices are unsigned 32-bit within a
//   row.
// K5 keeps its own source and launch: the unfused K4 -> K3 -> K5 chain is
// what K1 is held against bit for bit, so it must not run K1's code.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ldp_hash.cuh"

namespace {

constexpr int kBlock = 128;

// 16-byte vectors a thread moves each way: two with noise, one without.
template <bool kNoise>
constexpr int kVecsPerRun = kNoise ? 2 : 1;

__device__ __forceinline__ void unpack(float4 x, float* d) {
  d[0] = x.x;
  d[1] = x.y;
  d[2] = x.z;
  d[3] = x.w;
}

__device__ __forceinline__ float4 pack(const float* s) {
  return make_float4(s[0], s[1], s[2], s[3]);
}

template <bool kNoise>
__device__ __forceinline__ float perturb(float x, float scale, float sigma_s,
                                         repro_ldp::NoiseKeys keys,
                                         uint32_t p) {
  const float u = __fmul_rn(x, scale);
  return kNoise ? repro_ldp::ldp_noise_add(u, sigma_s, keys, p) : u;
}

template <bool kNoise>
__global__ void __launch_bounds__(kBlock)
ldp_kernel(const float* __restrict__ x, const int* __restrict__ seeds,
           const float* __restrict__ scales, float sigma_s,
           float* __restrict__ out, uint32_t n) {
  constexpr int kVec = kVecsPerRun<kNoise>;
  constexpr uint32_t kRun = 4 * kVec;
  const uint32_t row = blockIdx.y;
  const size_t off = (size_t)row * n;
  const float* x_r = x + off;
  float* out_r = out + off;
  // Elements before the row's first 16-byte boundary (the arrays start on
  // one), then whole runs, then the tail.
  const uint32_t head = min((uint32_t)(0u - (uint32_t)off) & 3u, n);
  const uint32_t runs = (n - head) / kRun;
  const uint32_t j = blockIdx.x * kBlock + threadIdx.x;
  if (j > runs) return;
  const uint32_t p = head + j * kRun;
  float u[kRun];
  if (j < runs) {
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      unpack(__ldcs(reinterpret_cast<const float4*>(x_r + p) + v), u + 4 * v);
  }
  const float scale = scales[row];
  const repro_ldp::NoiseKeys keys = kNoise ? repro_ldp::noise_keys(seeds[row])
                                           : repro_ldp::NoiseKeys{0u, 0u};
  if (j < runs) {
#pragma unroll
    for (int e = 0; e < (int)kRun; ++e)
      u[e] = perturb<kNoise>(u[e], scale, sigma_s, keys, p + e);
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      __stcs(reinterpret_cast<float4*>(out_r + p) + v, pack(u + 4 * v));
  } else {
    for (uint32_t q = 0; q < head; ++q)
      out_r[q] = perturb<kNoise>(x_r[q], scale, sigma_s, keys, q);
    for (uint32_t q = head + runs * kRun; q < n; ++q)
      out_r[q] = perturb<kNoise>(x_r[q], scale, sigma_s, keys, q);
  }
}

template <bool kNoise>
void launch(cudaStream_t stream, const float* x, const int* seeds,
            const float* scales, float sigma_s, float* out, int k,
            uint32_t n) {
  // One thread per whole run, plus one for the row's head and tail.
  const uint32_t threads = n / (4 * kVecsPerRun<kNoise>) + 1;
  dim3 grid((threads + kBlock - 1) / kBlock, k);
  ldp_kernel<kNoise><<<grid, kBlock, 0, stream>>>(x, seeds, scales, sigma_s,
                                                  out, n);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// x, out (k, n) float32 row-major, each starting on a 16-byte boundary;
// seeds (k,) int32 (unused when sigma_s == 0); scales (k,) float32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ldp_noise_launch(const float* x, const int* seeds,
                                const float* scales, float sigma_s,
                                float* out, int k, int n, void* stream_ptr) {
  if (k < 1 || k > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (sigma_s > 0.0f)
    launch<true>(stream, x, seeds, scales, sigma_s, out, k, (uint32_t)n);
  else
    launch<false>(stream, x, seeds, scales, sigma_s, out, k, (uint32_t)n);
  return (int)cudaGetLastError();
}

extern "C" const char* ldp_noise_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
