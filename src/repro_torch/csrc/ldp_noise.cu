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
// What bounds it on the card: bytes.  It reads x and writes out (8 bytes an
// element); at (1000, 20490) that is 163.9 MB, 0.0489 ms at 3.35 TB/s.  The
// hash, the precise logf/cosf and the sqrt are a few dozen float32
// operations an element, about 0.015 ms at 67 TFLOP/s, so bytes bound it.
// What the simple design leaves on the table: one element a thread with
// scalar loads, and the precise (not fast-math) log and cos, which the
// agreement with K1 needs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ldp_hash.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kNoise>
__global__ void __launch_bounds__(kThreads)
ldp_kernel(const float* __restrict__ x, const int* __restrict__ seeds,
           const float* __restrict__ scales, float sigma_s,
           float* __restrict__ out, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int64_t at = (int64_t)blockIdx.y * n + p;
  float u = __fmul_rn(x[at], scales[blockIdx.y]);
  if (kNoise) u = repro_ldp::ldp_add_noise(u, sigma_s, seeds[blockIdx.y], p);
  out[at] = u;
}

}  // namespace

// x, out (k, n) float32 row-major; seeds (k,) int32 (unused when
// sigma_s == 0); scales (k,) float32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ldp_noise_launch(const float* x, const int* seeds,
                                const float* scales, float sigma_s,
                                float* out, int k, int n, void* stream_ptr) {
  if (k < 1 || k > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kThreads - 1) / kThreads, k);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (sigma_s > 0.0f)
    ldp_kernel<true><<<grid, kThreads, 0, stream>>>(x, seeds, scales, sigma_s,
                                                    out, n);
  else
    ldp_kernel<false><<<grid, kThreads, 0, stream>>>(x, seeds, scales,
                                                     sigma_s, out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* ldp_noise_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
