// Fused upload pipeline for one cohort: DGC sparsify + nnz + ALDP clip/noise.
//
// Replaces the Pallas TPU kernel `repro/kernels/upload_fused.py`
// (`upload_fused_fleet`, body `_fused_kernel`).  Per node row i and flat
// position p:
//   c = delta + residual; keep = |c| >= thr[i, leaf(p)]
//   upload = keep ? c : 0; residual' = keep ? 0 : c; nnz[i] += (upload != 0)
//   upload = upload * clip_scale[i] + sigma_s * BoxMuller(hash(seed_i, p))
//
// What bounds it on the card: bytes.  Each element reads delta and residual
// and writes upload and residual' (16 bytes); the hash, log and cos are a
// few dozen operations per element, far below the float32 rate.  The design
// is one streaming pass: one thread per element with neighbouring threads
// on neighbouring addresses (coalesced), blockIdx.y = node so every block
// stays inside one row, the per-leaf thresholds and leaf boundaries staged
// in shared memory, and nnz reduced by warp shuffles then one integer
// atomicAdd per block (integer atomics keep the count exact).
//
// Noise: the TPU kernel's counter-hash Box–Muller stream, from the header
// this kernel shares with ldp_noise.cu (K5), so the fused pass and the
// unfused sparsify -> nnz -> ldp_noise chain give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ldp_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;

template <bool kSparsify, bool kLdp, bool kNoise, bool kNnz>
__global__ void __launch_bounds__(kThreads)
upload_fused_kernel(const float* __restrict__ flat,
                    const float* __restrict__ res,
                    const float* __restrict__ thr,
                    const int* __restrict__ bounds, int n_leaves,
                    const int* __restrict__ seeds,
                    const float* __restrict__ scales, float sigma_s,
                    float* __restrict__ up_out, float* __restrict__ newr_out,
                    int* __restrict__ nnz, int n) {
  __shared__ int s_bounds[kMaxLeaves];
  __shared__ float s_thr[kMaxLeaves];
  __shared__ int s_warp[kThreads / 32];
  const int node = blockIdx.y;
  if (kSparsify) {
    for (int l = threadIdx.x; l < n_leaves; l += blockDim.x) {
      s_bounds[l] = bounds[l];
      s_thr[l] = thr[(size_t)node * n_leaves + l];
    }
    __syncthreads();
  }
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t at = (size_t)node * n + p;
  int cnt = 0;
  if (p < n) {
    float u = flat[at];
    if (kSparsify) {
      const float c = __fadd_rn(u, res[at]);
      float t = s_thr[0];
      for (int l = 1; l < n_leaves; ++l)
        if (p >= s_bounds[l]) t = s_thr[l];
      const bool keep = fabsf(c) >= t;
      u = keep ? c : 0.0f;
      newr_out[at] = keep ? 0.0f : c;
    }
    if (kNnz) cnt = (u != 0.0f);
    if (kLdp) {
      u = __fmul_rn(u, scales[node]);
      if (kNoise) u = repro_ldp::ldp_add_noise(u, sigma_s, seeds[node], p);
    }
    up_out[at] = u;
  }
  if (kNnz) {
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = cnt;
    __syncthreads();
    if (threadIdx.x < 32) {
      int v = threadIdx.x < (blockDim.x >> 5) ? s_warp[threadIdx.x] : 0;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (threadIdx.x == 0 && v) atomicAdd(nnz + node, v);
    }
  }
}

template <bool S, bool L, bool N, bool Z>
void launch(dim3 grid, cudaStream_t stream, const float* flat, const float* res,
            const float* thr, const int* bounds, int n_leaves, const int* seeds,
            const float* scales, float sigma_s, float* up, float* newr,
            int* nnz, int n) {
  upload_fused_kernel<S, L, N, Z><<<grid, kThreads, 0, stream>>>(
      flat, res, thr, bounds, n_leaves, seeds, scales, sigma_s, up, newr, nnz,
      n);
}

}  // namespace

// flags: bit 0 sparsify, bit 1 ldp (clip scale), bit 2 noise, bit 3 nnz.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int upload_fused_launch(const float* flat, const float* res,
                                   const float* thr, const int* bounds,
                                   int n_leaves, const int* seeds,
                                   const float* scales, float sigma_s,
                                   float* up, float* newr, int* nnz, int c,
                                   int n, int flags, void* stream_ptr) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  dim3 grid((n + kThreads - 1) / kThreads, c);
#define REPRO_CASE(F, S, L, N, Z)                                              \
  case F:                                                                      \
    launch<S, L, N, Z>(grid, stream, flat, res, thr, bounds, n_leaves, seeds,  \
                       scales, sigma_s, up, newr, nnz, n);                     \
    break;
  switch (flags) {
    REPRO_CASE(0, false, false, false, false)
    REPRO_CASE(1, true, false, false, false)
    REPRO_CASE(2, false, true, false, false)
    REPRO_CASE(3, true, true, false, false)
    REPRO_CASE(6, false, true, true, false)
    REPRO_CASE(7, true, true, true, false)
    REPRO_CASE(8, false, false, false, true)
    REPRO_CASE(9, true, false, false, true)
    REPRO_CASE(10, false, true, false, true)
    REPRO_CASE(11, true, true, false, true)
    REPRO_CASE(14, false, true, true, true)
    REPRO_CASE(15, true, true, true, true)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_CASE
  return (int)cudaGetLastError();
}

extern "C" const char* upload_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
