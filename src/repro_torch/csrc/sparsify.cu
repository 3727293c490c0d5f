// DGC split of a stacked (K, N) cohort at one threshold per row.
//
// Replaces the Pallas TPU kernels `repro/kernels/sparsify.py`
// (`sparsify_fleet`, body `_fleet_kernel`; `sparsify_flat`, body `_kernel`,
// which is the one-row case here).  Per row i and position p:
//   c = g + r (float32, rounded once); keep = |c| >= thr[i]
//   upload = keep ? c : 0;  residual' = keep ? 0 : c
// An element with c = -0.0 and thr = 0 is kept and uploaded as -0.0, as the
// reference's `where` does.
//
// What bounds it on the card: bytes.  It reads g and r and writes upload and
// residual' (16 bytes an element).  Over the paper CNN's six leaves at
// K = 1000 (one launch per leaf) that is 4 x 81.96 MB, 0.0979 ms at
// 3.35 TB/s.  The design is one thread per element, neighbouring threads on
// neighbouring addresses, blockIdx.y = row so the row's threshold is one
// load per thread from L1.  What it leaves on the table: scalar loads, and
// small leaves (16 or 10 elements a row) fill one block of 256 threads with
// mostly idle lanes, so those launches cost launch latency, not bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sparsify_kernel(const float* __restrict__ g, const float* __restrict__ r,
                const float* __restrict__ thr, float* __restrict__ up,
                float* __restrict__ newr, int64_t n) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int64_t at = (int64_t)blockIdx.y * n + p;
  const float c = __fadd_rn(g[at], r[at]);
  const bool keep = fabsf(c) >= thr[blockIdx.y];
  up[at] = keep ? c : 0.0f;
  newr[at] = keep ? 0.0f : c;
}

}  // namespace

// g, r, up, newr (k, n) float32 row-major; thr (k,) float32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int sparsify_launch(const float* g, const float* r,
                               const float* thr, float* up, float* newr, int k,
                               long long n, void* stream_ptr) {
  if (k < 1 || k > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)k);
  sparsify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream_ptr>>>(
      g, r, thr, up, newr, n);
  return (int)cudaGetLastError();
}

extern "C" const char* sparsify_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
