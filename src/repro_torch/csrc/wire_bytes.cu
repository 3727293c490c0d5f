// Per-row nonzero count of a stacked (K, N) cohort: what the wire codecs price.
//
// Replaces the Pallas TPU kernel `repro/kernels/wire_bytes.py`
// (`nnz_fleet`, body `_fleet_kernel`), which walks each row in
// (256 x 1024) blocks on a sequential grid axis and adds each block's count
// into a revisited output.  On Hopper blocks run in no order, so each block
// here counts a grid-stride slice of one row (blockIdx.y = row), reduces by
// warp shuffles and shared memory, and adds its total into a zeroed int32[K]
// with one integer atomicAdd: integer atomics keep the count exact whatever
// order the blocks finish in.  `x != 0.0f` is the test, so -0.0 is not
// counted and NaN is.
//
// What bounds it on the card: bytes.  It reads the cohort once (4 bytes an
// element) and writes K ints; at (1000, 20490) that is 81.96 MB, 0.0245 ms
// at 3.35 TB/s.  What the simple design leaves on the table: scalar 4-byte
// loads (rows of odd length are not 16-byte aligned, so no float4 loads
// without a peeled head), and a block count fixed at about eight elements a
// thread rather than sized to the card's 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

__global__ void __launch_bounds__(kThreads)
nnz_kernel(const float* __restrict__ x, int* __restrict__ nnz, int64_t n) {
  __shared__ int s_warp[kThreads / 32];
  const float* row = x + (int64_t)blockIdx.y * n;
  int cnt = 0;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * blockDim.x)
    cnt += (row[p] != 0.0f);
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = threadIdx.x < (blockDim.x >> 5) ? s_warp[threadIdx.x] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (threadIdx.x == 0 && v) atomicAdd(nnz + blockIdx.y, v);
  }
}

}  // namespace

// x (k, n) float32 row-major; nnz (k,) int32, zeroed by the caller.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int nnz_launch(const float* x, int* nnz, int k, long long n,
                          void* stream_ptr) {
  if (k < 1 || k > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * kPerThread;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 65535) blocks = 65535;
  dim3 grid((unsigned)blocks, (unsigned)k);
  nnz_kernel<<<grid, kThreads, 0, (cudaStream_t)stream_ptr>>>(x, nnz, n);
  return (int)cudaGetLastError();
}

extern "C" const char* nnz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
