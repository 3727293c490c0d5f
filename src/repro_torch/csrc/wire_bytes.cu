// Per-row nonzero count of a stacked (K, N) cohort: what the wire codecs price.
//
// Replaces the Pallas TPU kernel `repro/kernels/wire_bytes.py`
// (`nnz_fleet`, body `_fleet_kernel`), which walks each row in
// (256 x 1024) blocks on a sequential grid axis and adds each block's count
// into a revisited output.  `x != 0.0f` is the test, so -0.0 is not counted
// and NaN is.
//
// What bounds it on the card: bytes.  It reads the cohort once (4 bytes an
// element) and writes K ints; at (1000, 20490) that is 81.96 MB, 0.0245 ms
// at 3.35 TB/s.  The count itself is a compare and an add an element.  So
// the design spends everything on keeping reads in flight:
// - each thread issues four 16-byte streaming loads (`__ldcs`) before it
//   counts any of them, 64 bytes a thread in flight;
// - rows start on any 4-byte boundary (the paper CNN's P = 20,490 is 2 mod
//   4, so every other row starts 8 bytes off one), so each block's segment
//   splits into a scalar head up to its first 16-byte boundary, computed
//   from its own address, whole 16-byte vectors, and a scalar tail; K3
//   only reads, so it takes any alignment and the wrapper copies nothing;
// - the grid is sized to the card by the wrapper (`nnz_grid`): where the K
//   rows alone fill one wave of blocks (four of 512 threads an SM), one
//   block owns a row and writes its count directly, with no zeroed output
//   and no atomics; where they do not (one or two long rows), each row
//   splits over several blocks that add into a zeroed output with one
//   integer atomic each, exact in any order;
// - a block sums its warps with `redux.sync` (`__reduce_add_sync`) and one
//   barrier.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread

__device__ __forceinline__ int nonzeros(float4 q) {
  return (q.x != 0.0f) + (q.y != 0.0f) + (q.z != 0.0f) + (q.w != 0.0f);
}

// Block (part, row) counts positions [part * chunk, min(n, (part + 1) *
// chunk)) of its row.  kSplit: several blocks a row, added atomically.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
nnz_kernel(const float* __restrict__ x, int* __restrict__ nnz, uint32_t n,
           uint32_t chunk) {
  __shared__ int s_warp[kThreads / 32];
  const uint32_t row = blockIdx.y;
  const float* r = x + (size_t)row * n;
  const uint32_t lo = blockIdx.x * chunk;
  const uint32_t hi = min(lo + chunk, n);
  // The segment's first 16-byte boundary, from its own address.
  const uint32_t skew = (uint32_t)((uintptr_t)(r + lo) >> 2) & 3u;
  const uint32_t a = min(lo + ((4u - skew) & 3u), hi);
  const uint32_t vecs = (hi - a) >> 2;
  const uint32_t b = a + 4 * vecs;
  int cnt = 0;
  if (threadIdx.x < a - lo) cnt += r[lo + threadIdx.x] != 0.0f;
  if (threadIdx.x < hi - b) cnt += r[b + threadIdx.x] != 0.0f;
  const float4* v = reinterpret_cast<const float4*>(r + a);
  uint32_t i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < vecs; i += kUnroll * kThreads) {
    float4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = __ldcs(v + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cnt += nonzeros(q[u]);
  }
  for (; i < vecs; i += kThreads) cnt += nonzeros(__ldcs(v + i));
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x < 32) {
    int t = threadIdx.x < kThreads / 32 ? s_warp[threadIdx.x] : 0;
    t = __reduce_add_sync(0xffffffffu, t);
    if (threadIdx.x == 0) {
      if (!kSplit)
        nnz[row] = t;
      else if (t)
        atomicAdd(nnz + row, t);
    }
  }
}

}  // namespace

// x (k, n) float32 row-major, any 4-byte alignment; nnz (k,) int32.  Each
// row splits over `blocks_per_row` blocks of `chunk` positions (the last
// one shorter), every one non-empty; with more than one block a row nnz
// must be zeroed by the caller, with one it is written whole.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int nnz_launch(const float* x, int* nnz, int k, int n,
                          int blocks_per_row, int chunk, void* stream_ptr) {
  if (k < 1 || k > 65535 || n < 1 || blocks_per_row < 1 || chunk < 1 ||
      (long long)(blocks_per_row - 1) * chunk >= n ||
      (long long)blocks_per_row * chunk < n)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks_per_row, (unsigned)k);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (blocks_per_row > 1)
    nnz_kernel<true><<<grid, kThreads, 0, stream>>>(x, nnz, (uint32_t)n,
                                                    (uint32_t)chunk);
  else
    nnz_kernel<false><<<grid, kThreads, 0, stream>>>(x, nnz, (uint32_t)n,
                                                     (uint32_t)chunk);
  return (int)cudaGetLastError();
}

extern "C" const char* nnz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
