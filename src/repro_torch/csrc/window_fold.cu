// Arrival-ordered window fold of the async engine (Eq. (6) / mix_stale).
//
// Replaces the Pallas TPU kernel `repro/kernels/window_fold.py`
// (`window_fold_fleet`, body `_fold_kernel`).  For each parameter p, in
// arrival order i = 0..C-1:
//   cur = gate_i ? fma(a_i, cur, b_i * omega[i, p]) : cur;  seq[i, p] = cur
// and the final value is written to out[p].
//
// What bounds it on the card: device memory.  The fold is sequential
// along the arrivals and, to stay bitwise, cannot be reassociated into a
// parallel scan, so the parallelism is one thread per parameter: 20,490
// threads for the paper CNN, about five warps an SM.  The first design
// kept about four loads of omega in flight per thread (an unrolled loop),
// some 0.33 MB across the card, where covering the memory's latency at
// 3.35 TB/s takes about 2 MB (Little's law); it ran at a sixth of the byte
// bound.  Here each thread keeps kDepth = 32 arrivals of its column in
// flight ahead of the fold (2.6 MB across the card): 4-byte cp.async
// copies into a ring in shared memory, one commit group per arrival, and
// cp.async.wait_group to take the oldest.  Each thread reads back only
// what it copied itself, so the ring needs no barrier, and a 4-byte copy
// needs no alignment beyond the element's (rows of an N that is not a
// multiple of 4 start anywhere).  On an H100 a deeper ring (64), blocks
// of 32 or 64 columns, a ring of registers, and 2 or 4 columns a thread
// with 8- and 16-byte copies all measured no faster, and an L2 left clean
// before the call does not move it (PERF.md): what sets its pace now is
// neither latency cover nor the L2, and most likely the memory's rate on
// 20,490 short strided streams (unmeasured).  The gates
// and coefficients are staged in shared memory in chunks of 1,024
// arrivals; the ring runs on across chunks.  The multiply-add is written
// out as __fmaf_rn(a, cur, b*om): the compiled reference computes exactly
// that contraction, and leaving it to nvcc's own contraction would round
// differently.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDepth = 32;
constexpr int kChunk = 1024;
static_assert(kChunk % kDepth == 0, "a chunk holds whole ring turns");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__global__ void __launch_bounds__(kThreads)
window_fold_kernel(const float* __restrict__ p, const float* __restrict__ om,
                   const int* __restrict__ gates, const float* __restrict__ a,
                   const float* __restrict__ b, float* __restrict__ seq,
                   float* __restrict__ out, int c, int n) {
  __shared__ int s_gate[kChunk];
  __shared__ float s_a[kChunk];
  __shared__ float s_b[kChunk];
  __shared__ float ring[kDepth][kThreads];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool live = j < n;
  const float* col = om + j;  // arrival i of this column: col[i * n]
  float* seq_col = seq + j;
  float cur = live ? p[j] : 0.0f;

  // Arrivals 0 .. kDepth - 2 into the ring, one commit group each.
#pragma unroll
  for (int k = 0; k < kDepth - 1; ++k) {
    if (live && k < c)
      cp_async4(&ring[k][threadIdx.x], col + (size_t)k * n);
    cp_async_commit();
  }

  for (int base = 0; base < c; base += kChunk) {
    const int len = min(kChunk, c - base);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) {
      s_gate[i] = gates[base + i];
      s_a[i] = a[base + i];
      s_b[i] = b[base + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int turn = 0; turn < len; turn += kDepth) {
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const int at = turn + k;        // this arrival, within the chunk
        if (at >= len) break;
        const int i = base + at;
        // Arrival i + kDepth - 1 into the slot arrival i - 1 left.
        if (i + kDepth - 1 < c)
          cp_async4(&ring[(k + kDepth - 1) % kDepth][threadIdx.x],
                    col + (size_t)(i + kDepth - 1) * n);
        cp_async_commit();
        cp_async_wait<kDepth - 1>();    // arrival i's group has landed
        const float w = ring[k][threadIdx.x];
        if (s_gate[at]) cur = __fmaf_rn(s_a[at], cur, __fmul_rn(s_b[at], w));
        seq_col[(size_t)i * n] = cur;
      }
    }
  }
  cp_async_wait<0>();
  if (live) out[j] = cur;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int window_fold_launch(const float* p, const float* om,
                                  const int* gates, const float* a,
                                  const float* b, float* seq, float* out,
                                  int c, int n, void* stream_ptr) {
  if (c < 1 || n < 1) return (int)cudaErrorInvalidValue;
  window_fold_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream_ptr>>>(p, om, gates, a, b, seq,
                                                   out, c, n);
  return (int)cudaGetLastError();
}

extern "C" const char* window_fold_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
