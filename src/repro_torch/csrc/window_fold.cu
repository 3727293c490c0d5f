// Arrival-ordered window fold of the async engine (Eq. (6) / mix_stale).
//
// Replaces the Pallas TPU kernel `repro/kernels/window_fold.py`
// (`window_fold_fleet`, body `_fold_kernel`).  For each parameter p, in
// arrival order i = 0..C-1:
//   cur = gate_i ? fma(a_i, cur, b_i * omega[i, p]) : cur;  seq[i, p] = cur
// and the final value is written to out[p].
//
// What bounds it on the card: bytes (read omega, write one snapshot per
// arrival: 8 bytes per element per arrival; two flops each).  The TPU ran
// the arrivals as a sequential grid axis with the accumulator tile resident
// in VMEM; here each thread owns one parameter and loops over the arrivals
// itself, so the running value stays in a register and never round-trips
// device memory.  Loads of omega and stores of seq are coalesced along p,
// and the per-arrival gates and coefficients are staged in shared memory in
// chunks.  The multiply-add is written out as __fmaf_rn(a, cur, b*om): the
// compiled reference computes exactly that contraction, and leaving it to
// nvcc's own contraction would round differently.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;

__global__ void __launch_bounds__(kThreads)
window_fold_kernel(const float* __restrict__ p, const float* __restrict__ om,
                   const int* __restrict__ gates, const float* __restrict__ a,
                   const float* __restrict__ b, float* __restrict__ seq,
                   float* __restrict__ out, int c, int n) {
  __shared__ int s_gate[kChunk];
  __shared__ float s_a[kChunk];
  __shared__ float s_b[kChunk];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  float cur = j < n ? p[j] : 0.0f;
  for (int base = 0; base < c; base += kChunk) {
    const int len = min(kChunk, c - base);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      s_gate[i] = gates[base + i];
      s_a[i] = a[base + i];
      s_b[i] = b[base + i];
    }
    __syncthreads();
    if (j < n) {
      const float* om_col = om + (size_t)base * n + j;
      float* seq_col = seq + (size_t)base * n + j;
#pragma unroll 4
      for (int i = 0; i < len; ++i) {
        const float w = om_col[(size_t)i * n];
        if (s_gate[i]) cur = __fmaf_rn(s_a[i], cur, __fmul_rn(s_b[i], w));
        seq_col[(size_t)i * n] = cur;
      }
    }
  }
  if (j < n) out[j] = cur;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int window_fold_launch(const float* p, const float* om,
                                  const int* gates, const float* a,
                                  const float* b, float* seq, float* out,
                                  int c, int n, void* stream_ptr) {
  dim3 grid((n + kThreads - 1) / kThreads);
  window_fold_kernel<<<grid, kThreads, 0, (cudaStream_t)stream_ptr>>>(
      p, om, gates, a, b, seq, out, c, n);
  return (int)cudaGetLastError();
}

extern "C" const char* window_fold_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
