// Mamba1 selective scan: h_t = exp(dt_t * A) o h_{t-1} + (dt_t * x_t) (x) B_t,
// y_t = h_t . C_t, from h_0 = 0, for x, dt (B, L, D), B, C (B, L, N),
// A (D, N).
//
// Replaces the Pallas TPU kernel `repro/kernels/selective_scan.py`
// (`selective_scan`, body `_kernel`).  There one grid step owns (b, a block
// of 256 channels, a block of 128 time steps) with the time axis innermost
// and sequential, so the state h (bd, N) lives in VMEM scratch from one step
// of the grid to the next.  On Hopper the blocks of a grid run in no order,
// so here one thread block owns (b, a run of channels) for the whole
// sequence and walks t = 0 .. L-1 in a loop, with the state in registers.
//
// Layout of the work: each channel's N states are spread over N / NPT lanes
// (NPT = min(8, N) states in each lane's registers); a block of 128
// threads holds 128 / (N / NPT) channels.  At falcon-mamba's N = 16 that is
// 2 lanes a channel, 64 channels a block and 512 blocks (the fastest of 1,
// 2, 4, 8 and 16 states a lane at that shape on an H100).  A tile of 32
// time steps of B and C (shared by the block's channels) and of x and dt
// (the block's channels, read coalesced along d) is staged in shared
// memory; each step's y is reduced over the channel's lanes by shuffles
// and staged, and the tile's y is written coalesced.  Ragged L and D are
// bounds checks, not padding (the TPU wrapper's padded steps have dt = 0
// and change nothing).
//
// Arithmetic, as the plain version's: inputs read as float32 (bf16
// converted exactly), the decay expf(dt * A) with the precise expf, the
// update rounded as a product, a product and a sum (__fmul_rn / __fadd_rn,
// so the compiler contracts nothing into an fma), y summed in float32 and
// rounded once to x's dtype, h_final in float32.
//
// What bounds it on the card: at falcon-mamba-7b's shape (4, 2048, 8192),
// N 16, bf16, the bytes are x, dt and y (134 MB each) and the work 1.07e9
// (t, d, n) states, each an expf, three products, a sum and the y fma: both
// bounds near 0.12 ms.  The sequential time axis is the real limit: each
// lane runs a 2,048-step dependent chain, so the card must keep many
// channels in flight (32,768 channels x N / NPT lanes) to hide it; the
// precise expf per state and step is the likely pace-setter (unmeasured).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTL = 32;   // time steps per staged tile
constexpr int kNPT = 8;   // states per lane (fewer when N < 8)

struct Params {
  const void* x;
  const void* dt;
  const void* b;
  const void* c;
  const float* a;
  void* y;
  float* h;
  int B, L, D, N;
  long long xs[2], dts[2], bs[2], cs[2];  // batch and time strides (elements)
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int NPT>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const Params P) {
  const int lpc = P.N / NPT;        // lanes per channel
  const int cpb = kThreads / lpc;   // channels per block
  extern __shared__ float smem[];
  float* Bs = smem;                 // [kTL][N]
  float* Cs = Bs + kTL * P.N;       // [kTL][N]
  float* Xs = Cs + kTL * P.N;       // [kTL][cpb]
  float* Ds = Xs + kTL * cpb;       // [kTL][cpb]
  float* Ys = Ds + kTL * cpb;       // [kTL][cpb]

  const int tid = threadIdx.x;
  const int part = tid % lpc, cl = tid / lpc;
  const int d0 = blockIdx.x * cpb, d = d0 + cl, b = blockIdx.y;
  const bool live = d < P.D;
  const int n0 = part * NPT;
  const T* xp = static_cast<const T*>(P.x) + b * P.xs[0];
  const T* dp = static_cast<const T*>(P.dt) + b * P.dts[0];
  const T* bp = static_cast<const T*>(P.b) + b * P.bs[0];
  const T* cp = static_cast<const T*>(P.c) + b * P.cs[0];
  T* yp = static_cast<T*>(P.y) + (long long)b * P.L * P.D;

  float a[NPT], h[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    a[j] = live ? P.a[(long long)d * P.N + n0 + j] : 0.0f;
    h[j] = 0.0f;
  }

  for (int t0 = 0; t0 < P.L; t0 += kTL) {
    const int steps = min(kTL, P.L - t0);
    __syncthreads();  // the previous tile's readers and writers are done
    for (int e = tid; e < steps * P.N; e += kThreads) {
      const int s = e / P.N, n = e % P.N;
      Bs[e] = load_f32(bp + (t0 + s) * P.bs[1] + n);
      Cs[e] = load_f32(cp + (t0 + s) * P.cs[1] + n);
    }
    for (int e = tid; e < steps * cpb; e += kThreads) {
      const int s = e / cpb, dd = d0 + e % cpb;
      float xv = 0.0f, dv = 0.0f;
      if (dd < P.D) {
        xv = load_f32(xp + (t0 + s) * P.xs[1] + dd);
        dv = load_f32(dp + (t0 + s) * P.dts[1] + dd);
      }
      Xs[e] = xv;
      Ds[e] = dv;
    }
    __syncthreads();

    for (int s = 0; s < steps; ++s) {
      const float dtv = Ds[s * cpb + cl];
      const float dxv = __fmul_rn(dtv, Xs[s * cpb + cl]);
      const float* bt = Bs + s * P.N + n0;
      const float* ct = Cs + s * P.N + n0;
      float y = 0.0f;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float decay = expf(__fmul_rn(dtv, a[j]));
        h[j] = __fadd_rn(__fmul_rn(decay, h[j]), __fmul_rn(dxv, bt[j]));
        y = fmaf(h[j], ct[j], y);
      }
      for (int o = 1; o < lpc; o <<= 1)
        y += __shfl_xor_sync(0xffffffffu, y, o);
      if (part == 0) Ys[s * cpb + cl] = y;
    }
    __syncthreads();
    for (int e = tid; e < steps * cpb; e += kThreads) {
      const int s = e / cpb, dd = d0 + e % cpb;
      if (dd < P.D) store_f32(yp + (long long)(t0 + s) * P.D + dd, Ys[e]);
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      P.h[((long long)b * P.D + d) * P.N + n0 + j] = h[j];
  }
}

template <typename T, int NPT>
int launch(const Params& P, cudaStream_t stream) {
  const int lpc = P.N / NPT, cpb = kThreads / lpc;
  const size_t bytes = sizeof(float) * (size_t)kTL * (2 * P.N + 3 * cpb);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        selective_scan_kernel<T, NPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P.D + cpb - 1) / cpb, P.B);
  selective_scan_kernel<T, NPT><<<grid, kThreads, bytes, stream>>>(P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_npt(const Params& P, int npt, cudaStream_t stream) {
  switch (npt) {
    case 1: return launch<T, 1>(P, stream);
    case 2: return launch<T, 2>(P, stream);
    case 4: return launch<T, 4>(P, stream);
    default: return launch<T, kNPT>(P, stream);
  }
}

}  // namespace

// x, dt (B, L, D) and b, c (B, L, N) of one dtype (0 = float32,
// 1 = bfloat16), addressed through their batch and time strides (elements;
// the last dim contiguous); a (D, N) float32; y (B, L, D) of x's dtype and
// h (B, D, N) float32, contiguous; N a power of two up to 256.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int selective_scan_launch(
    const void* x, const void* dt, const void* b, const void* c,
    const float* a, void* y, float* h, int dtype, int B, int L, int D, int N,
    long long xs0, long long xs1, long long dts0, long long dts1,
    long long bs0, long long bs1, long long cs0, long long cs1,
    void* stream_ptr) {
  if (B < 1 || B > 65535 || L < 1 || D < 1 || N < 1 || (N & (N - 1)) ||
      N / kNPT > 32 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params P{x, dt, b, c, a, y, h, B, L, D, N,
           {xs0, xs1}, {dts0, dts1}, {bs0, bs1}, {cs0, cs1}};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int npt = N < kNPT ? N : kNPT;
  return dtype == 0 ? launch_npt<float>(P, npt, stream)
                    : launch_npt<__nv_bfloat16>(P, npt, stream);
}

extern "C" const char* selective_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
