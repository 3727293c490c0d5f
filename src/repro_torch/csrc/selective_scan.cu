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
// 2 lanes a channel, 64 channels a block, 512 blocks, all resident at once
// (15.5 warps an SM, at most 128 registers a thread so that four blocks
// share an SM), each lane with eight independent state chains a step.  N
// is a template parameter, so the lanes a channel, the channels a block,
// the shuffles and every shared-memory offset are constants.
//
// The time axis goes in tiles of 32 steps, double-buffered in shared
// memory: the next tile's x, dt (the block's channels) and B, C (shared by
// the block's channels) are in flight by `cp.async` while this tile is
// scanned, in 4-byte granules (a bf16 pair, zero-filled past the sequence
// and past D), so a warp never waits on device memory between tiles; where
// a row does not start on a 4-byte boundary the tile is read by element
// loads instead (same tile).  x and dt stay in their own type in shared
// memory and are converted where a lane reads them (one value a step); B
// and C are converted once a tile into float32 rows that every lane reads
// as float4.  Steps past the end of the sequence read dt = 0 and B = 0, so
// they leave h as it is (exp(0) = 1, 1 * h + 0 = h) and the scan always
// runs whole tiles.  Each step's y is reduced over the channel's lanes by
// shuffles into a float32 tile, written in 16-byte runs of the block's
// channels where the rows allow (element stores at a ragged edge).
//
// Arithmetic, as the plain version's: inputs read as float32 (bf16
// converted exactly), the decay expf(dt * A) with the precise expf, the
// update rounded as a product, a product and a sum (__fmul_rn / __fadd_rn,
// so the compiler contracts nothing into an fma), y summed in float32 and
// rounded once to x's dtype, h_final in float32.  The time axis is not
// split: every state is the sequential recursion of the plain version.
//
// What bounds it on the card: at falcon-mamba-7b's shape (4, 2048, 8192),
// N 16, bf16, the bytes are x, dt and y (134 MB each): 0.121 ms.  The work
// is 1.07e9 (t, d, n) state-steps, each a product, the precise expf (eight
// instructions, one of them on the special-function unit), three rounded
// operations and the y fma, about 15 instructions a state-step with the
// step's loads and shuffle: instruction issue at the SM clock, not bytes,
// bounds it (chip_smoke.py prints the estimate from this library's SASS).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // blocks an SM: at most 128 registers a thread
constexpr int kTL = 32;        // time steps per tile
constexpr int kNPT = 8;        // states per lane (fewer when N < 8)

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
  int vec;  // every row of x, dt, B and C starts on a 4-byte boundary
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4 bytes from global to shared memory, of which the first `bytes` are read
// and the rest zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// COLS values (at least 2 for bf16 with `vec`) of each of kTL rows (rows
// past `vrows` and columns past `vcols` zero) from src (row stride rs
// elements, columns contiguous) into dst ([kTL][COLS]): by cp.async in
// 4-byte granules with `vec`, else by element loads.
template <typename T, int COLS>
__device__ __forceinline__ void stage(T* dst, const T* src, long long rs,
                                      int vrows, int vcols, bool vec,
                                      int tid) {
  constexpr int G = 4 / sizeof(T);  // values a granule
  if (vec) {
    constexpr int PER = COLS / G;
    for (int e = tid; e < kTL * PER; e += kThreads) {
      const int r = e / PER, k = G * (e % PER);
      const int n = r < vrows ? min(G, vcols - k) : 0;
      const T* from = n > 0 ? src + r * rs + k : src;
      cp_async4(dst + r * COLS + k, from, n > 0 ? n * (int)sizeof(T) : 0);
    }
  } else {
    for (int e = tid; e < kTL * COLS; e += kThreads) {
      const int r = e / COLS, k = e % COLS;
      dst[e] = r < vrows && k < vcols ? src[r * rs + k] : T(0.0f);
    }
  }
}

// A lane's NPT values of a float32 row (16-byte aligned where NPT is a
// multiple of 4), as float4 loads where they fit.
template <int NPT>
__device__ __forceinline__ void load_row(float (&v)[NPT], const float* p) {
  if constexpr (NPT % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NPT; j += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + j);
      v[j] = u.x;
      v[j + 1] = u.y;
      v[j + 2] = u.z;
      v[j + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NPT; ++j) v[j] = p[j];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    selective_scan_kernel(const Params P) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NPT = N < kNPT ? N : kNPT;
  constexpr int LPC = N / NPT;         // lanes per channel
  constexpr int CPB = kThreads / LPC;  // channels per block
  constexpr int STAGE = kTL * (2 * CPB + 2 * N);  // one stage: X, Dt, B, C
  extern __shared__ float4 smem4[];
  float* Ys = reinterpret_cast<float*>(smem4);  // [kTL][CPB]
  float* Bf = Ys + kTL * CPB;                   // [kTL][N] (bf16 only)
  float* Cf = Bf + (kF32 ? 0 : kTL * N);        // [kTL][N] (bf16 only)
  T* raw = reinterpret_cast<T*>(Cf + (kF32 ? 0 : kTL * N));

  const int tid = threadIdx.x;
  const int part = tid % LPC, cl = tid / LPC;
  const int d0 = blockIdx.x * CPB, d = d0 + cl, b = blockIdx.y;
  const bool live = d < P.D;
  const int n0 = part * NPT;
  const int dcols = min(CPB, P.D - d0);  // the block's real channels
  const T* xp = static_cast<const T*>(P.x) + b * P.xs[0] + d0;
  const T* dp = static_cast<const T*>(P.dt) + b * P.dts[0] + d0;
  const T* bp = static_cast<const T*>(P.b) + b * P.bs[0];
  const T* cp = static_cast<const T*>(P.c) + b * P.cs[0];
  T* yp = static_cast<T*>(P.y) + (long long)b * P.L * P.D + d0;

  auto issue = [&](int t0) {  // tile t0's inputs into its stage
    T* st = raw + ((t0 / kTL) & 1) * STAGE;
    const int rows = min(kTL, P.L - t0);
    stage<T, CPB>(st, xp + t0 * P.xs[1], P.xs[1], rows, dcols, P.vec, tid);
    stage<T, CPB>(st + kTL * CPB, dp + t0 * P.dts[1], P.dts[1], rows, dcols,
                  P.vec, tid);
    stage<T, N>(st + 2 * kTL * CPB, bp + t0 * P.bs[1], P.bs[1], rows, N,
                P.vec, tid);
    stage<T, N>(st + 2 * kTL * CPB + kTL * N, cp + t0 * P.cs[1], P.cs[1],
                rows, N, P.vec, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // The tile's y: 16-byte runs of the block's channels where every run
  // starts on a 16-byte boundary, else element stores.
  auto drain = [&](int t0) {
    constexpr int V = 16 / sizeof(T);
    const int rows = min(kTL, P.L - t0);
    T* yt = yp + (long long)t0 * P.D;
    if (dcols == CPB && CPB % V == 0 && P.D % V == 0) {
      constexpr int PER = CPB / V;
      for (int e = tid; e < rows * PER; e += kThreads) {
        const int r = e / PER, k = V * (e % PER);
        const float* v = Ys + r * CPB + k;
        uint4 out;
        if constexpr (kF32) {
          out = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                           __float_as_uint(v[2]), __float_as_uint(v[3]));
        } else {
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 pr =
                __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
            w[i] = *reinterpret_cast<const uint32_t*>(&pr);
          }
          out = make_uint4(w[0], w[1], w[2], w[3]);
        }
        *reinterpret_cast<uint4*>(yt + (long long)r * P.D + k) = out;
      }
    } else {
      for (int e = tid; e < rows * CPB; e += kThreads) {
        const int r = e / CPB, k = e % CPB;
        if (k < dcols) yt[(long long)r * P.D + k] = T(Ys[e]);
      }
    }
  };

  float a[NPT], h[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    a[j] = live ? P.a[(long long)d * N + n0 + j] : 0.0f;
    h[j] = 0.0f;
  }

  issue(0);
  for (int t0 = 0; t0 < P.L; t0 += kTL) {
    const T* st = raw + ((t0 / kTL) & 1) * STAGE;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // tile t0 landed; the previous tile is scanned
    if (t0 + kTL < P.L) issue(t0 + kTL);
    const T* Xt = st;
    const T* Dt = st + kTL * CPB;
    const float* Bt;
    const float* Ct;
    if constexpr (kF32) {
      Bt = reinterpret_cast<const float*>(st + 2 * kTL * CPB);
      Ct = Bt + kTL * N;
    } else {
      const T* Br = st + 2 * kTL * CPB;
      for (int e = tid; e < kTL * N; e += kThreads) {
        Bf[e] = to_f32(Br[e]);
        Cf[e] = to_f32(Br[kTL * N + e]);
      }
      Bt = Bf;
      Ct = Cf;
    }
    if (t0 > 0) drain(t0 - kTL);
    __syncthreads();  // B and C converted, the previous y drained

#pragma unroll 2
    for (int s = 0; s < kTL; ++s) {
      const float dtv = to_f32(Dt[s * CPB + cl]);
      const float dxv = __fmul_rn(dtv, to_f32(Xt[s * CPB + cl]));
      float bt[NPT], ct[NPT];
      load_row<NPT>(bt, Bt + s * N + n0);
      load_row<NPT>(ct, Ct + s * N + n0);
      float y = 0.0f;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float decay = expf(__fmul_rn(dtv, a[j]));
        h[j] = __fadd_rn(__fmul_rn(decay, h[j]), __fmul_rn(dxv, bt[j]));
        y = fmaf(h[j], ct[j], y);
      }
#pragma unroll
      for (int o = 1; o < LPC; o <<= 1)
        y += __shfl_xor_sync(0xffffffffu, y, o);
      if (part == 0) Ys[s * CPB + cl] = y;
    }
  }
  __syncthreads();
  drain((P.L - 1) / kTL * kTL);

  if (live) {
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      P.h[((long long)b * P.D + d) * N + n0 + j] = h[j];
  }
}

template <typename T, int N>
int launch(const Params& P, cudaStream_t stream) {
  constexpr int NPT = N < kNPT ? N : kNPT;
  constexpr int CPB = kThreads / (N / NPT);
  constexpr size_t conv = std::is_same<T, float>::value ? 0 : 2 * kTL * N;
  constexpr size_t bytes = sizeof(float) * (kTL * CPB + conv) +
                           sizeof(T) * 2 * kTL * (2 * CPB + 2 * N);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        selective_scan_kernel<T, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P.D + CPB - 1) / CPB, P.B);
  selective_scan_kernel<T, N><<<grid, kThreads, bytes, stream>>>(P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const Params& P, cudaStream_t stream) {
  switch (P.N) {
    case 1: return launch<T, 1>(P, stream);
    case 2: return launch<T, 2>(P, stream);
    case 4: return launch<T, 4>(P, stream);
    case 8: return launch<T, 8>(P, stream);
    case 16: return launch<T, 16>(P, stream);
    case 32: return launch<T, 32>(P, stream);
    case 64: return launch<T, 64>(P, stream);
    case 128: return launch<T, 128>(P, stream);
    default: return launch<T, 256>(P, stream);
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
      N > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params P{x, dt, b, c, a, y, h, B, L, D, N,
           {xs0, xs1}, {dts0, dts1}, {bs0, bs1}, {cs0, cs1}, 1};
  if (dtype == 1) {  // bf16 pairs: every row on a 4-byte boundary
    if (N == 1) P.vec = 0;
    for (const void* p : {x, dt, b, c})
      if ((uintptr_t)p % 4) P.vec = 0;
    for (long long s : {xs0, xs1, dts0, dts1, bs0, bs1, cs0, cs1})
      if (s % 2) P.vec = 0;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return dtype == 0 ? launch_n<float>(P, stream)
                    : launch_n<__nv_bfloat16>(P, stream);
}

extern "C" const char* selective_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
