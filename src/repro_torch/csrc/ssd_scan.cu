// Mamba2 chunked SSD scan: for x (B, L, H, P), dt (B, L, H), B and C
// (B, L, N) shared by all heads, A (H,), from h_0 = 0,
//   h_t = exp(dt_t A_h) h_{t-1} + (dt_t x_t) (x) B_t,   y_t = h_t . C_t,
// computed chunk by chunk in the SSD form.
//
// Replaces the Pallas TPU kernel `repro/kernels/ssd_scan.py` (`ssd_scan`,
// body `_kernel`).  There one grid step owns (b, 8 heads, one chunk) with
// the chunk axis innermost and sequential, so the state h (bh, P, N) lives
// in VMEM scratch from one chunk to the next.  On Hopper the blocks of a
// grid run in no order, so here one thread block owns one (b, head) for the
// whole sequence and loops over the chunks, with the state resident in
// shared memory.  For each chunk of c steps, as the TPU kernel:
//   lcum = cumsum(dt * A)                                  (one warp)
//   M[t][s] = exp(lcum_t - lcum_s) (C_t . B_s) for s <= t, else 0
//   y_t = sum_s M[t][s] dx_s + (C_t . h) exp(lcum_t)       (dx_s = dt_s x_s)
//   h   = exp(lcum_last) h + sum_s B_s (dx_s exp(lcum_last - lcum_s))
// Each of the three products is a small matrix product out of shared
// memory, in which a thread owns a 4 x 4 tile of the output and reads its
// operands as float4 along the tile (four products per value read).  Only
// s <= t is computed: lcum falls with t, so exp(lcum_t - lcum_s) for s > t
// may overflow, and inf * 0 would be NaN where the TPU kernel masks with a
// select.  Steps past the end of the sequence read zeros (dt = 0, so they
// change nothing, as the TPU wrapper's zero padding) and write no y.
//
// All float32 on the CUDA cores, as the TPU kernel computes; exp is the
// precise expf.
//
// Shared memory (floats; c, P and N rounded up to multiples of 4, padding
// zero): C and B transposed (N x c each), dt * x (c x P), the state
// transposed (N x P), M transposed (c x c, later B as c x N), and lcum,
// exp(lcum_last - lcum) and dt (c each): 177 KB at zamba2's c = 128,
// P = N = 64, so one block of 256 threads on each SM.
//
// What bounds it on the card: operations.  At zamba2-1.2b's shape
// (8, 2048, 64, 64), N 64, chunk 128, bf16, the SSD form does
// 2 (c N / 2 + c P / 2 + 2 P N) operations per (b, h, t) (the diagonal
// term over s <= t), 4.4e10 in all against 0.28 GB of bytes: 0.65 ms at
// the float32 rate.  The three products are matmuls; a tensor-core kernel
// (a later redesign) would be bounded near 0.08 ms, by the bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  const void* x;
  const void* dt;
  const void* b;
  const void* c;
  const float* a;
  void* y;
  float* h;
  int B, L, H, P, N, chunk;
  long long xs[3];   // x strides of b, t, h (elements; p contiguous)
  long long dts[3];  // dt strides of b, t, h
  long long bs[2];   // B strides of b, t (n contiguous)
  long long cs[2];   // C strides of b, t
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

size_t smem_bytes(int c, int P, int N) {
  const size_t cp = round4(c), pp = round4(P), np = round4(N);
  return sizeof(float) * (2 * np * cp + cp * pp + np * pp +
                          cp * (cp > np ? cp : np) + 3 * cp);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += a[i] * b[j]
__device__ __forceinline__ void outer4(float acc[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const Params p) {
  const int c = p.chunk, P = p.P, N = p.N;
  const int cp = round4(c), pp = round4(P), np = round4(N);
  extern __shared__ float4 smem4[];
  float* Ct = reinterpret_cast<float*>(smem4);  // [np][cp]  C transposed
  float* Bt = Ct + np * cp;                     // [np][cp]  B transposed
  float* dx = Bt + np * cp;                     // [cp][pp]  dt_s * x_s
  float* hT = dx + cp * pp;                     // [np][pp]  the state, h[p][n]
  float* Mt = hT + np * pp;                     // [cp][cp]  M[t][s] at [s][t]
  float* Bs = Mt;                               // [cp][np]  B, after M is read
  float* lc = Mt + cp * (cp > np ? cp : np);    // [cp]      lcum
  float* wt = lc + cp;                          // [cp]      exp(last - lcum)
  float* ds = wt + cp;                          // [cp]      dt

  const int tid = threadIdx.x;
  const int hh = blockIdx.x, b = blockIdx.y;
  const float a = p.a[hh];
  const T* xp = static_cast<const T*>(p.x) + b * p.xs[0] + hh * p.xs[2];
  const T* dp = static_cast<const T*>(p.dt) + b * p.dts[0] + hh * p.dts[2];
  const T* bp = static_cast<const T*>(p.b) + b * p.bs[0];
  const T* cq = static_cast<const T*>(p.c) + b * p.cs[0];
  T* yp = static_cast<T*>(p.y) + (long long)b * p.L * p.H * P +
          (long long)hh * P;
  const long long yt = (long long)p.H * P;  // y's time stride
  const int c4 = cp / 4, p4 = pp / 4, n4 = np / 4;

  for (int e = tid; e < np * pp; e += kThreads) hT[e] = 0.0f;

  const int nc = (p.L + c - 1) / c;
  for (int ic = 0; ic < nc; ++ic) {
    const int t0 = ic * c;
    const int steps = min(c, p.L - t0);  // real steps in this chunk
    __syncthreads();  // the previous chunk's readers are done
    for (int s = tid; s < cp; s += kThreads)
      ds[s] = s < steps ? load_f32(dp + (t0 + s) * p.dts[1]) : 0.0f;
    for (int e = tid; e < np * cp; e += kThreads) {
      const int n = e / cp, s = e % cp;
      float bv = 0.0f, cv = 0.0f;
      if (n < N && s < steps) {
        bv = load_f32(bp + (t0 + s) * p.bs[1] + n);
        cv = load_f32(cq + (t0 + s) * p.cs[1] + n);
      }
      Bt[e] = bv;
      Ct[e] = cv;
    }
    __syncthreads();
    if (tid < 32) {  // lcum: each lane sums a run of steps, then a scan
      const int per = (cp + 31) / 32, s0 = tid * per;
      float run = 0.0f;
      for (int j = 0; j < per && s0 + j < cp; ++j) {
        run += ds[s0 + j] * a;
        lc[s0 + j] = run;
      }
      float tot = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, tot, o);
        if (tid >= o) tot += v;
      }
      const float off = tot - run;
      for (int j = 0; j < per && s0 + j < cp; ++j) lc[s0 + j] += off;
    }
    for (int e = tid; e < cp * pp; e += kThreads) {
      const int s = e / pp, q = e % pp;
      float xv = 0.0f;
      if (q < P && s < steps) xv = load_f32(xp + (t0 + s) * p.xs[1] + q);
      dx[e] = ds[s] * xv;
    }
    __syncthreads();
    const float last = lc[cp - 1];
    for (int s = tid; s < cp; s += kThreads) wt[s] = expf(last - lc[s]);

    // M = exp(lcum_t - lcum_s) (C_t . B_s), s <= t, stored transposed.
    for (int tile = tid; tile < c4 * c4; tile += kThreads) {
      const int t_0 = 4 * (tile % c4), s_0 = 4 * (tile / c4);
      float acc[4][4] = {};
      if (s_0 <= t_0 + 3)
        for (int n = 0; n < N; ++n)
          outer4(acc, ld4(Ct + n * cp + t_0), ld4(Bt + n * cp + s_0));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s_0 + j;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t_0 + i;
          v[i] = s <= t ? expf(lc[t] - lc[s]) * acc[i][j] : 0.0f;
        }
        *reinterpret_cast<float4*>(Mt + s * cp + t_0) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();

    // y = M dx + (C h^T) exp(lcum_t), the old state.
    for (int tile = tid; tile < c4 * p4; tile += kThreads) {
      const int t_0 = 4 * (tile % c4), q_0 = 4 * (tile / c4);
      float acc[4][4] = {}, car[4][4] = {};
      const int kend = min(t_0 + 4, cp);
      for (int s = 0; s < kend; ++s)
        outer4(acc, ld4(Mt + s * cp + t_0), ld4(dx + s * pp + q_0));
      for (int n = 0; n < N; ++n)
        outer4(car, ld4(Ct + n * cp + t_0), ld4(hT + n * pp + q_0));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t_0 + i;
        if (t >= steps) continue;
        const float e = expf(lc[t]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (q_0 + j < P)
            store_f32(yp + (t0 + t) * yt + q_0 + j, acc[i][j] + car[i][j] * e);
      }
    }
    __syncthreads();  // M and the old state are read

    for (int e = tid; e < cp * np; e += kThreads) {  // B again, as [s][n]
      const int s = e / np, n = e % np;
      Bs[e] = n < N && s < steps ? load_f32(bp + (t0 + s) * p.bs[1] + n)
                                 : 0.0f;
    }
    __syncthreads();

    // h = exp(lcum_last) h + B^T (dx exp(lcum_last - lcum_s)).
    const float decay = expf(last);
    for (int tile = tid; tile < n4 * p4; tile += kThreads) {
      const int n_0 = 4 * (tile % n4), q_0 = 4 * (tile / n4);
      float acc[4][4] = {};
      for (int s = 0; s < cp; ++s) {
        const float w = wt[s];
        float4 d = ld4(dx + s * pp + q_0);
        d = make_float4(d.x * w, d.y * w, d.z * w, d.w * w);
        outer4(acc, ld4(Bs + s * np + n_0), d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* row = hT + (n_0 + i) * pp + q_0;
#pragma unroll
        for (int j = 0; j < 4; ++j) row[j] = decay * row[j] + acc[i][j];
      }
    }
  }
  __syncthreads();
  float* ho = p.h + ((long long)b * p.H + hh) * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    ho[e] = hT[(e % N) * pp + e / N];
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.chunk, p.P, p.N);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.H, p.B);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, L, H, P), dt (B, L, H), b and c (B, L, N) of one dtype
// (0 = float32, 1 = bfloat16), addressed through their strides (elements;
// the last dim contiguous); a (H,) float32; y (B, L, H, P) of x's dtype and
// h (B, H, P, N) float32, contiguous; chunk = min(chunk, L).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* b, const void* c,
    const float* a, void* y, float* h, int dtype, int B, int L, int H, int P,
    int N, int chunk, long long xs0, long long xs1, long long xs2,
    long long dts0, long long dts1, long long dts2, long long bs0,
    long long bs1, long long cs0, long long cs1, void* stream_ptr) {
  if (B < 1 || B > 65535 || H < 1 || L < 1 || P < 1 || N < 1 || chunk < 1 ||
      chunk > L || smem_bytes(chunk, P, N) > 232448 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{x, dt, b, c, a, y, h, B, L, H, P, N, chunk,
           {xs0, xs1, xs2}, {dts0, dts1, dts2}, {bs0, bs1}, {cs0, cs1}};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return dtype == 0 ? launch<float>(p, stream)
                    : launch<__nv_bfloat16>(p, stream);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
