// Blocked causal / sliding-window GQA flash attention with an online softmax.
//
// Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py`
// (`flash_attention`, body `_kernel`).  There the grid is (B, H, q block,
// kv block) with the kv axis innermost and sequential, so m, l and the
// accumulator persist in VMEM scratch from one kv step to the next, and a
// kv block masked for the whole q block is skipped with `pl.when`.  On
// Hopper the blocks of a grid run in no order, so here one thread block owns
// one (b, h, 64-row q tile) and walks the relevant 64-key kv tiles in a loop,
// with m, l and its share of the accumulator in registers.  The loop bounds
// are the TPU kernel's block-relevance test (causal: first key <= last query
// of the tile; window: last key > first query - window), so fully masked
// tiles are never loaded.
//
// Arithmetic, as the TPU kernel's: q, k and v are read as float32 (bf16
// converted exactly), q is multiplied by float32(1/sqrt(D)) before QK^T,
// masked scores are -1e30 (not -inf), m/l/acc are float32, exp is the precise
// expf, and the output is acc / max(l, 1e-30) rounded once to q's dtype.
// The tiles are 64 x 64 where the TPU's are 128 x 128: a masked tile that one
// kernel computes and the other skips changes nothing once a row has a real
// key (its rescale exp(-1e30 - m) is exactly 0), so the two differ only in
// the order of float32 sums.
//
// Layout of the work: 128 threads; thread (rg, cg) = (tid / 8, tid % 8)
// computes scores for rows 4rg..4rg+3 and keys cg + 8j (j < 8) from float4
// reads along D of the Q and K tiles (row stride DP + 4 floats, so the eight
// key rows a quarter-warp reads fall in distinct banks), reduces row max and
// row sum over its eight lanes with shuffles, and writes P transposed to
// shared memory; then it accumulates P V for its 4 rows and DP / 8 output
// columns (float4 groups cg*4 + 32i).  q, k, v and the output are read and
// written through their strides (head dim contiguous), so the model's
// (B, S, H, D) views go in without a copy.
//
// What bounds it on the card: operations.  At smollm-360m's shape (8 x 15
// heads x 2048 x 64 over 5 KV heads, causal) the work is 4*B*H*D*Sq(Sq+1)/2 =
// 64.5 GFLOP against 84 MB of bytes.  This first kernel computes in float32
// on the CUDA cores (67 TFLOP/s, about 1 ms for that work), where a bf16
// tensor-core kernel would be bounded near 0.07 ms.  What it leaves on the
// table: tensor cores (mma/wgmma for QK^T, exact on bf16 inputs), register
// tiles larger than 4 x 8 (shared-memory reads, not FMAs, set its pace),
// cp.async/TMA double buffering of the K/V tiles, and scalar global loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Sk, D;
  long long qs[3], ks[3], vs[3], os[3];  // strides of dims 0..2, in elements
  int causal, window;
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (DP + 4) + 2 * (size_t)kBK * (DP + 4) +
                          (size_t)kBK * (kBQ + 4));
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params P) {
  constexpr int LD = DP + 4;   // row stride of the Q, K and V tiles (floats)
  constexpr int LP = kBQ + 4;  // row stride of the transposed P tile
  constexpr int NC = DP / 8;   // output columns a thread owns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Pt = Vs + kBK * LD;   // [key][row]

  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;
  const int nq = (P.Sq + kBQ - 1) / kBQ;
  const int iq = nq - 1 - (int)blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (P.H / P.KV);
  const int q0 = iq * kBQ;
  const T* qp = static_cast<const T*>(P.q) + b * P.qs[0] + h * P.qs[1];
  const T* kp = static_cast<const T*>(P.k) + b * P.ks[0] + kvh * P.ks[1];
  const T* vp = static_cast<const T*>(P.v) + b * P.vs[0] + kvh * P.vs[1];
  T* op = static_cast<T*>(P.o) + b * P.os[0] + h * P.os[1];

  for (int e = tid; e < kBQ * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    float x = 0.0f;
    if (q0 + r < P.Sq && d < P.D)
      x = load_f32(qp + (q0 + r) * P.qs[2] + d) * P.scale;
    Qs[r * LD + d] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int nk = (P.Sk + kBK - 1) / kBK;
  int k_end = nk, k_beg = 0;
  if (P.causal) k_end = min(nk, (q0 + kBQ - 1) / kBK + 1);
  if (P.window > 0) {  // first tile with last key > first query - window
    const int t = q0 - P.window - kBK + 1;
    k_beg = t < 0 ? 0 : t / kBK + 1;
  }

  for (int j = k_beg; j < k_end; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * DP; e += kThreads) {
      const int c = e / DP, d = e % DP;
      float xk = 0.0f, xv = 0.0f;
      if (k0 + c < P.Sk && d < P.D) {
        xk = load_f32(kp + (k0 + c) * P.ks[2] + d);
        xv = load_f32(vp + (k0 + c) * P.vs[2] + d);
      }
      Ks[c * LD + d] = xk;
      Vs[c * LD + d] = xv;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (rg * 4 + i) * LD + d);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        kv[c] = *reinterpret_cast<const float4*>(Ks + (cg + 8 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kpos = k0 + cg + 8 * c;
        bool ok = kpos < P.Sk;
        if (P.causal) ok = ok && kpos <= qpos;
        if (P.window > 0) ok = ok && kpos > qpos - P.window;
        if (!ok) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        rs += s[i][c];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<float4*>(Pt + (cg + 8 * c) * LP + rg * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + c * LP + rg * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < NC / 4; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + c * LD + cg * 4 + 32 * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g + 0] = fmaf(pr[i], vv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pr[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pr[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pr[i], vv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r >= P.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NC / 4; ++g)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int d = cg * 4 + 32 * g + t;
        if (d < P.D) store_f32(op + r * P.os[2] + d, acc[i][4 * g + t] / lc);
      }
  }
}

template <typename T, int DP>
int launch(const Params& P, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((P.Sq + kBQ - 1) / kBQ, P.H, P.B);
  flash_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Params& P, cudaStream_t stream) {
  if (P.D <= 32) return launch<T, 32>(P, stream);
  if (P.D <= 64) return launch<T, 64>(P, stream);
  if (P.D <= 96) return launch<T, 96>(P, stream);
  return launch<T, 128>(P, stream);
}

}  // namespace

// q (B, H, Sq, D), k and v (B, KV, Sk, D), o (B, H, Sq, D), all of one dtype
// (0 = float32, 1 = bfloat16), addressed through the strides of their first
// three dims (elements; the head dim is contiguous).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KV, int Sq, int Sk, int D, long long qs0, long long qs1,
    long long qs2, long long ks0, long long ks1, long long ks2, long long vs0,
    long long vs1, long long vs2, long long os0, long long os1, long long os2,
    int causal, int window, float scale, void* stream_ptr) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || KV < 1 || H % KV ||
      Sq < 1 || Sk < 1 || D < 1 || D > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params P{q, k, v, o, B, H, KV, Sq, Sk, D,
           {qs0, qs1, qs2}, {ks0, ks1, ks2}, {vs0, vs1, vs2}, {os0, os1, os2},
           causal, window, scale};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return dtype == 0 ? launch_d<float>(P, stream)
                    : launch_d<__nv_bfloat16>(P, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
