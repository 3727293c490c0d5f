// Blocked causal / sliding-window GQA flash attention with an online softmax,
// in two routes picked by dtype: bf16 on the tensor cores, float32 on the
// CUDA cores.
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
// tiles are never loaded.  q tiles run longest causal rows first.
//
// Arithmetic, as the TPU kernel's, on both routes: q, k and v are read as
// float32 (bf16 converted exactly), q is multiplied by float32(1/sqrt(D))
// before QK^T, masked scores are -1e30 (not -inf), m/l/acc are float32, p =
// exp(s - m) uses the precise expf, and the output is acc / max(l, 1e-30)
// rounded once to q's dtype.  The tiles are 64 x 64 where the TPU's are
// 128 x 128: a masked tile that one kernel computes and the other skips
// changes nothing once a row has a real key (its rescale exp(-1e30 - m) is
// exactly 0), so the two differ only in the order of float32 sums (on the
// bf16 route also in how the tensor cores round them, below).
//
// The route is a dispatch by type, not a fallback: tensor cores take no
// float32 operand exactly, so float32 inputs run the CUDA-core kernel and
// bf16 inputs the tensor-core kernel.  A refused launch on either route
// returns its cudaError_t.
//
// bf16 route (`flash_mma_kernel`): `mma.sync.m16n8k16` bf16 x bf16 -> f32.
// A bf16 x bf16 product is exact in float32, so QK^T forms the TPU kernel's
// own products.  Their sums differ from the TPU kernel's in order, and also
// in rounding: inside one MMA the tensor cores align the products and
// truncate them, and do not add in IEEE round-to-nearest float32.  No CPU
// model holds that rounding; the on-card checks bound the result
// (chip_smoke.py phase 3 and its per-layer check, tests/test_torch_cuda.py).
//   * QK^T.  x = float32(q) * scale is float32, so Q is staged as NT bf16
//     terms whose sum is x exactly: hi = bf16(x), mid = bf16(x - hi), lo =
//     bf16(x - hi - mid) (each difference exact in float32; hi and mid each
//     take 8 of x's 24 significant bits, and lo holds the last 8 exactly).
//     S = sum over terms of term K^T, one MMA per term.  Where the scale is
//     a power of two (D = 64: 1/8) x is a bf16 value, mid and lo are 0 and
//     the launch runs one term; otherwise three.
//   * PV.  p = exp(s - m) stays float32 as in the TPU kernel: each p is
//     split into hi = bf16(p) and lo = bf16(p - hi), two MMAs against bf16
//     V.  |p - hi - lo| <= 2^-16 p (each rounding keeps 8 bits); p is never
//     rounded to one bf16 value (SDPA does that, and it changes the
//     numbers).  l sums the float32 p.
//   * Work split: 4 warps, 16 query rows each.  K and V tiles (64 keys x DP,
//     D zero-padded to DP = 32, 64, 96 or 128) are double-buffered in shared
//     memory with 16-byte `cp.async` (zero-fill for keys >= Sk and columns
//     >= D) and read into fragments with `ldmatrix` (`.trans` for V).  Rows
//     are padded by 16 bytes, so the eight 16-byte rows an `ldmatrix` phase
//     reads fall in distinct banks.  S stays in the MMA accumulators: row
//     max and row sum are quad shuffles, and the accumulator layout of two
//     8-key tiles is the A fragment of the next 16-key PV step.
//   * Strides.  Inputs are read through their strides (head dim
//     contiguous), so the model's (B, S, H, D) views go in without a copy.
//     Where a pointer or a stride is not a multiple of 16 bytes, or D not a
//     multiple of 8, the same tiles are filled by element loads (template
//     flag VEC, chosen at launch): same values, same arithmetic.
//
// float32 route (`flash_kernel`): 128 threads; thread (rg, cg) = (tid / 8,
// tid % 8) computes scores for rows 4rg..4rg+3 and keys cg + 8j (j < 8)
// from float4 reads along D of the Q and K tiles (row stride DP + 4 floats,
// so the eight key rows a quarter-warp reads fall in distinct banks),
// reduces row max and row sum over its eight lanes with shuffles, and
// writes P transposed to shared memory; then it accumulates P V for its 4
// rows and DP / 8 output columns (float4 groups cg*4 + 32i).
//
// What bounds it on the card: operations.  At smollm-360m's shape (8 x 15
// heads x 2048 x 64 over 5 KV heads, causal) the work is 4*B*H*D*Sq(Sq+1)/2 =
// 64.5 GFLOP against 84 MB of bytes: 0.065 ms at the bf16 tensor-core rate.
// The bf16 route does 1.5x that work on the tensor cores (PV twice) and the
// softmax (a precise expf, the split, the rescale) on the CUDA cores beside
// it; `mma.sync` reaches well under `wgmma`'s rate.  On an H100 (700 W) it
// takes 0.52 ms there, 8x its bound and 2.9x SDPA (`chip_smoke.py`,
// PERF.md).  Left for later: `wgmma` with TMA loads and a warp-specialised
// producer.  The float32 route
// is bounded by the float32 rate (67 TFLOP/s) and reaches about a quarter
// of it: shared-memory reads, not FMAs, set its pace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bf16 route: the tensor-core kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, zeros where !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) x b (16 x 8, bf16, col).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values rounded to nearest-even bf16, ``x`` in the low half.
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p = hi + lo + r with hi = bf16(p), lo = bf16(p - hi), for two values.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2(x, y);
  lo = pack2(x - __uint_as_float(hi << 16),
             y - __uint_as_float(hi & 0xFFFF0000u));
}

// Q (NT terms) and two stages of K and V, rows of DP + 8 bf16 (the 16-byte
// pad puts the eight rows an `ldmatrix` phase reads in distinct banks).
template <int DP, int NT>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(NT * kBQ + 4 * kBK) * (DP + 8);
}

// K and V tile rows k0.. (64 keys x DP) into one stage, zeros for keys >= Sk
// and columns >= D.
template <int DP, bool VEC>
__device__ __forceinline__ void load_kv(__nv_bfloat16* Ks, __nv_bfloat16* Vs,
                                        const __nv_bfloat16* kp,
                                        const __nv_bfloat16* vp, int k0,
                                        const Params& P, int tid) {
  constexpr int LDS = DP + 8;
  if constexpr (VEC) {
    constexpr int CH = DP / 8;  // 16-byte chunks of a row
#pragma unroll
    for (int e = tid; e < kBK * CH; e += kThreads) {
      const int r = e / CH, c = e % CH;
      const bool ok = k0 + r < P.Sk && c * 8 < P.D;
      const long long rk = ok ? (k0 + r) * P.ks[2] + c * 8 : 0;
      const long long rv = ok ? (k0 + r) * P.vs[2] + c * 8 : 0;
      cp_async16(Ks + r * LDS + c * 8, kp + rk, ok);
      cp_async16(Vs + r * LDS + c * 8, vp + rv, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int e = tid; e < kBK * DP; e += kThreads) {
      const int r = e / DP, d = e % DP;
      __nv_bfloat16 xk = zero, xv = zero;
      if (k0 + r < P.Sk && d < P.D) {
        xk = kp[(k0 + r) * P.ks[2] + d];
        xv = vp[(k0 + r) * P.vs[2] + d];
      }
      Ks[r * LDS + d] = xk;
      Vs[r * LDS + d] = xv;
    }
  }
}

template <int DP, int NT, bool VEC>
__global__ void __launch_bounds__(kThreads) flash_mma_kernel(const Params P) {
  constexpr int LDS = DP + 8;  // row stride of a tile (bf16)
  constexpr int KC = DP / 16;  // 16-wide steps along D
  constexpr int NO = DP / 8;   // 8-wide output tiles along D
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [NT][64]
  __nv_bfloat16* Ks = Qs + NT * kBQ * LDS;                      // [2][64]
  __nv_bfloat16* Vs = Ks + 2 * kBK * LDS;                       // [2][64]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (P.Sq + kBQ - 1) / kBQ;
  const int iq = nq - 1 - (int)blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (P.H / P.KV);
  const int q0 = iq * kBQ;
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(P.q) + b * P.qs[0] + h * P.qs[1];
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(P.k) + b * P.ks[0] + kvh * P.ks[1];
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(P.v) + b * P.vs[0] + kvh * P.vs[1];
  __nv_bfloat16* op =
      static_cast<__nv_bfloat16*>(P.o) + b * P.os[0] + h * P.os[1];

  // Q * scale as NT bf16 terms that sum to the float32 product exactly.
  for (int e = tid; e < kBQ * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    float x = 0.0f;
    if (q0 + r < P.Sq && d < P.D)
      x = __fmul_rn(__bfloat162float(qp[(q0 + r) * P.qs[2] + d]), P.scale);
#pragma unroll
    for (int tm = 0; tm < NT; ++tm) {
      const __nv_bfloat16 y = __float2bfloat16_rn(x);
      Qs[(tm * kBQ + r) * LDS + d] = y;
      x -= __bfloat162float(y);
    }
  }

  const int nk = (P.Sk + kBK - 1) / kBK;
  int k_end = nk, k_beg = 0;
  if (P.causal) k_end = min(nk, (q0 + kBQ - 1) / kBK + 1);
  if (P.window > 0) {  // first tile with last key > first query - window
    const int tq = q0 - P.window - kBK + 1;
    k_beg = tq < 0 ? 0 : tq / kBK + 1;
  }
  if (k_beg < k_end)
    load_kv<DP, VEC>(Ks, Vs, kp, vp, k_beg * kBK, P, tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  __syncthreads();  // Q staged

  // The row and column this lane addresses for `ldmatrix` in a 16 x 16 tile:
  // Q (A, row-major) and V (B, transposed) as matrices (rows 0-7, cols 0-7),
  // (8-15, 0-7), (0-7, 8-15), (8-15, 8-15); K (B) as (0-7, 0-7), (0-7,
  // 8-15), (8-15, 0-7), (8-15, 8-15), so registers 0-1 and 2-3 are the B
  // fragments of keys 0-7 and 8-15.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* Qw = Qs + 16 * warp * LDS;  // this warp's Q rows
  uint32_t qa[NT == 1 ? KC : 1][4];  // Q's fragments, held when NT == 1
  if constexpr (NT == 1) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      ldmatrix_x4(qa[kc], Qw + a_row * LDS + kc * 16 + a_col);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int j = k_beg; j < k_end; ++j) {
    const int st = (j - k_beg) & 1;  // tile j's stage
    const int k0 = j * kBK;
    if (j + 1 < k_end)  // stage st ^ 1 was freed at the end of tile j - 1
      load_kv<DP, VEC>(Ks + (st ^ 1) * kBK * LDS, Vs + (st ^ 1) * kBK * LDS,
                       kp, vp, k0 + kBK, P, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile j landed
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + st * kBK * LDS;
    const __nv_bfloat16* Vt = Vs + st * kBK * LDS;

    // S (16 rows x 64 keys): s[n][e] is key k0 + 8n + 2t + (e & 1) of row
    // row0 (e < 2) or row0 + 8.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t kb[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldmatrix_x4(kb[np], Kt + (16 * np + k_row) * LDS + kc * 16 + k_col);
#pragma unroll
      for (int tm = 0; tm < NT; ++tm) {
        uint32_t a[4];
        if constexpr (NT == 1) {
#pragma unroll
          for (int x = 0; x < 4; ++x) a[x] = qa[kc][x];
        } else {
          ldmatrix_x4(a, Qw + (tm * kBQ + a_row) * LDS + kc * 16 + a_col);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma(s[2 * np], a, kb[np][0], kb[np][1]);
          mma(s[2 * np + 1], a, kb[np][2], kb[np][3]);
        }
      }
    }

    const bool edge = k0 + kBK > P.Sk ||
                      (P.causal && k0 + kBK - 1 > q0) ||
                      (P.window > 0 && k0 <= q0 + kBQ - 1 - P.window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * n + 2 * t + (e & 1);
          const int qpos = e < 2 ? row0 : row0 + 8;
          bool ok = kpos < P.Sk;
          if (P.causal) ok = ok && kpos <= qpos;
          if (P.window > 0) ok = ok && kpos > qpos - P.window;
          if (!ok) s[n][e] = kNegInf;
        }
    }

    // Online softmax, the TPU kernel's order: m_new = max(m, rowmax(s)),
    // p = exp(s - m_new), alpha = exp(m - m_new), l = l alpha + rowsum(p),
    // acc = acc alpha + p V.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][2 * i] = expf(s[n][2 * i] - m_new);
        s[n][2 * i + 1] = expf(s[n][2 * i + 1] - m_new);
        rs += s[n][2 * i] + s[n][2 * i + 1];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        acc[o][2 * i] *= alpha;
        acc[o][2 * i + 1] *= alpha;
      }
      m[i] = m_new;
    }

    // acc += (P_hi + P_lo) V, 16 keys a step.
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split2(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split2(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split2(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < KC; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vt + (16 * kc + a_row) * LDS + dp * 16 + a_col);
        mma(acc[2 * dp], ph, vb[0], vb[1]);
        mma(acc[2 * dp + 1], ph, vb[2], vb[3]);
        mma(acc[2 * dp], pl, vb[0], vb[1]);
        mma(acc[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st
  }

  // acc / max(l, 1e-30), rounded once to bf16; rows >= Sq are not stored.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= P.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = op + r * P.os[2];
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int d = 8 * o + 2 * t;
      const float x = acc[o][2 * i] / lc, y = acc[o][2 * i + 1] / lc;
      if constexpr (VEC) {  // D % 8 == 0: d < D covers d + 1
        if (d < P.D) *reinterpret_cast<uint32_t*>(orow + d) = pack2(x, y);
      } else {
        if (d < P.D) orow[d] = __float2bfloat16_rn(x);
        if (d + 1 < P.D) orow[d + 1] = __float2bfloat16_rn(y);
      }
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

template <int DP, int NT, bool VEC>
int launch_mma(const Params& P, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<DP, NT>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<DP, NT, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((P.Sq + kBQ - 1) / kBQ, P.H, P.B);
  flash_mma_kernel<DP, NT, VEC><<<grid, kThreads, bytes, stream>>>(P);
  return (int)cudaGetLastError();
}

// One Q term where the scale is a power of two (q * scale is then a bf16
// value), else three.  Head dims over 64 have no power-of-two scale
// (1/sqrt(D) is one only at D = 4^k), so they run three.
template <bool VEC>
int launch_mma_d(const Params& P, cudaStream_t stream) {
  int e;
  const bool one = frexpf(P.scale, &e) == 0.5f;
  if (P.D <= 32)
    return one ? launch_mma<32, 1, VEC>(P, stream)
               : launch_mma<32, 3, VEC>(P, stream);
  if (P.D <= 64)
    return one ? launch_mma<64, 1, VEC>(P, stream)
               : launch_mma<64, 3, VEC>(P, stream);
  if (P.D <= 96) return launch_mma<96, 3, VEC>(P, stream);
  return launch_mma<128, 3, VEC>(P, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// q (B, H, Sq, D), k and v (B, KV, Sk, D), o (B, H, Sq, D), all of one dtype
// (0 = float32: the CUDA-core kernel; 1 = bfloat16: the tensor-core kernel),
// addressed through the strides of their first three dims (elements; the
// head dim is contiguous).  Returns cudaGetLastError() after the launch (0 =
// launched).
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
  if (dtype == 0) return launch_d<float>(P, stream);
  bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
             aligned16(o);
  for (int i = 0; i < 3; ++i)
    vec = vec && P.qs[i] % 8 == 0 && P.ks[i] % 8 == 0 && P.vs[i] % 8 == 0 &&
          P.os[i] % 8 == 0;
  return vec ? launch_mma_d<true>(P, stream) : launch_mma_d<false>(P, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
