// Mamba2 chunked SSD scan: for x (B, L, H, P), dt (B, L, H), B and C
// (B, L, N) shared by all heads, A (H,), from h_0 = 0,
//   h_t = exp(dt_t A_h) h_{t-1} + (dt_t x_t) (x) B_t,   y_t = h_t . C_t,
// computed chunk by chunk in the SSD form.
//
// Replaces the Pallas TPU kernel `repro/kernels/ssd_scan.py` (`ssd_scan`,
// body `_kernel`).  There one grid step owns (b, 8 heads, one chunk) with
// the chunk axis innermost and sequential, so the state h (bh, P, N) lives
// in VMEM scratch from one chunk to the next.  For each chunk of c steps:
//   lcum = cumsum(dt * A)
//   M[t][s] = exp(lcum_t - lcum_s) (C_t . B_s) for s <= t, else 0
//   y_t = sum_s M[t][s] dx_s + (C_t . h) exp(lcum_t)       (dx_s = dt_s x_s)
//   h   = exp(lcum_last) h + sum_s B_s (dx_s exp(lcum_last - lcum_s))
//
// Design: chunk-parallel, in two launches on one stream.  A block that
// owns one (b, head) and walks its chunks in order keeps 512 blocks busy at
// zamba2-1.2b's shape, each a chain of 16 dependent chunks; here only the
// carry of the state is sequential:
//   1. state: for every (b, head, chunk) at once, the state the chunk adds,
//      S_c = B^T (dx o exp(lcum_last - lcum)), and its decay
//      exp(lcum_last) (8,192 independent tiles at zamba2's shape).  The
//      block that writes the last of a (b, head)'s chunk states (a counter
//      a head, after a device-wide fence) then carries that (b, head): for
//      each state element, over the chunks in order, h_c = exp(lcum_last)
//      h_{c-1} + S_c, rounded as a product and a sum as the TPU kernel
//      rounds them, reading the states from L2, where they were written
//      moments before; it writes the state entering each chunk over S_c,
//      and h_final;
//   2. out: for every (b, head, chunk) at once, y = M dx + (C h_{c-1}^T) o
//      exp(lcum), rounded once to x's dtype.
// These are the TPU kernel's float32 operations in its order, up to the
// order of the sums inside each product.  The carried states go through
// device memory: 4 B x H x chunks x P x N bytes (134 MB at zamba2's
// shape), written by 1 and read by 2 (the carry's reads and rewrites
// mostly stay in L2).  That traffic is this design's, not the function's:
// chip_smoke.py's bound counts only the inputs and outputs and prints the
// states' bytes beside it.  lcum is computed by one warp of both launches
// alike, from the same dt, with the same code.
//
// Two routes, picked by dtype (a dispatch by type, not a fallback; a
// refused launch on either returns its cudaError_t):
//
// bf16 (`ssd_state_mma_kernel`, `ssd_out_mma_kernel`): the products on the
// tensor cores, `mma.sync.m16n8k16` bf16 x bf16 -> f32, fed from shared
// memory by `ldmatrix` (`.trans` where the tile is stored k-major); 4 warps
// a block in launch 1, 8 in launch 2.  The tiles (and launch 2's carried
// state) arrive by 16-byte `cp.async` (zero-fill past the chunk's real
// steps and past P or N) where every row starts on a 16-byte boundary,
// else by element loads: same tiles.  B and C are read once a chunk; a
// block's copies land while its warp 0 computes lcum from dt loads issued
// before them, and several blocks share an SM (two in launch 2), so one
// block's loads overlap another's products.
// A bf16 x bf16 product is exact in float32.  Operands that are not bf16
// values are split into bf16 terms, each the bf16 rounding of what the
// earlier terms leave (tests/test_torch_ssd_tc.py checks each split and an
// emulation of the route, and pins the counts: one term fewer of M, h or
// dx o w misses chip_smoke.py's limits):
//   * dx = dt x, a product of two bf16 values, is hi + lo exactly;
//   * dx o w (launch 1) in three terms: the float32 value exactly, so the
//     state, a float32 output, has the TPU kernel's products;
//   * M in two terms and the carried state (launch 2) in two: within 2^-16
//     of each, for y, a bf16 output;
//   * C and B as they are.
//   Launch 2's warps take 16-row tiles of t in pairs (w, 7 - w), so the
//   causal work (s <= t) is even across them, two warps a pair where P is
//   padded to 32 or 64 (each on half the columns); each warp takes two
//   16-step tiles of s at a time, so C's fragments serve both and two
//   chains of products run side by side; M stays in the MMA accumulators,
//   whose layout is the A fragment of M dx.  Inside one MMA
//   the tensor cores align and truncate the products instead of adding in
//   IEEE float32; the on-card checks bound the result (chip_smoke.py
//   phase 3 and its per-layer check, tests/test_torch_cuda.py).
//
// float32 (`ssd_state_kernel`, `ssd_out_kernel`): the same two launches
// on the CUDA cores, 256 threads a block; each product is a small matrix
// product out of shared memory in which a thread owns a 4 x 4 tile of the
// output and reads its operands as float4 (four products per value read).
// Tensor cores take no float32 operand exactly.
//
// Both routes: only s <= t of M is used (lcum falls with t, so exp(lcum_t -
// lcum_s) for s > t may overflow, and inf * 0 would be NaN where the TPU
// kernel masks with a select); steps past the end of the sequence read
// zeros (dt = 0, so they change nothing, as the TPU wrapper's zero padding)
// and write no y; exp is the precise expf; products and sums that the TPU
// kernel rounds apart are written __fmul_rn / __fadd_rn where the compiler
// could contract them.
//
// What bounds it on the card.  At zamba2-1.2b's shape (8, 2048, 64, 64),
// N 64, chunk 128, bf16, the SSD form does 3.5e10 operations, 0.036 ms at
// the bf16 tensor-core rate (0.52 ms at the float32 rate); the function's
// bytes are x, dt, B, C, y and h_final (0.28 GB), 0.085 ms: bytes bound
// it.  The carried states written and read once add 0.27 GB (0.08 ms at
// the memory rate) that a design keeping them on chip would not move.
// The bf16 route runs about
// 3x the SSD form's products (the split terms, and launch 2's scores in
// both warps of a pair) on `mma.sync`, well under `wgmma`'s rate, and
// launch 2 is held back by `ldmatrix`'s shared-memory traffic and the
// short chains of dependent products (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kStateThreads = 128;  // bf16 route, launch 1: 4 warps
constexpr int kF32Threads = 256;  // float32 route
constexpr int kHTerms = 2;        // bf16 terms of the carried state
constexpr int kMaxSmem = 232448;  // the card's dynamic shared memory a block

struct Params {
  const void* x;
  const void* dt;
  const void* b;
  const void* c;
  const float* a;
  void* y;
  float* h;    // (B, H, P, N) h_final
  float* st;   // (B, H, nc, P, N) S_c, then the state entering chunk c
  float* dec;  // (B, H, nc) exp(lcum at the chunk's last step)
  int* count;  // (B, H) chunk states written, zero before the launch
  int B, L, H, P, N, chunk, nc;
  long long xs[3];   // x strides of b, t, h (elements; p contiguous)
  long long dts[3];  // dt strides of b, t, h
  long long bs[2];   // B strides of b, t (n contiguous)
  long long cs[2];   // C strides of b, t
  int vx, vb, vc;    // x, B, C rows start on 16-byte boundaries
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

// The block's chunk: its first step, real steps, and the (b, head) index.
struct Chunk {
  int ic, hh, b, t0, steps;
  long long bh;
};

__device__ __forceinline__ Chunk this_chunk(const Params& p) {
  Chunk k;
  k.ic = blockIdx.x;
  k.hh = blockIdx.y;
  k.b = blockIdx.z;
  k.t0 = k.ic * p.chunk;
  k.steps = min(p.chunk, p.L - k.t0);
  k.bh = (long long)k.b * p.H + k.hh;
  return k;
}

// Lane `lane`'s dt values j0 .. j0 + 7 of its run of the chunk's cp steps
// (ceil(cp / 32) consecutive steps a lane), 0 past the run or the
// chunk's real steps: eight loads in flight.
template <typename T>
__device__ __forceinline__ void dt_batch(const Params& p, const Chunk& k,
                                         int cp, int lane, int j0,
                                         float (&d)[8]) {
  const T* dp = static_cast<const T*>(p.dt) + k.b * p.dts[0] +
                k.hh * p.dts[2] + k.t0 * p.dts[1];
  const int per = (cp + 31) / 32, s0 = lane * per;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int s = s0 + j0 + j;
    d[j] = j0 + j < per && s < k.steps ? to_f32(dp[s * p.dts[1]]) : 0.0f;
  }
}

// One warp: dt of the chunk's cp steps into ds (0 past `steps`) and lcum =
// cumsum(dt * a) into lc: each lane sums a run of steps, then an exclusive
// scan of the runs across the warp.  `d` holds the lane's first batch
// (`dt_batch`, loaded early by the caller).  Returns lcum at the last step.
template <typename T>
__device__ float chunk_lcum(const Params& p, const Chunk& k, int cp,
                            float* ds, float* lc, int lane, float (&d)[8]) {
  const float a = p.a[k.hh];
  const int per = (cp + 31) / 32, s0 = lane * per;
  float run = 0.0f;
  for (int j0 = 0; j0 < per; j0 += 8) {
    if (j0) dt_batch<T>(p, k, cp, lane, j0, d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = s0 + j0 + j;
      if (j0 + j >= per || s >= cp) break;
      ds[s] = d[j];
      run = __fadd_rn(run, __fmul_rn(d[j], a));
      lc[s] = run;
    }
  }
  float inc = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc = __fadd_rn(inc, v);
  }
  float exc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) exc = 0.0f;
  for (int j = 0; j < per && s0 + j < cp; ++j)
    lc[s0 + j] = __fadd_rn(lc[s0 + j], exc);
  __syncwarp();
  return lc[cp - 1];
}

// ---------------------------------------------------------------------------
// The carry, both routes: in the state launch, by the block that finishes
// the last chunk of its (b, head)
// ---------------------------------------------------------------------------

// Whether this block wrote the last of its (b, head)'s chunk states: once
// the block's threads have written its state and decay, one thread makes
// them visible to the whole device (a fence after the barrier orders every
// write the barrier saw) and counts them; the block that counts the last
// one carries the (b, head), after a fence of its own.
__device__ __forceinline__ bool last_of_head(const Params& p, const Chunk& k,
                                             int tid) {
  __shared__ int last;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(p.count + k.bh, 1) == p.nc - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  return last;
}

// h_c = exp(lcum_last) h_{c-1} + S_c over the chunks of one (b, head), each
// element rounded as a product and a sum as the TPU kernel rounds them;
// the state entering each chunk is written over S_c, and h_final.  The
// other blocks' states are read through L2 (__ldcg), where they were
// written moments before; each thread keeps 16 chunks' loads of 4 elements
// in flight.
__device__ void carry_head(const Params& p, long long bh, int tid,
                           int nthr) {
  const int pn = p.P * p.N, nc = p.nc;
  float* s = p.st + bh * nc * pn;
  const float* dec = p.dec + bh * nc;
  float* ho = p.h + bh * pn;
  const int n4 = pn % 4 == 0 ? pn / 4 : 0;  // float4 groups
  for (int e = tid; e < n4; e += nthr) {
    float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c0 = 0; c0 < nc; c0 += 16) {
      float4 v[16];
      float w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const bool ok = c0 + j < nc;
        v[j] = ok ? __ldcg(reinterpret_cast<const float4*>(
                              s + (long long)(c0 + j) * pn) + e)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        w[j] = ok ? __ldcg(dec + c0 + j) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (c0 + j >= nc) break;
        reinterpret_cast<float4*>(s + (long long)(c0 + j) * pn)[e] = h;
        h.x = __fadd_rn(__fmul_rn(w[j], h.x), v[j].x);
        h.y = __fadd_rn(__fmul_rn(w[j], h.y), v[j].y);
        h.z = __fadd_rn(__fmul_rn(w[j], h.z), v[j].z);
        h.w = __fadd_rn(__fmul_rn(w[j], h.w), v[j].w);
      }
    }
    reinterpret_cast<float4*>(ho)[e] = h;
  }
  for (int e = 4 * n4 + tid; e < pn; e += nthr) {  // P N not a multiple of 4
    float h = 0.0f;
    for (int c = 0; c < nc; ++c) {
      const float v = __ldcg(s + (long long)c * pn + e);
      s[(long long)c * pn + e] = h;
      h = __fadd_rn(__fmul_rn(__ldcg(dec + c), h), v);
    }
    ho[e] = h;
  }
}

// ---------------------------------------------------------------------------
// float32 route: CUDA cores
// ---------------------------------------------------------------------------

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

// Launch 1: Bs [cp][np] (B), Dw [cp][pp] (dx o w), ds, lc, wt [cp].
size_t state_smem(int c, int P, int N) {
  const size_t cp = round4(c), pp = round4(P), np = round4(N);
  return sizeof(float) * (cp * np + cp * pp + 3 * cp);
}

__global__ void __launch_bounds__(kF32Threads)
    ssd_state_kernel(const Params p) {
  const int P = p.P, N = p.N;
  const int cp = round4(p.chunk), pp = round4(P), np = round4(N);
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);  // [cp][np]
  float* Dw = Bs + cp * np;                     // [cp][pp]
  float* ds = Dw + cp * pp;
  float* lc = ds + cp;
  float* wt = lc + cp;
  const int tid = threadIdx.x;
  const Chunk k = this_chunk(p);
  const float* xp = static_cast<const float*>(p.x) + k.b * p.xs[0] +
                    k.hh * p.xs[2] + k.t0 * p.xs[1];
  const float* bp = static_cast<const float*>(p.b) + k.b * p.bs[0] +
                    k.t0 * p.bs[1];

  if (tid < 32) {
    float d[8];
    dt_batch<float>(p, k, cp, tid, 0, d);
    const float last = chunk_lcum<float>(p, k, cp, ds, lc, tid, d);
    for (int s = tid; s < cp; s += 32) wt[s] = expf(__fsub_rn(last, lc[s]));
    if (tid == 0) p.dec[k.bh * p.nc + k.ic] = expf(last);
  }
  for (int e = tid; e < cp * np; e += kF32Threads) {
    const int s = e / np, n = e % np;
    Bs[e] = s < k.steps && n < N ? bp[s * p.bs[1] + n] : 0.0f;
  }
  __syncthreads();
  for (int e = tid; e < cp * pp; e += kF32Threads) {
    const int s = e / pp, q = e % pp;
    float v = 0.0f;
    if (s < k.steps && q < P)
      v = __fmul_rn(__fmul_rn(ds[s], xp[s * p.xs[1] + q]), wt[s]);
    Dw[e] = v;
  }
  __syncthreads();

  // S[p][n] = sum_s B[s][n] (dx o w)[s][p]
  float* S = p.st + (k.bh * p.nc + k.ic) * P * N;
  const int n4 = np / 4, p4 = pp / 4;
  for (int tile = tid; tile < n4 * p4; tile += kF32Threads) {
    const int n_0 = 4 * (tile % n4), q_0 = 4 * (tile / n4);
    float acc[4][4] = {};
    for (int s = 0; s < cp; ++s)
      outer4(acc, ld4(Bs + s * np + n_0), ld4(Dw + s * pp + q_0));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n_0 + i < N && q_0 + j < P)
          S[(q_0 + j) * N + n_0 + i] = acc[i][j];
  }
  if (last_of_head(p, k, tid)) carry_head(p, k.bh, tid, kF32Threads);
}

// Launch 2: Ct, Bt [np][cp] (C, B transposed), dx [cp][pp], hT [np][pp]
// (the state entering the chunk), Mt [cp][cp] (M[t][s] at [s][t]), lc, el
// [cp].
size_t out_smem(int c, int P, int N) {
  const size_t cp = round4(c), pp = round4(P), np = round4(N);
  return sizeof(float) *
         (2 * np * cp + cp * pp + np * pp + cp * cp + 3 * cp);
}

__global__ void __launch_bounds__(kF32Threads) ssd_out_kernel(const Params p) {
  const int P = p.P, N = p.N;
  const int cp = round4(p.chunk), pp = round4(P), np = round4(N);
  extern __shared__ float4 smem4[];
  float* Ct = reinterpret_cast<float*>(smem4);  // [np][cp]
  float* Bt = Ct + np * cp;                     // [np][cp]
  float* dx = Bt + np * cp;                     // [cp][pp]
  float* hT = dx + cp * pp;                     // [np][pp]
  float* Mt = hT + np * pp;                     // [cp][cp]
  float* ds = Mt + cp * cp;
  float* lc = ds + cp;
  float* el = lc + cp;
  const int tid = threadIdx.x;
  const Chunk k = this_chunk(p);
  const float* xp = static_cast<const float*>(p.x) + k.b * p.xs[0] +
                    k.hh * p.xs[2] + k.t0 * p.xs[1];
  const float* bp = static_cast<const float*>(p.b) + k.b * p.bs[0] +
                    k.t0 * p.bs[1];
  const float* cq = static_cast<const float*>(p.c) + k.b * p.cs[0] +
                    k.t0 * p.cs[1];
  const float* hin = p.st + (k.bh * p.nc + k.ic) * P * N;

  if (tid < 32) {
    float d[8];
    dt_batch<float>(p, k, cp, tid, 0, d);
    chunk_lcum<float>(p, k, cp, ds, lc, tid, d);
    for (int s = tid; s < cp; s += 32) el[s] = expf(lc[s]);
  }
  for (int e = tid; e < np * cp; e += kF32Threads) {
    const int n = e / cp, s = e % cp;
    const bool ok = n < N && s < k.steps;
    Bt[e] = ok ? bp[s * p.bs[1] + n] : 0.0f;
    Ct[e] = ok ? cq[s * p.cs[1] + n] : 0.0f;
  }
  for (int e = tid; e < np * pp; e += kF32Threads) {
    const int n = e / pp, q = e % pp;
    hT[e] = n < N && q < P ? hin[q * N + n] : 0.0f;
  }
  __syncthreads();
  for (int e = tid; e < cp * pp; e += kF32Threads) {
    const int s = e / pp, q = e % pp;
    dx[e] = s < k.steps && q < P ? __fmul_rn(ds[s], xp[s * p.xs[1] + q])
                                 : 0.0f;
  }

  // M = exp(lcum_t - lcum_s) (C_t . B_s), s <= t, stored transposed.
  const int c4 = cp / 4, p4 = pp / 4;
  for (int tile = tid; tile < c4 * c4; tile += kF32Threads) {
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
        v[i] = s <= t ? __fmul_rn(expf(__fsub_rn(lc[t], lc[s])), acc[i][j])
                      : 0.0f;
      }
      *reinterpret_cast<float4*>(Mt + s * cp + t_0) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();

  // y = M dx + (C h^T) exp(lcum_t).
  float* yp = static_cast<float*>(p.y) +
              ((long long)k.b * p.L + k.t0) * p.H * P + (long long)k.hh * P;
  const long long yt = (long long)p.H * P;
  for (int tile = tid; tile < c4 * p4; tile += kF32Threads) {
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
      if (t >= k.steps) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (q_0 + j < P)
          yp[t * yt + q_0 + j] =
              __fadd_rn(acc[i][j], __fmul_rn(car[i][j], el[t]));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
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

// The two bf16 values of a packed pair as float32: the lower-addressed one
// is in the low half.
__device__ __forceinline__ float lo_f32(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t r) {
  return __uint_as_float(r & 0xFFFF0000u);
}

// Two float32 values rounded to nearest-even bf16, ``x`` in the low half.
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) as NT packed bf16 terms: each the rounding of what the earlier
// terms leave (each difference is exact in float32).
template <int NT>
__device__ __forceinline__ void split(float x, float y, uint32_t* t) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    t[i] = pack2(x, y);
    x = __fsub_rn(x, lo_f32(t[i]));
    y = __fsub_rn(y, hi_f32(t[i]));
  }
}

// A thread's walk over the (row, column) cells of a rows x cols grid, cell
// e = tid, tid + nthr, ...: the row and column move by nthr's quotient and
// remainder, so no cell costs a division.
struct Walk {
  int r, k, dr, dk, cols;
  __device__ __forceinline__ Walk(int tid, int nthr, int cols_)
      : r(tid / cols_), k(tid % cols_), dr(nthr / cols_), dk(nthr % cols_),
        cols(cols_) {}
  __device__ __forceinline__ void next() {
    r += dr;
    k += dk;
    if (k >= cols) {
      k -= cols;
      ++r;
    }
  }
};

// rows x cols (cols a multiple of 16) of a bf16 tile into shared memory at a
// pitch of ld elements, from src with row stride rs (elements, columns
// contiguous); zeros past `vrows` rows and `vcols` columns.  With `vec`
// (every row on a 16-byte boundary, vcols a multiple of 8) by 16-byte
// cp.async, which the caller commits and waits for; else by element loads.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long rs, int vrows, int rows,
                                          int vcols, int cols, bool vec,
                                          int tid, int nthr) {
  if (vec) {
    const int ch = cols / 8;
    Walk w(tid, nthr, ch);
    for (; w.r < rows; w.next()) {
      const bool ok = w.r < vrows && w.k * 8 < vcols;
      cp_async16(dst + w.r * ld + w.k * 8,
                 ok ? src + w.r * rs + w.k * 8 : src, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.0f);
    for (Walk w(tid, nthr, cols); w.r < rows; w.next())
      dst[w.r * ld + w.k] =
          w.r < vrows && w.k < vcols ? src[w.r * rs + w.k] : zero;
  }
}

// The row and column a lane addresses for `ldmatrix` in a 16 x 16 tile, as
// in flash_attention.cu: ROW_/COL_A reads the matrices (rows 0-7, cols 0-7),
// (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) (an A fragment from an [m][k]
// tile, or with .trans a pair of B fragments from a [k][n] tile);
// ROW_/COL_K reads (0-7, 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) (a
// pair of B fragments from an [n][k] tile, or with .trans an A fragment
// from a [k][m] tile).
#define ROW_A(lane) (((lane) & 7) + (((lane) >> 3) & 1) * 8)
#define COL_A(lane) (((lane) >> 4) * 8)
#define ROW_K(lane) (((lane) & 7) + ((lane) >> 4) * 8)
#define COL_K(lane) ((((lane) >> 3) & 1) * 8)

// Launch 1: Xs [cp][pp + 8] (x), Bs [cp][NP + 8] (B), ds, lc, wt [cp].
size_t state_mma_smem(int c, int P, int NP) {
  const size_t cp = round16(c), pp = round16(P);
  return sizeof(bf16) * cp * (pp + 8 + NP + 8) + sizeof(float) * 3 * cp;
}

template <int NP>
__global__ void __launch_bounds__(kStateThreads)
    ssd_state_mma_kernel(const Params p) {
  const int P = p.P, N = p.N;
  const int cp = round16(p.chunk), pp = round16(P);
  const int LX = pp + 8, LB = NP + 8;  // row pitches (bf16)
  extern __shared__ float4 smem4[];
  bf16* Xs = reinterpret_cast<bf16*>(smem4);
  bf16* Bs = Xs + cp * LX;
  float* ds = reinterpret_cast<float*>(Bs + cp * LB);
  float* lc = ds + cp;
  float* wt = lc + cp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const Chunk k = this_chunk(p);
  float d[8];  // warp 0: the first dt values, in flight during the copies
  if (warp == 0) dt_batch<bf16>(p, k, cp, lane, 0, d);

  load_tile(Xs, LX,
            static_cast<const bf16*>(p.x) + k.b * p.xs[0] + k.hh * p.xs[2] +
                k.t0 * p.xs[1],
            p.xs[1], k.steps, cp, P, pp, p.vx, tid, kStateThreads);
  load_tile(Bs, LB,
            static_cast<const bf16*>(p.b) + k.b * p.bs[0] + k.t0 * p.bs[1],
            p.bs[1], k.steps, cp, N, NP, p.vb, tid, kStateThreads);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (warp == 0) {
    const float last = chunk_lcum<bf16>(p, k, cp, ds, lc, lane, d);
    for (int s = lane; s < cp; s += 32) wt[s] = expf(__fsub_rn(last, lc[s]));
    if (lane == 0) p.dec[k.bh * p.nc + k.ic] = expf(last);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // S[p][n] = sum_s (dx o w)[s][p] B[s][n]: 16 rows of p a warp, every n;
  // A = (dx o w)^T in three terms, formed from x's fragments.
  float* S = p.st + (k.bh * p.nc + k.ic) * P * N;
  for (int mt = warp; mt < pp / 16; mt += kStateThreads / 32) {
    float acc[NP / 8][4];
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    for (int kc = 0; kc < cp / 16; ++kc) {
      uint32_t xa[4], ta[4][3];
      ldmatrix_x4_trans(xa, Xs + (16 * kc + ROW_K(lane)) * LX + 16 * mt +
                                COL_K(lane));
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // xa[r]: p = g + 8 (r & 1), s below
        const int s = 16 * kc + 2 * q + 8 * (r >> 1);
        uint32_t t3[3];
        split<3>(__fmul_rn(__fmul_rn(lo_f32(xa[r]), ds[s]), wt[s]),
                 __fmul_rn(__fmul_rn(hi_f32(xa[r]), ds[s + 1]), wt[s + 1]),
                 t3);
        ta[r][0] = t3[0];
        ta[r][1] = t3[1];
        ta[r][2] = t3[2];
      }
#pragma unroll
      for (int j = 0; j < NP / 16; ++j) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, Bs + (16 * kc + ROW_A(lane)) * LB + 16 * j +
                                  COL_A(lane));
#pragma unroll
        for (int tm = 0; tm < 3; ++tm) {
          const uint32_t a[4] = {ta[0][tm], ta[1][tm], ta[2][tm], ta[3][tm]};
          mma(acc[2 * j], a, bb[0], bb[1]);
          mma(acc[2 * j + 1], a, bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pr = 16 * mt + g + 8 * (e >> 1), n = 8 * j + 2 * q + (e & 1);
        if (pr < P && n < N) S[pr * N + n] = acc[j][e];
      }
  }
  if (last_of_head(p, k, tid)) carry_head(p, k.bh, tid, kStateThreads);
}

// Launch 2: Cs, Bs [cp][np + 8] (C, B), Dh, Dl [cp][PB + 8] (dx hi, lo),
// Hs [kHTerms][PB][np + 8] (the state entering the chunk, [p][n]), ds, lc,
// el [cp], Hf [P][N] (the state as it arrives, float32).
size_t out_mma_smem(int c, int PB, int P, int N) {
  const size_t cp = round16(c), np = round16(N);
  return sizeof(bf16) * (2 * cp * (np + 8) + 2 * cp * (PB + 8) +
                         kHTerms * PB * (np + 8)) +
         sizeof(float) * (3 * cp + round4(P * N));
}

// Launch 2's threads: four pairs of 16-row tiles of t, each pair on P / 2
// columns in two warps where P is padded to 32 or 64 (scores and M are
// formed in both), on all P columns in one warp where it is padded to 16.
template <int PB>
__host__ __device__ constexpr int out_threads() {
  return PB >= 32 ? 256 : 128;
}

template <int PB>
__global__ void __launch_bounds__(out_threads<PB>())
    ssd_out_mma_kernel(const Params p) {
  constexpr int NTH = out_threads<PB>(), PW = PB / (NTH / 128);
  constexpr int LD = PB + 8;
  const int P = p.P, N = p.N;
  const int cp = round16(p.chunk), np = round16(N);
  const int LC = np + 8;
  extern __shared__ float4 smem4[];
  bf16* Cs = reinterpret_cast<bf16*>(smem4);
  bf16* Bs = Cs + cp * LC;
  bf16* Dh = Bs + cp * LC;
  bf16* Dl = Dh + cp * LD;
  bf16* Hs = Dl + cp * LD;
  float* ds = reinterpret_cast<float*>(Hs + kHTerms * PB * LC);
  float* lc = ds + cp;
  float* el = lc + cp;
  float* Hf = el + cp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const Chunk k = this_chunk(p);
  const bool carried = k.ic > 0;  // the state entering chunk 0 is zero
  const int pn = P * N;
  float d[8];  // warp 0: the first dt values, in flight during the copies
  if (warp == 0) dt_batch<bf16>(p, k, cp, lane, 0, d);

  load_tile(Cs, LC,
            static_cast<const bf16*>(p.c) + k.b * p.cs[0] + k.t0 * p.cs[1],
            p.cs[1], k.steps, cp, N, np, p.vc, tid, NTH);
  load_tile(Bs, LC,
            static_cast<const bf16*>(p.b) + k.b * p.bs[0] + k.t0 * p.bs[1],
            p.bs[1], k.steps, cp, N, np, p.vb, tid, NTH);
  load_tile(Dh, LD,
            static_cast<const bf16*>(p.x) + k.b * p.xs[0] + k.hh * p.xs[2] +
                k.t0 * p.xs[1],
            p.xs[1], k.steps, cp, P, PB, p.vx, tid, NTH);
  if (carried) {  // the state entering the chunk, as it is
    const float* hin = p.st + (k.bh * p.nc + k.ic) * pn;
    if (pn % 4 == 0) {  // the slab starts on a 16-byte boundary
      for (int e = 4 * tid; e < pn; e += 4 * NTH)
        cp_async16(Hf + e, hin + e, true);
    } else {
      for (int e = tid; e < pn; e += NTH) Hf[e] = hin[e];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (warp == 0) {
    chunk_lcum<bf16>(p, k, cp, ds, lc, lane, d);
    for (int s = lane; s < cp; s += 32) el[s] = expf(lc[s]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // dx = dt x (exact) as hi + lo, eight values a thread at a time; the
  // state in kHTerms terms, two values at a time.
  for (int e = tid; e < cp * (PB / 8); e += NTH) {
    const int s = e / (PB / 8), c = 8 * (e % (PB / 8));
    const uint4 raw = *reinterpret_cast<const uint4*>(Dh + s * LD + c);
    const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
    const float dv = ds[s];
    uint32_t t[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split<2>(__fmul_rn(lo_f32(in[i]), dv), __fmul_rn(hi_f32(in[i]), dv),
               t[i]);
    *reinterpret_cast<uint4*>(Dh + s * LD + c) =
        make_uint4(t[0][0], t[1][0], t[2][0], t[3][0]);
    *reinterpret_cast<uint4*>(Dl + s * LD + c) =
        make_uint4(t[0][1], t[1][1], t[2][1], t[3][1]);
  }
  if (carried) {
    for (Walk w(tid, NTH, np / 2); w.r < PB; w.next()) {
      const int n = 2 * w.k;
      const bool row = w.r < P;
      uint32_t t2[kHTerms];
      split<kHTerms>(row && n < N ? Hf[w.r * N + n] : 0.0f,
                     row && n + 1 < N ? Hf[w.r * N + n + 1] : 0.0f, t2);
#pragma unroll
      for (int tm = 0; tm < kHTerms; ++tm)
        *reinterpret_cast<uint32_t*>(Hs + (tm * PB + w.r) * LC + n) = t2[tm];
    }
  }
  __syncthreads();

  bf16* yp = static_cast<bf16*>(p.y) +
             ((long long)k.b * p.L + k.t0) * p.H * P + (long long)k.hh * P;
  const long long yt = (long long)p.H * P;
  const int pair = warp & 3, p0 = (warp >> 2) * PW;  // rows, columns
  const int nt = cp / 16;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = pass ? 7 - pair : pair; i < nt; i += 8) {
      const bf16* Cw = Cs + 16 * i * LC;  // this warp's rows t of C
      float accD[PW / 8][4], accO[PW / 8][4];
#pragma unroll
      for (int j = 0; j < PW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) accD[j][e] = accO[j][e] = 0.0f;

      // accO = C h^T (the carried state in kHTerms terms).
      if (carried) {
        for (int kc = 0; kc < np / 16; ++kc) {
          uint32_t ca[4];
          ldmatrix_x4(ca, Cw + ROW_A(lane) * LC + 16 * kc + COL_A(lane));
#pragma unroll
          for (int jp = 0; jp < PW / 16; ++jp)
#pragma unroll
            for (int tm = 0; tm < kHTerms; ++tm) {
              uint32_t hb[4];
              ldmatrix_x4(hb, Hs + (tm * PB + p0 + 16 * jp + ROW_K(lane)) *
                                       LC +
                                  16 * kc + COL_K(lane));
              mma(accO[2 * jp], ca, hb[0], hb[1]);
              mma(accO[2 * jp + 1], ca, hb[2], hb[3]);
            }
        }
      }

      // accD = M dx over the 16-step tiles s <= t, two tiles a step: C's
      // fragments serve both, and their chains run side by side.
      for (int j0 = 0; j0 <= i; j0 += 2) {
        const bool two = j0 < i;  // tile j0 + 1 <= i too
        float sc[2][2][4] = {};
        for (int kc = 0; kc < np / 16; ++kc) {
          uint32_t ca[4];
          ldmatrix_x4(ca, Cw + ROW_A(lane) * LC + 16 * kc + COL_A(lane));
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (u && !two) break;
            uint32_t bb[4];
            ldmatrix_x4(bb, Bs + (16 * (j0 + u) + ROW_K(lane)) * LC +
                                16 * kc + COL_K(lane));
            mma(sc[u][0], ca, bb[0], bb[1]);
            mma(sc[u][1], ca, bb[2], bb[3]);
          }
        }
        // sc[u][n][e]: t = 16 i + g + 8 (e >> 1),
        //              s = 16 (j0 + u) + 8 n + 2 q + (e & 1)
        uint32_t mh[2][4], ml[2][4];  // M's A fragments, two terms
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u && !two) break;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = 16 * i + g + 8 * (e >> 1);
              const int s = 16 * (j0 + u) + 8 * n + 2 * q + (e & 1);
              sc[u][n][e] = s <= t ? __fmul_rn(expf(__fsub_rn(lc[t], lc[s])),
                                               sc[u][n][e])
                                   : 0.0f;
            }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            uint32_t t2[2];
            split<2>(sc[u][r >> 1][2 * (r & 1)], sc[u][r >> 1][2 * (r & 1) + 1],
                     t2);
            mh[u][r] = t2[0];
            ml[u][r] = t2[1];
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u && !two) break;
#pragma unroll
          for (int jp = 0; jp < PW / 16; ++jp) {
            uint32_t dh[4], dl[4];
            const int off = (16 * (j0 + u) + ROW_A(lane)) * LD + p0 +
                            16 * jp + COL_A(lane);
            ldmatrix_x4_trans(dh, Dh + off);
            ldmatrix_x4_trans(dl, Dl + off);
            mma(accD[2 * jp], mh[u], dh[0], dh[1]);
            mma(accD[2 * jp + 1], mh[u], dh[2], dh[3]);
            mma(accD[2 * jp], mh[u], dl[0], dl[1]);
            mma(accD[2 * jp + 1], mh[u], dl[2], dl[3]);
            mma(accD[2 * jp], ml[u], dh[0], dh[1]);
            mma(accD[2 * jp + 1], ml[u], dh[2], dh[3]);
            mma(accD[2 * jp], ml[u], dl[0], dl[1]);
            mma(accD[2 * jp + 1], ml[u], dl[2], dl[3]);
          }
        }
      }

      // y = accD + accO exp(lcum_t), rounded once; rows past the chunk's
      // real steps and columns past P are not stored.
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = 16 * i + g + 8 * hr;
        if (t >= k.steps) continue;
        const float e = el[t];
        bf16* yrow = yp + t * yt;
#pragma unroll
        for (int j = 0; j < PW / 8; ++j) {
          const int c = p0 + 8 * j + 2 * q;
          const float v0 =
              __fadd_rn(accD[j][2 * hr], __fmul_rn(accO[j][2 * hr], e));
          const float v1 = __fadd_rn(accD[j][2 * hr + 1],
                                     __fmul_rn(accO[j][2 * hr + 1], e));
          if ((P & 1) == 0) {  // c even, P even: c < P covers c + 1
            if (c < P) *reinterpret_cast<uint32_t*>(yrow + c) = pack2(v0, v1);
          } else {
            if (c < P) yrow[c] = __float2bfloat16_rn(v0);
            if (c + 1 < P) yrow[c + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename K>
int launch_one(K kernel, dim3 grid, int threads, size_t bytes,
               const Params& p, cudaStream_t stream) {
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

int pad_n(int N) { return N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128; }
int pad_p(int P) { return P <= 16 ? 16 : P <= 32 ? 32 : 64; }

int launch_state_mma(const Params& p, dim3 grid, cudaStream_t s) {
  const size_t bytes = state_mma_smem(p.chunk, p.P, pad_n(p.N));
  switch (pad_n(p.N)) {
    case 16: return launch_one(ssd_state_mma_kernel<16>, grid, kStateThreads,
                               bytes, p, s);
    case 32: return launch_one(ssd_state_mma_kernel<32>, grid, kStateThreads,
                               bytes, p, s);
    case 64: return launch_one(ssd_state_mma_kernel<64>, grid, kStateThreads,
                               bytes, p, s);
    default: return launch_one(ssd_state_mma_kernel<128>, grid, kStateThreads,
                               bytes, p, s);
  }
}

int launch_out_mma(const Params& p, dim3 grid, cudaStream_t s) {
  const size_t bytes = out_mma_smem(p.chunk, pad_p(p.P), p.P, p.N);
  switch (pad_p(p.P)) {
    case 16: return launch_one(ssd_out_mma_kernel<16>, grid,
                               out_threads<16>(), bytes, p, s);
    case 32: return launch_one(ssd_out_mma_kernel<32>, grid,
                               out_threads<32>(), bytes, p, s);
    default: return launch_one(ssd_out_mma_kernel<64>, grid,
                               out_threads<64>(), bytes, p, s);
  }
}

bool rows16(const void* base, std::initializer_list<long long> strides,
            int cols) {
  if ((uintptr_t)base % 16 || cols % 8) return false;
  for (long long s : strides)
    if (s % 8) return false;
  return true;
}

}  // namespace

// x (B, L, H, P), dt (B, L, H), b and c (B, L, N) of one dtype
// (0 = float32, 1 = bfloat16), addressed through their strides (elements;
// the last dim contiguous); a (H,) float32; y (B, L, H, P) of x's dtype and
// h (B, H, P, N) float32, contiguous; st (B, H, nc, P, N) and dec (B, H, nc)
// float32 scratch, nc = ceil(L / chunk), and count (B, H) int32, zero;
// chunk = min(chunk, L).  bf16 takes P <= 64 and N <= 128.  Launches the
// two kernels on the stream and returns the first nonzero
// cudaGetLastError() (0 = both launched).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* b, const void* c,
    const float* a, void* y, float* h, float* st, float* dec, int* count,
    int dtype, int B, int L, int H, int P, int N, int chunk, long long xs0,
    long long xs1, long long xs2, long long dts0, long long dts1,
    long long dts2, long long bs0, long long bs1, long long cs0,
    long long cs1, void* stream_ptr) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1 || P < 1 || N < 1 ||
      chunk < 1 || chunk > L || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && (P > 64 || N > 128)))
    return (int)cudaErrorInvalidValue;
  const int nc = (L + chunk - 1) / chunk;
  Params p{x, dt, b, c, a, y, h, st, dec, count, B, L, H, P, N, chunk, nc,
           {xs0, xs1, xs2}, {dts0, dts1, dts2}, {bs0, bs1}, {cs0, cs1},
           0, 0, 0};
  p.vx = rows16(x, {xs0, xs1, xs2}, P);
  p.vb = rows16(b, {bs0, bs1}, N);
  p.vc = rows16(c, {cs0, cs1}, N);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 chunks(nc, H, B);
  const int rc = dtype == 1
                     ? launch_state_mma(p, chunks, stream)
                     : launch_one(ssd_state_kernel, chunks, kF32Threads,
                                  state_smem(chunk, P, N), p, stream);
  if (rc) return rc;
  return dtype == 1 ? launch_out_mma(p, chunks, stream)
                    : launch_one(ssd_out_kernel, chunks, kF32Threads,
                                 out_smem(chunk, P, N), p, stream);
}

// The dynamic shared memory (bytes) of the larger of the two kernels that
// ssd_scan_launch would start for this dtype, chunk (= min(chunk, L)), P
// and N, as the launchers size it; the wrapper refuses a shape above the
// card's limit before it allocates anything.
extern "C" long long ssd_scan_smem_bytes(int dtype, int chunk, int P, int N) {
  if (dtype == 1) {
    const size_t state = state_mma_smem(chunk, P, pad_n(N));
    const size_t out = out_mma_smem(chunk, pad_p(P), P, N);
    return (long long)(state > out ? state : out);
  }
  const size_t state = state_smem(chunk, P, N), out = out_smem(chunk, P, N);
  return (long long)(state > out ? state : out);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
