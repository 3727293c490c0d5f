// Fused upload pipeline for one cohort: DGC sparsify + nnz + ALDP clip/noise.
//
// Replaces the Pallas TPU kernel `repro/kernels/upload_fused.py`
// (`upload_fused_fleet`, body `_fused_kernel`).  Per node row i and flat
// position p:
//   c = delta + residual; keep = |c| >= thr[i, leaf(p)]
//   upload = keep ? c : 0; residual' = keep ? 0 : c; nnz[i] += (upload != 0)
//   upload = upload * clip_scale[i] + sigma_s * BoxMuller(hash(seed_i, p))
//
// What bounds it on the card: bytes.  Each element reads delta and
// residual and writes upload and residual' (16 bytes).  The noise (two
// hashes, the precise logf, sqrtf and cosf) is roughly a hundred
// instructions an element; in the first design, one element a thread, its
// issue and everything around it (a loop over every leaf, scalar 64-bit
// addressing, a block barrier per 256 elements) did not hide behind the
// memory traffic, and the pass with noise took a fifth longer than the one
// without.  This design spends as little as it can outside the noise, so
// that on an H100 the pass with noise takes no longer than the one
// without, within a sixth of a `copy_` of the same bytes (PERF.md):
// - each thread owns a run of consecutive elements of one row, two 16-byte
//   vectors an array with noise and one without (the faster of each on an
//   H100), and moves them with 16-byte loads and stores issued before the
//   block stages its leaf table;
// - rows start on any 4-byte boundary (the paper CNN's P = 20,490 is 2 mod
//   4), so each row splits into a head of up to three elements before its
//   first 16-byte boundary, whole runs, and a tail; one thread a row takes
//   the head and the tail one element at a time (the wrapper hands the
//   kernel 16-byte aligned arrays);
// - the leaf of a run's first element comes from a binary search over the
//   leaf starts staged in shared memory, the rest only step past a start
//   when they cross one (leaves shorter than a run put several in it);
// - the row's seed, scale and noise keys (`ldp_hash.cuh`) are read or made
//   once per thread, and indices are unsigned 32-bit within a row;
// - nnz is counted per thread and summed once per warp (`redux.sync`), one
//   integer atomicAdd a warp: integer sums are exact in any order.
// blockIdx.y is the row, so every block stays inside one row.
//
// Noise: the TPU kernel's counter-hash Box–Muller stream, from the header
// this kernel shares with ldp_noise.cu (K5), so the fused pass and the
// unfused sparsify -> nnz -> ldp_noise chain give the same bits.  Every
// product and sum that reaches a stored value is an explicitly rounded
// intrinsic, so nvcc contracts nothing into an FMA.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ldp_hash.cuh"

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kBlock = 128;

// 16-byte vectors a thread moves per array: two with noise, one without
// (the faster of the two on an H100 for each).
template <bool kNoise>
constexpr int kVecsPerRun = kNoise ? 2 : 1;

__device__ __forceinline__ void unpack(float4 x, float* d) {
  d[0] = x.x;
  d[1] = x.y;
  d[2] = x.z;
  d[3] = x.w;
}

__device__ __forceinline__ float4 pack(const float* s) {
  return make_float4(s[0], s[1], s[2], s[3]);
}

// The row-wide inputs of one block.
struct Row {
  const uint32_t* starts;  // leaf start offsets (shared memory)
  const float* thr;        // this row's per-leaf thresholds (shared memory)
  int n_leaves;
  float scale, sigma_s;
  repro_ldp::NoiseKeys keys;
};

// Walks the leaves of one row in increasing position.
struct LeafCursor {
  int l;
  uint32_t next;  // start of leaf l + 1 (UINT32_MAX past the last)
  float t;        // leaf l's threshold

  __device__ __forceinline__ void seek(const Row& row, uint32_t p) {
    int lo = 1, hi = row.n_leaves;  // the last l >= 1 with start <= p, or 0
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row.starts[mid] <= p) lo = mid + 1; else hi = mid;
    }
    l = lo - 1;
    next = lo < row.n_leaves ? row.starts[lo] : UINT32_MAX;
    t = row.thr[l];
  }

  __device__ __forceinline__ float at(const Row& row, uint32_t p) {
    while (p >= next) {
      ++l;
      next = l + 1 < row.n_leaves ? row.starts[l + 1] : UINT32_MAX;
      t = row.thr[l];
    }
    return t;
  }
};

template <bool kSparsify, bool kLdp, bool kNoise, bool kNnz>
__device__ __forceinline__ void element(const Row& row, float u, float r,
                                        float t, uint32_t p, float& up,
                                        float& newr, int& cnt) {
  if (kSparsify) {
    const float c = __fadd_rn(u, r);
    const bool keep = fabsf(c) >= t;
    u = keep ? c : 0.0f;
    newr = keep ? 0.0f : c;
  }
  if (kNnz) cnt += (u != 0.0f);
  if (kLdp) {
    u = __fmul_rn(u, row.scale);
    if (kNoise) u = repro_ldp::ldp_noise_add(u, row.sigma_s, row.keys, p);
  }
  up = u;
}

template <bool kSparsify, bool kLdp, bool kNoise, bool kNnz>
__device__ __forceinline__ void scalar_element(const Row& row,
                                               const float* flat,
                                               const float* res, float* up,
                                               float* newr, uint32_t p,
                                               int& cnt) {
  float t = 0.0f, u, nr;
  if (kSparsify) {
    LeafCursor leaf;
    leaf.seek(row, p);
    t = leaf.t;
  }
  element<kSparsify, kLdp, kNoise, kNnz>(
      row, flat[p], kSparsify ? res[p] : 0.0f, t, p, u, nr, cnt);
  up[p] = u;
  if (kSparsify) newr[p] = nr;
}

template <bool kSparsify, bool kLdp, bool kNoise, bool kNnz>
__global__ void __launch_bounds__(kBlock)
upload_fused_kernel(const float* __restrict__ flat,
                    const float* __restrict__ res,
                    const float* __restrict__ thr,
                    const int* __restrict__ bounds, int n_leaves,
                    const int* __restrict__ seeds,
                    const float* __restrict__ scales, float sigma_s,
                    float* __restrict__ up_out, float* __restrict__ newr_out,
                    int* __restrict__ nnz, uint32_t n) {
  constexpr int kVec = kVecsPerRun<kNoise>;
  constexpr uint32_t kRun = 4 * kVec;
  __shared__ uint32_t s_starts[kMaxLeaves];
  __shared__ float s_thr[kMaxLeaves];
  const uint32_t node = blockIdx.y;
  const size_t off = (size_t)node * n;
  const float* flat_r = flat + off;
  const float* res_r = kSparsify ? res + off : nullptr;
  float* up_r = up_out + off;
  float* newr_r = kSparsify ? newr_out + off : nullptr;
  // Elements before the row's first 16-byte boundary (the arrays start on
  // one), then whole runs, then the tail.
  const uint32_t head = min((uint32_t)(0u - (uint32_t)off) & 3u, n);
  const uint32_t runs = (n - head) / kRun;
  const uint32_t j = blockIdx.x * kBlock + threadIdx.x;
  const uint32_t p = head + j * kRun;
  // The run's loads go out before the leaf table is staged.
  float u[kRun], r[kRun];
  if (j < runs) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      unpack(__ldcs(reinterpret_cast<const float4*>(flat_r + p) + v),
             u + 4 * v);
      if (kSparsify)
        unpack(__ldcs(reinterpret_cast<const float4*>(res_r + p) + v),
               r + 4 * v);
    }
  }
  if (kSparsify) {
    for (int l = threadIdx.x; l < n_leaves; l += kBlock) {
      s_starts[l] = (uint32_t)bounds[l];
      s_thr[l] = thr[(size_t)node * n_leaves + l];
    }
    __syncthreads();
  }
  Row row;
  row.starts = s_starts;
  row.thr = s_thr;
  row.n_leaves = n_leaves;
  row.scale = kLdp ? scales[node] : 1.0f;
  row.sigma_s = sigma_s;
  row.keys = kNoise ? repro_ldp::noise_keys(seeds[node])
                    : repro_ldp::NoiseKeys{0u, 0u};
  int cnt = 0;
  if (j < runs) {
    float t[kRun];
    if (kSparsify) {
      LeafCursor leaf;
      leaf.seek(row, p);
#pragma unroll
      for (int e = 0; e < (int)kRun; ++e) t[e] = leaf.at(row, p + e);
    }
    float o[kRun], nr[kRun];
#pragma unroll
    for (int e = 0; e < (int)kRun; ++e)
      element<kSparsify, kLdp, kNoise, kNnz>(row, u[e], r[e], t[e], p + e,
                                             o[e], nr[e], cnt);
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      __stcs(reinterpret_cast<float4*>(up_r + p) + v, pack(o + 4 * v));
      if (kSparsify)
        __stcs(reinterpret_cast<float4*>(newr_r + p) + v, pack(nr + 4 * v));
    }
  } else if (j == runs) {
    for (uint32_t q = 0; q < head; ++q)
      scalar_element<kSparsify, kLdp, kNoise, kNnz>(row, flat_r, res_r, up_r,
                                                    newr_r, q, cnt);
    for (uint32_t q = head + runs * kRun; q < n; ++q)
      scalar_element<kSparsify, kLdp, kNoise, kNnz>(row, flat_r, res_r, up_r,
                                                    newr_r, q, cnt);
  }
  if (kNnz) {
    const int v = __reduce_add_sync(0xffffffffu, cnt);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(nnz + node, v);
  }
}

template <bool S, bool L, bool N, bool Z>
void launch(cudaStream_t stream, const float* flat, const float* res,
            const float* thr, const int* bounds, int n_leaves,
            const int* seeds, const float* scales, float sigma_s, float* up,
            float* newr, int* nnz, int c, uint32_t n) {
  // One thread per whole run, plus one for the row's head and tail.
  const uint32_t threads = n / (4 * kVecsPerRun<N>) + 1;
  dim3 grid((threads + kBlock - 1) / kBlock, c);
  upload_fused_kernel<S, L, N, Z><<<grid, kBlock, 0, stream>>>(
      flat, res, thr, bounds, n_leaves, seeds, scales, sigma_s, up, newr, nnz,
      n);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// flags: bit 0 sparsify, bit 1 ldp (clip scale), bit 2 noise, bit 3 nnz.
// flat, res, up and newr must start on 16-byte boundaries.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int upload_fused_launch(const float* flat, const float* res,
                                   const float* thr, const int* bounds,
                                   int n_leaves, const int* seeds,
                                   const float* scales, float sigma_s,
                                   float* up, float* newr, int* nnz, int c,
                                   int n, int flags, void* stream_ptr) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || c < 1 || c > 65535 || n < 1)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(flat) || !aligned16(res) || !aligned16(up) ||
      !aligned16(newr))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
#define REPRO_CASE(F, S, L, N, Z)                                              \
  case F:                                                                      \
    launch<S, L, N, Z>(stream, flat, res, thr, bounds, n_leaves, seeds,        \
                       scales, sigma_s, up, newr, nnz, c, (uint32_t)n);        \
    break;
  switch (flags) {
    REPRO_CASE(0, false, false, false, false)
    REPRO_CASE(1, true, false, false, false)
    REPRO_CASE(2, false, true, false, false)
    REPRO_CASE(3, true, true, false, false)
    REPRO_CASE(6, false, true, true, false)
    REPRO_CASE(7, true, true, true, false)
    REPRO_CASE(8, false, false, false, true)
    REPRO_CASE(9, true, false, false, true)
    REPRO_CASE(10, false, true, false, true)
    REPRO_CASE(11, true, true, false, true)
    REPRO_CASE(14, false, true, true, true)
    REPRO_CASE(15, true, true, true, true)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_CASE
  return (int)cudaGetLastError();
}

extern "C" const char* upload_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
