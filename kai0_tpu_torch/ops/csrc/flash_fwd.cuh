// Shared body of the two flash-attention forward kernels (flash_mqa_fwd.cu,
// flash_mhsa_fwd.cu): streaming attention with an online softmax, split over
// the key axis, followed by a combine pass.
//
// Layout. Queries are "rows": a block takes kRows consecutive rows of one batch
// element, and every row of that element attends to the same K/V sequence. MQA
// (one K/V head shared by N query heads) folds the heads into rows t-major,
// row = t*N + n, as the TPU kernel does: q [B,T,N,H] is then already [B, T*N, H]
// in memory, and each K/V tile in shared memory serves all N heads. Dense MHA in
// head-major layout [B,N,T,H] is the same problem with N=1 and batch B*N.
//
// Numerics (held to kai0_tpu/ops/attention.py mha_reference):
//   * logits accumulate in f32 from the inputs widened to f32;
//   * a masked logit is the finite Gemma constant kBigNeg (-2.3819763e38), so a
//     fully masked row softmaxes to the uniform average of V over the real keys;
//   * keys past the ragged end of S are absent (-inf, weight exactly 0), unlike
//     the TPU kernel's masked zero padding;
//   * softmax statistics in f32; the unnormalised weights exp(s-m) are rounded to
//     the element type before P·V (the reference rounds the normalised P — an
//     expected difference at the element type's precision); P·V accumulates in f32.
//
// Simple first: scalar f32 FMAs from shared memory, no tensor cores, no TMA.
// The C entries run these kernels on f32 inputs only: bf16 inputs go to the
// tensor-core kernels (flash_mqa_mma.cuh, flash_mhsa_mma.cuh), which share the
// combine pass below.
// A thread owns a 4x4 patch of the logit tile and 4 rows x ceil(H/16) columns of
// the output accumulator. Shared-memory rows are padded to H+1 floats so that the
// 16 keys a warp reads in one step fall in 16 different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kai0 {

constexpr float kBigNeg = -2.3819763e38f;
constexpr int kRows = 64;     // query rows per block
constexpr int kKeys = 64;     // keys per shared-memory tile
constexpr int kThreads = 256; // 16 x 16 threads
constexpr int kCombineThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// The P·V operand in the element type, widened back to f32.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
struct FwdParams {
  const T* q;             // [batch, rows, HD], rows = t_len * heads
  const T* k;             // [batch, s_len, HD]
  const T* v;             // [batch, s_len, HD]
  const uint8_t* mask;    // [batch, t_len, s_len] (0 = masked) or nullptr
  float* part_acc;        // [splits, batch * rows, HD]: unnormalised P·V per split
  float* part_ml;         // [splits, batch * rows, 2]: running max and sum per split
  int t_len, s_len, heads;
  int chunk;              // keys per split, a multiple of kKeys
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kRows) * (HD + 1) + 2 * size_t(kKeys) * (HD + 1) +
                          size_t(kRows) * (kKeys + 1) + 3 * kRows);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_partial(FwdParams<T> p) {
  constexpr int P = HD + 1;
  constexpr int PS = kKeys + 1;
  constexpr int DPT = (HD + 15) / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [kRows][P]
  float* ks = qs + kRows * P;        // [kKeys][P]
  float* vs = ks + kKeys * P;        // [kKeys][P]
  float* ps = vs + kKeys * P;        // [kRows][PS]: logits, then weights
  float* row_m = ps + kRows * PS;    // running max
  float* row_l = row_m + kRows;      // running sum
  float* row_a = row_l + kRows;      // rescale factor of this tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, split = blockIdx.y;
  const int rows = p.t_len * p.heads;
  const int row0 = blockIdx.x * kRows;
  const size_t batch_row0 = size_t(b) * rows;
  const int s_begin = split * p.chunk;
  const int s_end = min(p.s_len, s_begin + p.chunk);
  const T* qb = p.q + (batch_row0 + row0) * HD;
  const T* kb = p.k + size_t(b) * p.s_len * HD;
  const T* vb = p.v + size_t(b) * p.s_len * HD;

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[r * P + d] = (row0 + r < rows) ? to_f32(qb[size_t(r) * HD + d]) : 0.f;
  }
  if (tid < kRows) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  const uint8_t* mrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    mrow[i] = (p.mask != nullptr && r < rows)
                  ? p.mask + (size_t(b) * p.t_len + r / p.heads) * p.s_len
                  : nullptr;
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += kKeys) {
    const int n_keys = min(kKeys, s_end - s0);
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    for (int i = tid; i < kKeys * HD; i += kThreads) {
      const int key = i / HD, d = i % HD;
      const bool in = key < n_keys;
      ks[key * P + d] = in ? to_f32(kb[size_t(s0 + key) * HD + d]) : 0.f;
      vs[key * P + d] = in ? to_f32(vb[size_t(s0 + key) * HD + d]) : 0.f;
    }
    __syncthreads();

    // Logits: rows ty+16i, keys tx+16j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        float x = s[i][j];
        if (key >= n_keys) {
          x = -INFINITY;
        } else if (mrow[i] != nullptr && mrow[i][s0 + key] == 0) {
          x = kBigNeg;
        }
        ps[(ty + 16 * i) * PS + key] = x;
      }
    }
    __syncthreads();

    // Online softmax: warp w updates rows 8w..8w+7, two keys per lane.
    for (int rr = 0; rr < kRows / 8; ++rr) {
      const int r = warp * (kRows / 8) + rr;
      const float m_old = row_m[r];
      const float x0 = ps[r * PS + lane], x1 = ps[r * PS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);  // finite: every tile holds a real key
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[r * PS + lane] = round_to(p0, p.q);
      ps[r * PS + lane + 32] = round_to(p1, p.q);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P·V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_a[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PS + key];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        const float vv = (d < HD) ? vs[key * P + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  const size_t total_rows = size_t(gridDim.z) * rows;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (row0 + r >= rows) continue;
    const size_t g = size_t(split) * total_rows + batch_row0 + row0 + r;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) p.part_acc[g * HD + d] = acc[i][j];
    }
    if (tx == 0) {
      p.part_ml[2 * g] = row_m[r];
      p.part_ml[2 * g + 1] = row_l[r];
    }
  }
}

// One block per row: merge the splits, normalise, write out and lse.
template <typename T, int HD>
__global__ void __launch_bounds__(kCombineThreads)
flash_fwd_combine(const float* part_acc, const float* part_ml, T* out, float* lse, int total_rows, int splits) {
  const int row = blockIdx.x;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_ml[2 * (size_t(s) * total_rows + row)]);
  float l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t g = size_t(s) * total_rows + row;
    l += part_ml[2 * g + 1] * expf(part_ml[2 * g] - m);
  }
  for (int d = threadIdx.x; d < HD; d += kCombineThreads) {
    float o = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t g = size_t(s) * total_rows + row;
      o += part_acc[g * HD + d] * expf(part_ml[2 * g] - m);
    }
    store(out + size_t(row) * HD + d, o / l);
  }
  if (threadIdx.x == 0) lse[row] = m + logf(l);
}

template <typename T, int HD>
cudaError_t launch_flash_fwd(const FwdParams<T>& p, T* out, float* lse, int batch, int splits,
                             cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_partial<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int rows = p.t_len * p.heads;
  const dim3 grid((rows + kRows - 1) / kRows, splits, batch);
  flash_fwd_partial<T, HD><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_fwd_combine<T, HD><<<batch * rows, kCombineThreads, 0, stream>>>(p.part_acc, p.part_ml, out, lse,
                                                                        batch * rows, splits);
  return cudaGetLastError();
}

// The C entry points' body for f32 inputs (bf16 runs on the tensor-core kernels).
template <int HD>
int flash_fwd_entry(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                    void* part_acc, void* part_ml, int batch, int t_len, int s_len, int heads, int splits,
                    int chunk, void* stream) {
  if (batch <= 0 || t_len <= 0 || s_len <= 0 || heads <= 0 || splits <= 0 || chunk <= 0 || chunk % kKeys != 0 ||
      (splits - 1) * chunk >= s_len)
    return int(cudaErrorInvalidValue);
  const FwdParams<float> p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                           static_cast<const uint8_t*>(mask), static_cast<float*>(part_acc),
                           static_cast<float*>(part_ml), t_len, s_len, heads, chunk};
  return int(launch_flash_fwd<float, HD>(p, static_cast<float*>(out), static_cast<float*>(lse), batch, splits,
                                         static_cast<cudaStream_t>(stream)));
}

}  // namespace kai0
