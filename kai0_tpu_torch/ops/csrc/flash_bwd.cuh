// Shared body of the two flash-attention backward kernels (flash_mqa_bwd.cu,
// flash_mhsa_bwd.cu). Layout as in flash_fwd.cuh: a batch element holds `rows`
// query rows (MQA folds the N heads into rows t-major, row = t*N + n) that all
// attend to the same K/V sequence; dense head-major MHA is batch B*N, heads 1.
//
// Three kernels, no atomics, every output written once by one block:
//   1. delta[row] = sum_h dO*O in f32 (one warp per row);
//   2. dK/dV: one block per (batch, 32-key tile) loops over every query row in
//      64-row tiles, recomputes P from the forward's lse and accumulates
//      dV += P^T dO and dK += dS^T Q in f32 registers, then writes them once;
//   3. dQ: one block per (batch, 64-row tile) loops over the key tiles,
//      recomputes P and dS and accumulates dQ += dS K in f32 registers.
// P and dP are recomputed in both 2 and 3 (7 products instead of 5), the price
// of having no atomics and no f32 dQ scratch.
//
// Numerics (held to autograd of flash_mha_plain / flash_mhsa_plain):
//   * logits and dP = dO V^T accumulate in f32; P = exp(s - lse);
//   * dS = P (dP - delta) is zero at masked keys (the plain version's
//     where(mask, logits, BIG_NEG) passes no gradient there);
//   * a fully masked row (lse = BIG_NEG + log S rounds to BIG_NEG) has
//     P = 1/S on every key, as the plain softmax gives it, and dS = 0. The TPU
//     kernel instead recomputes exp(BIG_NEG - lse) = 1 there; on the training
//     graph dO is 0 on such rows, so the difference does not reach a gradient;
//   * keys past the ragged end of S are absent (P = 0), as in the forward;
//   * rounding points of the TPU kernel: P is rounded to the element type
//     before P^T dO, dS before dS K and dS^T Q; every product accumulates in f32.
//
// Simple first: scalar f32 FMAs from shared memory, as the forward. The C
// entries run these kernels on f32 inputs only; the tensor-core kernels of
// bf16 (flash_mqa_mma.cuh, flash_mhsa_mma.cuh) share the delta pass. A thread of
// the 16x16 grid owns 4 rows x 2 keys of the logit tile, and either 2 keys x
// ceil(H/16) columns of dK and dV (kernel 2) or 4 rows x ceil(H/16) columns of
// dQ (kernel 3). Shared-memory rows are padded to H+1 floats (bank spread).
#pragma once

#include "flash_fwd.cuh"

namespace kai0 {

constexpr int kBwdRows = 64;   // query rows per tile
constexpr int kBwdKeys = 32;   // keys per tile
constexpr float kFullyMasked = 0.5f * kBigNeg;  // an lse below this is a fully masked row

template <typename T>
struct BwdParams {
  const T* q;           // [batch, rows, HD]
  const T* k;           // [batch, s_len, HD]
  const T* v;           // [batch, s_len, HD]
  const uint8_t* mask;  // [batch, t_len, s_len] (0 = masked) or nullptr
  const T* out;         // [batch, rows, HD]
  const T* dout;        // [batch, rows, HD]
  const float* lse;     // [batch, rows]
  float* delta;         // [batch, rows] scratch
  T* dq;                // [batch, rows, HD]
  T* dk;                // [batch, s_len, HD]
  T* dv;                // [batch, s_len, HD]
  int t_len, s_len, heads;
};

template <int HD>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * size_t(kBwdRows) * (HD + 1) + 2 * size_t(kBwdKeys) * (HD + 1) +
                          2 * size_t(kBwdRows) * (kBwdKeys + 1) + 2 * kBwdRows);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(BwdParams<T> p, int total_rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  if (row >= total_rows) return;
  const T* o = p.out + size_t(row) * HD;
  const T* d = p.dout + size_t(row) * HD;
  float s = 0.f;
  for (int i = lane; i < HD; i += 32) s += to_f32(o[i]) * to_f32(d[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.delta[row] = s;
}

// Shared-memory tiles of one block; the same carve-up in kernels 2 and 3.
struct BwdSmem {
  float* qs;     // [kBwdRows][HD+1]
  float* dos;    // [kBwdRows][HD+1]
  float* ks;     // [kBwdKeys][HD+1]
  float* vs;     // [kBwdKeys][HD+1]
  float* ps;     // [kBwdRows][kBwdKeys+1]: P in the element type's precision
  float* dss;    // [kBwdRows][kBwdKeys+1]: dS in the element type's precision
  float* lse;    // [kBwdRows]
  float* delta;  // [kBwdRows]
};

template <int HD>
__device__ __forceinline__ BwdSmem carve(float* smem) {
  constexpr int P = HD + 1, PS = kBwdKeys + 1;
  BwdSmem s;
  s.qs = smem;
  s.dos = s.qs + kBwdRows * P;
  s.ks = s.dos + kBwdRows * P;
  s.vs = s.ks + kBwdKeys * P;
  s.ps = s.vs + kBwdKeys * P;
  s.dss = s.ps + kBwdRows * PS;
  s.lse = s.dss + kBwdRows * PS;
  s.delta = s.lse + kBwdRows;
  return s;
}

// Rows [row0, row0+kBwdRows) of one batch element: q and dO tiles, lse, delta.
// Rows past the end load as zeros with lse 0 and are never used (row_ok).
template <typename T, int HD>
__device__ __forceinline__ void load_rows(const BwdParams<T>& p, const BwdSmem& s, size_t batch_row0, int row0,
                                          int rows) {
  constexpr int P = HD + 1;
  const T* qb = p.q + (batch_row0 + row0) * HD;
  const T* db = p.dout + (batch_row0 + row0) * HD;
  for (int i = threadIdx.x; i < kBwdRows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const bool in = row0 + r < rows;
    s.qs[r * P + d] = in ? to_f32(qb[size_t(r) * HD + d]) : 0.f;
    s.dos[r * P + d] = in ? to_f32(db[size_t(r) * HD + d]) : 0.f;
  }
  if (threadIdx.x < kBwdRows) {
    const bool in = row0 + threadIdx.x < rows;
    s.lse[threadIdx.x] = in ? p.lse[batch_row0 + row0 + threadIdx.x] : 0.f;
    s.delta[threadIdx.x] = in ? p.delta[batch_row0 + row0 + threadIdx.x] : 0.f;
  }
}

// Keys [s0, s0+kBwdKeys) of one batch element; keys past the end load as zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_keys(const BwdParams<T>& p, const BwdSmem& s, int b, int s0) {
  constexpr int P = HD + 1;
  const T* kb = p.k + size_t(b) * p.s_len * HD;
  const T* vb = p.v + size_t(b) * p.s_len * HD;
  for (int i = threadIdx.x; i < kBwdKeys * HD; i += kThreads) {
    const int key = i / HD, d = i % HD;
    const bool in = s0 + key < p.s_len;
    s.ks[key * P + d] = in ? to_f32(kb[size_t(s0 + key) * HD + d]) : 0.f;
    s.vs[key * P + d] = in ? to_f32(vb[size_t(s0 + key) * HD + d]) : 0.f;
  }
}

// P and dS of the (row tile, key tile) pair, into s.ps and s.dss.
// Thread (tx, ty) computes rows ty+16i (i<4) and keys tx+16j (j<2).
template <typename T, int HD>
__device__ __forceinline__ void probs_tile(const BwdParams<T>& p, const BwdSmem& s, int b, int row0, int rows,
                                           int s0) {
  constexpr int P = HD + 1, PS = kBwdKeys + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float sc[4][2], dp[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], g[4], kk[2], vv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = s.qs[(ty + 16 * i) * P + d];
      g[i] = s.dos[(ty + 16 * i) * P + d];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kk[j] = s.ks[(tx + 16 * j) * P + d];
      vv[j] = s.vs[(tx + 16 * j) * P + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
  const float inv_s = 1.f / float(p.s_len);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool row_ok = row0 + r < rows;
    const uint8_t* mrow =
        (p.mask != nullptr && row_ok) ? p.mask + (size_t(b) * p.t_len + (row0 + r) / p.heads) * p.s_len : nullptr;
    const float l = s.lse[r], dl = s.delta[r];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = tx + 16 * j;
      float pv = 0.f, dsv = 0.f;
      if (row_ok && s0 + key < p.s_len) {
        if (mrow != nullptr && mrow[s0 + key] == 0) {
          pv = (l < kFullyMasked) ? inv_s : 0.f;
        } else {
          pv = expf(sc[i][j] - l);
          dsv = pv * (dp[i][j] - dl);
        }
      }
      s.ps[r * PS + key] = round_to(pv, p.q);
      s.dss[r * PS + key] = round_to(dsv, p.q);
    }
  }
}

// Kernel 2: dK and dV of 32 keys, over every query row of the batch element.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(BwdParams<T> p) {
  constexpr int P = HD + 1, PS = kBwdKeys + 1;
  constexpr int DPT = (HD + 15) / 16;
  extern __shared__ float smem[];
  const BwdSmem s = carve<HD>(smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.y, s0 = blockIdx.x * kBwdKeys;
  const int rows = p.t_len * p.heads;
  const size_t batch_row0 = size_t(b) * rows;

  load_keys<T, HD>(p, s, b, s0);
  float dk[2][DPT], dv[2][DPT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int row0 = 0; row0 < rows; row0 += kBwdRows) {
    __syncthreads();  // the previous tile's qs/dos/ps/dss are no longer read
    load_rows<T, HD>(p, s, batch_row0, row0, rows);
    __syncthreads();
    probs_tile<T, HD>(p, s, b, row0, rows, s0);
    __syncthreads();
    // Keys ty+16i (i<2), columns tx+16j.
#pragma unroll 2
    for (int r = 0; r < kBwdRows; ++r) {
      float pa[2], da[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pa[i] = s.ps[r * PS + ty + 16 * i];
        da[i] = s.dss[r * PS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        const float g = (d < HD) ? s.dos[r * P + d] : 0.f;
        const float q = (d < HD) ? s.qs[r * P + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dv[i][j] = fmaf(pa[i], g, dv[i][j]);
          dk[i][j] = fmaf(da[i], q, dk[i][j]);
        }
      }
    }
  }

  const size_t key_base = size_t(b) * p.s_len + s0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = ty + 16 * i;
    if (s0 + key >= p.s_len) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) {
        store(p.dk + (key_base + key) * HD + d, dk[i][j]);
        store(p.dv + (key_base + key) * HD + d, dv[i][j]);
      }
    }
  }
}

// Kernel 3: dQ of 64 query rows, over every key of the batch element.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(BwdParams<T> p) {
  constexpr int P = HD + 1, PS = kBwdKeys + 1;
  constexpr int DPT = (HD + 15) / 16;
  extern __shared__ float smem[];
  const BwdSmem s = carve<HD>(smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.y, row0 = blockIdx.x * kBwdRows;
  const int rows = p.t_len * p.heads;
  const size_t batch_row0 = size_t(b) * rows;

  load_rows<T, HD>(p, s, batch_row0, row0, rows);
  float dq[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dq[i][j] = 0.f;

  for (int s0 = 0; s0 < p.s_len; s0 += kBwdKeys) {
    __syncthreads();  // the previous tile's ks/vs/dss are no longer read
    load_keys<T, HD>(p, s, b, s0);
    __syncthreads();
    probs_tile<T, HD>(p, s, b, row0, rows, s0);
    __syncthreads();
    // Rows ty+16i (i<4), columns tx+16j.
#pragma unroll 4
    for (int key = 0; key < kBwdKeys; ++key) {
      float da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = s.dss[(ty + 16 * i) * PS + key];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        const float kv = (d < HD) ? s.ks[key * P + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(da[i], kv, dq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (row0 + r >= rows) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) store(p.dq + (batch_row0 + row0 + r) * HD + d, dq[i][j]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_flash_bwd(const BwdParams<T>& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int rows = p.t_len * p.heads;
  const int total_rows = batch * rows;
  constexpr int kWarps = kThreads / 32;
  flash_bwd_delta<T, HD><<<(total_rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(p, total_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<T, HD><<<dim3((p.s_len + kBwdKeys - 1) / kBwdKeys, batch), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, HD><<<dim3((rows + kBwdRows - 1) / kBwdRows, batch), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The C entry points' body for f32 inputs (bf16 runs on the tensor-core kernels).
template <int HD>
int flash_bwd_entry(const void* q, const void* k, const void* v, const void* mask, const void* out,
                    const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv, int batch,
                    int t_len, int s_len, int heads, void* stream) {
  if (batch <= 0 || t_len <= 0 || s_len <= 0 || heads <= 0) return int(cudaErrorInvalidValue);
  using T = float;
  const BwdParams<T> p{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                       static_cast<const uint8_t*>(mask), static_cast<const T*>(out), static_cast<const T*>(dout),
                       static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<T*>(dq),
                       static_cast<T*>(dk), static_cast<T*>(dv), t_len, s_len, heads};
  return int(launch_flash_bwd<T, HD>(p, batch, static_cast<cudaStream_t>(stream)));
}

}  // namespace kai0
