// Tensor-core bodies of the bf16 MQA attention kernels: K1f (flash_mqa_fwd.cu)
// and K1b (flash_mqa_bwd.cu), head_dim 256, at least 8 query heads per K/V head.
// The f32 instantiations stay on the scalar kernels of flash_fwd.cuh /
// flash_bwd.cuh (a choice by element type: their 1e-4 checks need f32 FMAs).
//
// Layout as in flash_fwd.cuh: the N query heads fold into rows t-major
// (row = t*N + n), every row of a batch element attends to the same K/V, and a
// 64-row tile spans at most 9 positions of the mask. Every product is a warp's
// `mma.sync.m16n8k16` on bf16 operands with f32 accumulation. Operand tiles live
// in shared memory as 512-byte rows of 32 chunks of 16 bytes, chunk c of row r
// stored at c ^ (r & 7), so that the 8 rows an `ldmatrix` reads fall in 8
// distinct bank groups; they arrive through `cp.async` (rows past the end with a
// source size of 0, i.e. zeros). The mask is read byte-wise (its rows are not
// 16-byte aligned) one tile ahead into registers and parked in shared memory.
//
// Forward (4 warps, 64 rows a block, each warp 16 rows): Q is loaded once; K and
// V stream in 64-key tiles, V's load overlapping S = Q K^T and the next K's
// overlapping the softmax and P V (FlashAttention-2's order), so Q, K and V take
// 96 KB and two blocks share an SM. The online softmax runs on the S
// accumulators in registers (row max and sum over the quad of lanes that holds a
// row); the unnormalised exp(s - m) becomes P's bf16 A fragments directly, and
// the 16 x 256 f32 output accumulator (128 registers a thread) never leaves
// registers. One split writes out and lse; several write partial sums that
// flash_fwd_combine merges.
//
// Backward (8 warps): delta = rowsum(dO * O) (flash_bwd_delta), then two
// kernels that write every output once, with no atomics (deterministic):
//   dK/dV: a block owns 64 keys and walks all row tiles of its batch element
//          (Q and dO double-buffered); per tile S and dP = dO V^T (each warp 16
//          rows x 32 keys), P and dS = P (dP - delta) rounded to bf16 into
//          shared memory, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
//          read by `ldmatrix.trans` (each warp 16 keys x 128 columns of both,
//          128 f32 registers a thread);
//   dQ:    a block owns 64 rows and walks the key tiles (K and V
//          double-buffered): S, dP and dS again, then dQ += dS K.
// Numerics are those of the scalar kernels (see their headers): masked logits
// kBigNeg, keys past S absent, a fully masked row averages V (forward) and has
// P = 1/S, dS = 0 (backward); P is rounded to bf16 before P V / P^T dO, dS
// before dS K / dS^T Q; sums in f32.
#pragma once

#include "flash_bwd.cuh"
#include "ptx.cuh"

namespace kai0 {
namespace mqa_mma {

using bf16 = __nv_bfloat16;

constexpr int kHD = 256;
constexpr int kRowBytes = kHD * 2;
constexpr int kTile = 64;  // rows of a query tile, keys of a key tile (= kKeys: splits are multiples of it)
constexpr int kTileBytes = kTile * kRowBytes;
constexpr int kProbBytes = kTile * kTile * 2;  // a 64 x 64 bf16 tile of P or dS, 128-byte rows
constexpr int kMaskPos = 9;                    // positions of the mask a 64-row tile spans (heads >= 8)
constexpr int kMaskBytes = kMaskPos * kTile;
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
constexpr size_t kFwdSmem = 3 * size_t(kTileBytes) + 2 * kMaskBytes;
constexpr size_t kDkdvSmem = 6 * size_t(kTileBytes) + 2 * size_t(kProbBytes) + 2 * kMaskBytes;
constexpr size_t kDqSmem = 6 * size_t(kTileBytes) + size_t(kProbBytes) + 2 * kMaskBytes;

// Byte offset of 16-byte chunk c of row r: 512-byte operand rows, 128-byte P / dS rows.
__device__ __forceinline__ uint32_t swz(int r, int c) { return uint32_t(r * kRowBytes + ((c ^ (r & 7)) << 4)); }
__device__ __forceinline__ uint32_t swz_p(int r, int c) { return uint32_t(r * 128 + ((c ^ (r & 7)) << 4)); }

// Rows [0, valid) of a 64 x 256 bf16 tile at src into the swizzled tile at dst; the other rows become zeros.
template <int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int valid) {
  for (int i = threadIdx.x; i < kTile * (kRowBytes / 16); i += NT) {
    const int r = i >> 5, c = i & 31;
    const bool ok = r < valid;
    cp_async16(dst + swz(r, c), ok ? src + size_t(r) * kHD + c * 8 : src, ok ? 16 : 0);
  }
}

// First position and number of positions of the query rows [row0, row0 + 64) ∩ [0, rows).
__device__ __forceinline__ void tile_positions(int row0, int rows, int heads, int& t_first, int& n_pos) {
  t_first = row0 / heads;
  n_pos = (min(row0 + kTile, rows) - 1) / heads - t_first + 1;
}

// Offset in a mask tile of the row of query row `row` (clamped: rows past the end read some row).
__device__ __forceinline__ int mask_row(int row, int heads, int t_first) {
  return min(row / heads - t_first, kMaskPos - 1) * kTile;
}

// The mask bytes of one tile, [kMaskPos positions][64 keys], held in registers between load and store.
template <int NT>
struct MaskPrefetch {
  static constexpr int kN = (kMaskBytes + NT - 1) / NT;
  uint32_t v[kN];

  // positions [t_first, t_first + n_pos) and keys [s0, s0 + n_keys) of mask_b [t_len, s_len]; zeros elsewhere
  __device__ __forceinline__ void load(const uint8_t* mask_b, int s_len, int t_first, int n_pos, int s0, int n_keys) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + i * NT, pos = idx / kTile, key = idx % kTile;
      v[i] = (pos < n_pos && key < n_keys) ? __ldg(mask_b + size_t(t_first + pos) * s_len + s0 + key) : 0u;
    }
  }
  __device__ __forceinline__ void store(uint8_t* m_s) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (idx < kMaskBytes) m_s[idx] = uint8_t(v[i]);
    }
  }
};

// The two mask bytes of keys (key, key + 1) of the row at offset mrow; key is even.
__device__ __forceinline__ uint32_t mask_pair(const uint8_t* m_s, int mrow, int key) {
  return *reinterpret_cast<const uint16_t*>(m_s + mrow + key);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Kernels and entries are templates on the head dim (256 only) so that a source instantiates what it launches.
template <int HD>
__global__ void __launch_bounds__(kFwdThreads, 2) mqa_fwd(FwdParams<bf16> p, bf16* out, float* lse, int splits) {
  static_assert(HD == kHD, "head_dim 256 only");
  extern __shared__ __align__(128) uint8_t mqa_smem[];
  const uint32_t q_s = smem_u32(mqa_smem), k_s = q_s + kTileBytes, v_s = k_s + kTileBytes;
  uint8_t* m_s = mqa_smem + 3 * kTileBytes;  // two mask tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const int b = blockIdx.z, split = blockIdx.y;
  const int rows = p.t_len * p.heads, row0 = blockIdx.x * kTile;
  const int s_begin = split * p.chunk, s_end = min(p.s_len, s_begin + p.chunk);
  const int n_tiles = (s_end - s_begin + kTile - 1) / kTile;
  const bf16* kb = p.k + size_t(b) * p.s_len * kHD;
  const bf16* vb = p.v + size_t(b) * p.s_len * kHD;
  const uint8_t* mask_b = p.mask + size_t(b) * p.t_len * p.s_len;
  int t_first, n_pos;
  tile_positions(row0, rows, p.heads, t_first, n_pos);
  const int wrow = 16 * warp;  // the warp's rows in the tile; this thread's are wrow + g and wrow + g + 8
  const int mrow[2] = {mask_row(row0 + wrow + g, p.heads, t_first), mask_row(row0 + wrow + g + 8, p.heads, t_first)};

  load_tile<kFwdThreads>(q_s, p.q + (size_t(b) * rows + row0) * kHD, rows - row0);
  load_tile<kFwdThreads>(k_s, kb + size_t(s_begin) * kHD, s_end - s_begin);
  cp_async_commit();
  MaskPrefetch<kFwdThreads> mk;
  mk.load(mask_b, p.s_len, t_first, n_pos, s_begin, min(kTile, s_end - s_begin));
  mk.store(m_s);

  float o[kHD / 8][4];
#pragma unroll
  for (int n = 0; n < kHD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int s0 = s_begin + j * kTile, n_keys = min(kTile, s_end - s0);
    const bool more = j + 1 < n_tiles;
    const uint8_t* m_cur = m_s + (j & 1) * kMaskBytes;
    cp_async_wait_all();
    __syncthreads();  // K_j and mask tile j are in; every warp is done with V_{j-1}
    load_tile<kFwdThreads>(v_s, vb + size_t(s0) * kHD, n_keys);
    cp_async_commit();
    if (more) mk.load(mask_b, p.s_len, t_first, n_pos, s0 + kTile, min(kTile, s_end - s0 - kTile));

    // S = Q K^T: 16 rows x 64 keys a warp, 8 accumulator tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + swz(wrow + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * kk + (lane >> 4)));
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_s + swz(16 * nj + (lane & 7) + (lane >> 4) * 8, 2 * kk + ((lane >> 3) & 1)));
        mma_bf16(s[2 * nj], a, bk[0], bk[1]);
        mma_bf16(s[2 * nj + 1], a, bk[2], bk[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // V_j is in; every warp is done with K_j
    if (more) {
      load_tile<kFwdThreads>(k_s, kb + size_t(s0 + kTile) * kHD, min(kTile, s_end - s0 - kTile));
      cp_async_commit();
    }

    // Online softmax over the row's 64 keys: the quad of lanes 4g..4g+3 holds row g (and g + 8).
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int key = 8 * n + 2 * c4;
        const uint32_t mm = mask_pair(m_cur, mrow[h], key);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[n][2 * h + e];
          if (key + e >= n_keys) {
            x = -INFINITY;
          } else if (((mm >> (8 * e)) & 0xffu) == 0) {
            x = kBigNeg;
          }
          s[n][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);  // finite: every tile holds a real key
      alpha[h] = expf(m_run[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = expf(s[n][2 * h + e] - m_new);
          s[n][2 * h + e] = pv;
          sum += pv;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[h] = l_run[h] * alpha[h] + sum;
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: the S accumulators of keys 16kk..16kk+15 are P's A fragment; V^T by ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < kHD / 16; ++nd) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_s + swz(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * nd + (lane >> 4)));
        mma_bf16(o[2 * nd], a, bv[0], bv[1]);
        mma_bf16(o[2 * nd + 1], a, bv[2], bv[3]);
      }
    }
    if (more) mk.store(m_s + ((j + 1) & 1) * kMaskBytes);
  }

  const size_t total_rows = size_t(gridDim.z) * rows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wrow + g + 8 * h;
    if (r >= rows) continue;
    const size_t grow = size_t(b) * rows + r;
    if (splits == 1) {
      const float l = l_run[h];
      bf16* dst = out + grow * kHD + 2 * c4;
#pragma unroll
      for (int n = 0; n < kHD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(o[n][2 * h] / l, o[n][2 * h + 1] / l);
      if (c4 == 0) lse[grow] = m_run[h] + logf(l);
    } else {
      const size_t gs = size_t(split) * total_rows + grow;
      float* dst = p.part_acc + gs * kHD + 2 * c4;
#pragma unroll
      for (int n = 0; n < kHD / 8; ++n) *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if (c4 == 0) {
        p.part_ml[2 * gs] = m_run[h];
        p.part_ml[2 * gs + 1] = l_run[h];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// S = Q K^T and dP = dO V^T of one warp's 16 rows (from wrow) x 32 keys (from wkey) of a 64 x 64 tile pair.
__device__ __forceinline__ void scores(float (&s)[4][4], float (&dp)[4][4], uint32_t q_s, uint32_t do_s, uint32_t k_s,
                                       uint32_t v_s, int wrow, int wkey, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) {
    const uint32_t a_off = swz(wrow + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * kk + (lane >> 4));
    uint32_t aq[4], ad[4];
    ldmatrix_x4(aq, q_s + a_off);
    ldmatrix_x4(ad, do_s + a_off);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const uint32_t b_off = swz(wkey + 16 * nj + (lane & 7) + (lane >> 4) * 8, 2 * kk + ((lane >> 3) & 1));
      uint32_t bk[4], bv[4];
      ldmatrix_x4(bk, k_s + b_off);
      ldmatrix_x4(bv, v_s + b_off);
      mma_bf16(s[2 * nj], aq, bk[0], bk[1]);
      mma_bf16(s[2 * nj + 1], aq, bk[2], bk[3]);
      mma_bf16(dp[2 * nj], ad, bv[0], bv[1]);
      mma_bf16(dp[2 * nj + 1], ad, bv[2], bv[3]);
    }
  }
}

// Per-row inputs of the elementwise step for this thread's two rows.
struct RowStats {
  float lse[2], delta[2];
  bool ok[2];
  int mrow[2];
};

__device__ __forceinline__ RowStats row_stats(const BwdParams<bf16>& p, int b, int rows, int row0, int wrow, int g,
                                              int t_first) {
  RowStats st;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wrow + g + 8 * h;
    st.ok[h] = r < rows;
    st.lse[h] = st.ok[h] ? p.lse[size_t(b) * rows + r] : 0.f;
    st.delta[h] = st.ok[h] ? p.delta[size_t(b) * rows + r] : 0.f;
    st.mrow[h] = mask_row(r, p.heads, t_first);
  }
  return st;
}

// P = exp(s - lse) and dS = P (dP - delta) with the mask rules, rounded to bf16, into the P / dS tiles
// (p_s may be null). Keys [0, n_keys) of the tile are real.
__device__ __forceinline__ void probs(const float (&s)[4][4], const float (&dp)[4][4], const RowStats& st,
                                      const uint8_t* m_cur, int n_keys, float inv_s, uint8_t* p_s, uint8_t* ds_s,
                                      int wrow, int wkey, int g, int c4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + g + 8 * h;
    const bool fully_masked = st.lse[h] < kFullyMasked;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int key = wkey + 8 * n + 2 * c4;
      const uint32_t mm = mask_pair(m_cur, st.mrow[h], key);
      float pv[2], dsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pv[e] = dsv[e] = 0.f;
        if (st.ok[h] && key + e < n_keys) {
          if (((mm >> (8 * e)) & 0xffu) == 0) {
            pv[e] = fully_masked ? inv_s : 0.f;
          } else {
            pv[e] = expf(s[n][2 * h + e] - st.lse[h]);
            dsv[e] = pv[e] * (dp[n][2 * h + e] - st.delta[h]);
          }
        }
      }
      const uint32_t off = swz_p(row, key >> 3) + (key & 7) * 2;
      if (p_s != nullptr) *reinterpret_cast<uint32_t*>(p_s + off) = pack_bf16(pv[0], pv[1]);
      *reinterpret_cast<uint32_t*>(ds_s + off) = pack_bf16(dsv[0], dsv[1]);
    }
  }
}

// dK and dV of 64 keys over every query row of one batch element.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1) mqa_bwd_dkdv(BwdParams<bf16> p) {
  static_assert(HD == kHD, "head_dim 256 only");
  extern __shared__ __align__(128) uint8_t mqa_smem[];
  const uint32_t k_s = smem_u32(mqa_smem), v_s = k_s + kTileBytes;
  const uint32_t q_s0 = v_s + kTileBytes;          // two Q tiles
  const uint32_t do_s0 = q_s0 + 2 * kTileBytes;    // two dO tiles
  uint8_t* p_s = mqa_smem + 6 * kTileBytes;
  uint8_t* ds_s = p_s + kProbBytes;
  uint8_t* m_s = ds_s + kProbBytes;                // two mask tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const int b = blockIdx.y, s0 = blockIdx.x * kTile, n_keys = min(kTile, p.s_len - s0);
  const int rows = p.t_len * p.heads, n_row_tiles = (rows + kTile - 1) / kTile;
  const int wrow = 16 * (warp & 3), wkey = 32 * (warp >> 2);  // scores: 16 rows x 32 keys
  const int dkey = 16 * (warp & 3), dcol = 128 * (warp >> 2);  // dK/dV: 16 keys x 128 columns
  const bf16* qb = p.q + size_t(b) * rows * kHD;
  const bf16* dob = p.dout + size_t(b) * rows * kHD;
  const uint8_t* mask_b = p.mask + size_t(b) * p.t_len * p.s_len;
  const float inv_s = 1.f / float(p.s_len);

  load_tile<kBwdThreads>(k_s, p.k + (size_t(b) * p.s_len + s0) * kHD, n_keys);
  load_tile<kBwdThreads>(v_s, p.v + (size_t(b) * p.s_len + s0) * kHD, n_keys);
  load_tile<kBwdThreads>(q_s0, qb, rows);
  load_tile<kBwdThreads>(do_s0, dob, rows);
  cp_async_commit();
  int t_first, n_pos;
  tile_positions(0, rows, p.heads, t_first, n_pos);
  MaskPrefetch<kBwdThreads> mk;
  mk.load(mask_b, p.s_len, t_first, n_pos, s0, n_keys);
  mk.store(m_s);

  float dk[16][4], dv[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < n_row_tiles; ++it) {
    const int row0 = it * kTile, buf = it & 1;
    const bool more = it + 1 < n_row_tiles;
    const uint32_t q_s = q_s0 + buf * kTileBytes, do_s = do_s0 + buf * kTileBytes;
    tile_positions(row0, rows, p.heads, t_first, n_pos);
    cp_async_wait_all();
    __syncthreads();  // row tile `it` and its mask are in; every warp is done with tile it-1
    if (more) {
      load_tile<kBwdThreads>(q_s0 + (buf ^ 1) * kTileBytes, qb + size_t(row0 + kTile) * kHD, rows - row0 - kTile);
      load_tile<kBwdThreads>(do_s0 + (buf ^ 1) * kTileBytes, dob + size_t(row0 + kTile) * kHD, rows - row0 - kTile);
      cp_async_commit();
      int tf, np;
      tile_positions(row0 + kTile, rows, p.heads, tf, np);
      mk.load(mask_b, p.s_len, tf, np, s0, n_keys);
    }
    const RowStats st = row_stats(p, b, rows, row0, wrow, g, t_first);
    float s[4][4], dp[4][4];
    scores(s, dp, q_s, do_s, k_s, v_s, wrow, wkey, lane);
    probs(s, dp, st, m_s + buf * kMaskBytes, n_keys, inv_s, p_s, ds_s, wrow, wkey, g, c4);
    __syncthreads();  // P and dS are in

    // dV += P^T dO, dK += dS^T Q over the tile's 64 rows; P^T and dS^T by ldmatrix.trans.
    const uint32_t ps = smem_u32(p_s), dss = smem_u32(ds_s);
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      const uint32_t a_off = swz_p(16 * ks + (lane & 7) + (lane >> 4) * 8, (dkey >> 3) + ((lane >> 3) & 1));
      uint32_t ap[4], ad[4];
      ldmatrix_x4_trans(ap, ps + a_off);
      ldmatrix_x4_trans(ad, dss + a_off);
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        const uint32_t b_off = swz(16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8, (dcol >> 3) + 2 * nd + (lane >> 4));
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, do_s + b_off);
        ldmatrix_x4_trans(bq, q_s + b_off);
        mma_bf16(dv[2 * nd], ap, bo[0], bo[1]);
        mma_bf16(dv[2 * nd + 1], ap, bo[2], bo[3]);
        mma_bf16(dk[2 * nd], ad, bq[0], bq[1]);
        mma_bf16(dk[2 * nd + 1], ad, bq[2], bq[3]);
      }
    }
    if (more) mk.store(m_s + (buf ^ 1) * kMaskBytes);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = s0 + dkey + g + 8 * h;
    if (key >= p.s_len) continue;
    const size_t off = (size_t(b) * p.s_len + key) * kHD + dcol + 2 * c4;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off + 8 * n) = __floats2bfloat162_rn(dk[n][2 * h], dk[n][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off + 8 * n) = __floats2bfloat162_rn(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

// dQ of 64 query rows over every key of one batch element.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1) mqa_bwd_dq(BwdParams<bf16> p) {
  static_assert(HD == kHD, "head_dim 256 only");
  extern __shared__ __align__(128) uint8_t mqa_smem[];
  const uint32_t q_s = smem_u32(mqa_smem), do_s = q_s + kTileBytes;
  const uint32_t k_s0 = do_s + kTileBytes;       // two K tiles
  const uint32_t v_s0 = k_s0 + 2 * kTileBytes;   // two V tiles
  uint8_t* ds_s = mqa_smem + 6 * kTileBytes;
  uint8_t* m_s = ds_s + kProbBytes;              // two mask tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const int b = blockIdx.y, row0 = blockIdx.x * kTile;
  const int rows = p.t_len * p.heads, n_key_tiles = (p.s_len + kTile - 1) / kTile;
  const int wrow = 16 * (warp & 3), wkey = 32 * (warp >> 2);  // scores: 16 rows x 32 keys
  const int dcol = 128 * (warp >> 2);                          // dQ: rows wrow x 128 columns
  const bf16* kb = p.k + size_t(b) * p.s_len * kHD;
  const bf16* vb = p.v + size_t(b) * p.s_len * kHD;
  const uint8_t* mask_b = p.mask + size_t(b) * p.t_len * p.s_len;
  const float inv_s = 1.f / float(p.s_len);
  int t_first, n_pos;
  tile_positions(row0, rows, p.heads, t_first, n_pos);

  load_tile<kBwdThreads>(q_s, p.q + (size_t(b) * rows + row0) * kHD, rows - row0);
  load_tile<kBwdThreads>(do_s, p.dout + (size_t(b) * rows + row0) * kHD, rows - row0);
  load_tile<kBwdThreads>(k_s0, kb, p.s_len);
  load_tile<kBwdThreads>(v_s0, vb, p.s_len);
  cp_async_commit();
  MaskPrefetch<kBwdThreads> mk;
  mk.load(mask_b, p.s_len, t_first, n_pos, 0, min(kTile, p.s_len));
  mk.store(m_s);
  const RowStats st = row_stats(p, b, rows, row0, wrow, g, t_first);

  float dq[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int j = 0; j < n_key_tiles; ++j) {
    const int s0 = j * kTile, n_keys = min(kTile, p.s_len - s0), buf = j & 1;
    const bool more = j + 1 < n_key_tiles;
    const uint32_t k_s = k_s0 + buf * kTileBytes, v_s = v_s0 + buf * kTileBytes;
    cp_async_wait_all();
    __syncthreads();  // key tile j and its mask are in; every warp is done with tile j-1
    if (more) {
      const int next = min(kTile, p.s_len - s0 - kTile);
      load_tile<kBwdThreads>(k_s0 + (buf ^ 1) * kTileBytes, kb + size_t(s0 + kTile) * kHD, next);
      load_tile<kBwdThreads>(v_s0 + (buf ^ 1) * kTileBytes, vb + size_t(s0 + kTile) * kHD, next);
      cp_async_commit();
      mk.load(mask_b, p.s_len, t_first, n_pos, s0 + kTile, next);
    }
    float s[4][4], dp[4][4];
    scores(s, dp, q_s, do_s, k_s, v_s, wrow, wkey, lane);
    probs(s, dp, st, m_s + buf * kMaskBytes, n_keys, inv_s, nullptr, ds_s, wrow, wkey, g, c4);
    __syncthreads();  // dS is in

    // dQ += dS K: dS's A fragments straight from its tile, K as the B operand by ldmatrix.trans.
    const uint32_t dss = smem_u32(ds_s);
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, dss + swz_p(wrow + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * ks + (lane >> 4)));
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, k_s + swz(16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8, (dcol >> 3) + 2 * nd + (lane >> 4)));
        mma_bf16(dq[2 * nd], a, bk[0], bk[1]);
        mma_bf16(dq[2 * nd + 1], a, bk[2], bk[3]);
      }
    }
    if (more) mk.store(m_s + (buf ^ 1) * kMaskBytes);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wrow + g + 8 * h;
    if (r >= rows) continue;
    bf16* dst = p.dq + (size_t(b) * rows + r) * kHD + dcol + 2 * c4;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(dq[n][2 * h], dq[n][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// C entry points' bodies
// ---------------------------------------------------------------------------

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <int HD>
int fwd_entry(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse, void* part_acc,
              void* part_ml, int batch, int t_len, int s_len, int heads, int splits, int chunk, void* stream) {
  if (batch <= 0 || t_len <= 0 || s_len <= 0 || heads < 8 || splits <= 0 || chunk <= 0 || chunk % kTile != 0 ||
      (splits - 1) * chunk >= s_len || (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdParams<bf16> p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                          static_cast<const uint8_t*>(mask), static_cast<float*>(part_acc),
                          static_cast<float*>(part_ml), t_len, s_len, heads, chunk};
  bf16* o = static_cast<bf16*>(out);
  float* l = static_cast<float*>(lse);
  cudaError_t err = cudaFuncSetAttribute(mqa_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kFwdSmem));
  if (err != cudaSuccess) return int(err);
  const int rows = t_len * heads;
  mqa_fwd<HD><<<dim3((rows + kTile - 1) / kTile, splits, batch), kFwdThreads, kFwdSmem, st>>>(p, o, l, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  flash_fwd_combine<bf16, kHD><<<batch * rows, kCombineThreads, 0, st>>>(p.part_acc, p.part_ml, o, l, batch * rows,
                                                                         splits);
  return int(cudaGetLastError());
}

template <int HD>
int bwd_entry(const void* q, const void* k, const void* v, const void* mask, const void* out, const void* dout,
              const void* lse, void* delta, void* dq, void* dk, void* dv, int batch, int t_len, int s_len, int heads,
              void* stream) {
  if (batch <= 0 || t_len <= 0 || s_len <= 0 || heads < 8 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(dout) || !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = t_len * heads, total_rows = batch * rows;
  const BwdParams<bf16> p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                          static_cast<const uint8_t*>(mask), static_cast<const bf16*>(out),
                          static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
                          static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_len, s_len, heads};
  // delta = rowsum(dO * O), by the scalar kernels' delta pass
  constexpr int kWarps = kThreads / 32;
  flash_bwd_delta<bf16, kHD><<<(total_rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(p, total_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(mqa_bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kDkdvSmem));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(mqa_bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kDqSmem));
  if (err != cudaSuccess) return int(err);
  mqa_bwd_dkdv<HD><<<dim3((s_len + kTile - 1) / kTile, batch), kBwdThreads, kDkdvSmem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  mqa_bwd_dq<HD><<<dim3((rows + kTile - 1) / kTile, batch), kBwdThreads, kDqSmem, st>>>(p);
  return int(cudaGetLastError());
}

}  // namespace mqa_mma
}  // namespace kai0
