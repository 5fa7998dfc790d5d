// Tensor-core bodies of the bf16 SigLIP attention kernels: K2f (flash_mhsa_fwd.cu)
// and K2b (flash_mhsa_bwd.cu), dense head-major attention at head_dim 72. The
// f32 instantiations stay on the scalar kernels of flash_fwd.cuh /
// flash_bwd.cuh (a choice by element type: their 1e-4 checks need f32 FMAs).
//
// Layout: q/k/v [B*N, T or S, 72], every (image, head) one batch element; q is
// pre-scaled by the caller and there is no mask. A bf16 row is 144 bytes, nine
// 16-byte chunks, so `cp.async` fetches rows of the contiguous tensors as they
// are (rows past the end with a source size of 0, i.e. zeros) and shared memory
// keeps the same 144-byte stride, unswizzled: the 8 rows an `ldmatrix` reads at
// one chunk start 144 bytes apart, which is 4 banks apart, so they fall in 8
// distinct groups of 4 banks. Every product is a warp's `mma.sync` on bf16
// operands with f32 accumulation:
//   * the 72-deep contractions (S = Q K^T, dP = dO V^T) are four m16n8k16 steps
//     and one m16n8k8 step over columns 64-71;
//   * the 72-wide outputs (P V, P^T dO, dS^T Q, dS K) are nine n8 tiles; each
//     tile's B operand for 32 keys (or rows) comes from one `ldmatrix.x4.trans`
//     at 32 consecutive rows of one chunk.
//
// Forward (4 warps, 64 query rows a block, each warp 16): K and V stream in
// 64-key tiles, double-buffered, the next tile's `cp.async` overlapping this
// tile's products. The online softmax runs on the S accumulators in registers,
// as 2^(x log2 e) on the special-function unit; the unnormalised exp(s - m)
// becomes P's bf16 A fragments directly, and the 16 x 72 f32 output (36
// registers a thread) never leaves registers. The block writes out and lse: no
// split of the key axis, no combine pass, no f32 workspace. 46 KB of shared
// memory and at most 128 registers a thread: four blocks an SM. (Measured on
// the H100 at [96,16,256,72]: Q's fragments held across the key tiles, 128-row
// blocks and 32-row blocks were no faster.)
//
// Backward (8 warps): delta = rowsum(dO * O) (flash_bwd_delta), then two
// kernels that write every output once, with no atomics (deterministic):
//   dK/dV: a block owns 64 keys and walks the row tiles (Q and dO
//          double-buffered); per tile S and dP (each warp 16 rows x 32 keys), P
//          and dS = P (dP - delta) rounded to bf16 into shared memory, then
//          warps 0-3 take dV += P^T dO and warps 4-7 dK += dS^T Q, each 16 keys
//          x 72 columns (36 f32 registers a thread), P^T and dS^T by
//          `ldmatrix.trans`;
//   dQ:    a block owns 64 rows and walks the key tiles (K and V
//          double-buffered): S, dP and dS again, then dQ += dS K, warps 0-3 on
//          columns 0-39 and warps 4-7 on columns 40-71 of their 16 rows.
// Numerics are those of the scalar kernels and of `_mhsa_fwd_kernel` /
// `_mhsa_bwd_kernel` (kai0_tpu/ops/pallas_attention.py): f32 logits over the
// unscaled q K^T, softmax statistics in f32, P rounded to bf16 before P V and
// P^T dO, dS before dS K and dS^T Q, every sum in f32, dK/dV written once in
// k's type. Keys past S are absent (weight 0).
#pragma once

#include "flash_bwd.cuh"
#include "ptx.cuh"

namespace kai0 {
namespace mhsa_mma {

using bf16 = __nv_bfloat16;

constexpr int kHD = 72;
constexpr int kRowBytes = kHD * 2;          // 144
constexpr int kChunks = kRowBytes / 16;     // 9
constexpr int kNTiles = kHD / 8;            // 9 n8 tiles of a 72-wide output
constexpr int kTile = 64;                   // rows of a query tile, keys of a key tile
constexpr int kTileBytes = kTile * kRowBytes;
constexpr int kProbBytes = kTile * kTile * 2;  // a 64 x 64 bf16 tile of P or dS, 128-byte rows
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kFwdSmem = 5 * size_t(kTileBytes);                          // Q, 2 x (K, V)
constexpr size_t kDkdvSmem = 6 * size_t(kTileBytes) + 2 * size_t(kProbBytes);  // K, V, 2 x (Q, dO), P, dS
constexpr size_t kDqSmem = 6 * size_t(kTileBytes) + size_t(kProbBytes);        // Q, dO, 2 x (K, V), dS

// Byte offset of 16-byte chunk c of row r in an operand tile (144-byte rows, see the header).
__device__ __forceinline__ uint32_t off(int r, int c) { return uint32_t(r * kRowBytes + c * 16); }
// The same in a P / dS tile: 128-byte rows, chunk c of row r stored at c ^ (r & 7).
__device__ __forceinline__ uint32_t swz_p(int r, int c) { return uint32_t(r * 128 + ((c ^ (r & 7)) << 4)); }

// Rows [0, valid) of a 64 x 72 bf16 tile at src into the tile at dst; the other rows become zeros.
template <int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int valid) {
  for (int i = threadIdx.x; i < kTile * kChunks; i += NT) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r < valid;
    cp_async16(dst + off(r, c), ok ? src + size_t(r) * kHD + c * 8 : src, ok ? 16 : 0);
  }
}

// A fragments of 16 rows x 72 columns of an operand tile: four k16 steps and the k8 step of columns 64-71.
struct AFrag {
  uint32_t k16[4][4];
  uint32_t k8[2];
};

__device__ __forceinline__ void load_a(AFrag& f, uint32_t tile, int row0, int lane) {
  const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(f.k16[kk], tile + off(r, 2 * kk + (lane >> 4)));
  ldmatrix_x2(f.k8, tile + off(r, 8));
}

// c = A B^T over the 72 columns: A's 16 rows against NT x 8 rows of the tile from key0 (NT a multiple of 4).
template <int NT>
__device__ __forceinline__ void gemm_abt(float (&c)[NT][4], const AFrag& a, uint32_t tile, int key0, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) {
      uint32_t b[4];
      ldmatrix_x4(b, tile + off(key0 + 16 * nj + (lane & 7) + (lane >> 4) * 8, 2 * kk + ((lane >> 3) & 1)));
      mma_bf16(c[2 * nj], a.k16[kk], b[0], b[1]);
      mma_bf16(c[2 * nj + 1], a.k16[kk], b[2], b[3]);
    }
  }
#pragma unroll
  for (int nq = 0; nq < NT / 4; ++nq) {  // columns 64-71 of four 8-row tiles at once
    uint32_t b[4];
    ldmatrix_x4(b, tile + off(key0 + 32 * nq + lane, 8));
#pragma unroll
    for (int i = 0; i < 4; ++i) mma_bf16_k8(c[4 * nq + i], a.k8, b[i]);
  }
}

// acc[j] += A · B for the n8 tiles n0 + j, j < count (count <= NN, warp-uniform): A is 16 x 32 as two k16
// fragments, B rows [k0, k0 + 32) of an operand tile (rows = the contraction), read by `ldmatrix.trans`.
template <int NN>
__device__ __forceinline__ void gemm_ab32(float (&acc)[NN][4], const uint32_t (&a0)[4], const uint32_t (&a1)[4],
                                          uint32_t tile, int k0, int n0, int count, int lane) {
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    if (j < count) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + off(k0 + lane, n0 + j));
      mma_bf16(acc[j], a0, b[0], b[1]);
      mma_bf16(acc[j], a1, b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Kernels and entries are templates on the head dim (72 only) so that a source instantiates what it launches.
template <int HD>
__global__ void __launch_bounds__(kFwdThreads, 4)
    mhsa_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, bf16* __restrict__ out,
             float* __restrict__ lse, int t_len, int s_len) {
  static_assert(HD == kHD, "head_dim 72 only");
  extern __shared__ __align__(128) uint8_t mhsa_smem[];
  const uint32_t q_s = smem_u32(mhsa_smem), kv_s = q_s + kTileBytes;  // then K_0, V_0, K_1, V_1

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.y, row0 = blockIdx.x * kTile, wrow = 16 * warp;
  const int n_tiles = (s_len + kTile - 1) / kTile;
  const bf16* kb = k + size_t(bh) * s_len * kHD;
  const bf16* vb = v + size_t(bh) * s_len * kHD;

  load_tile<kFwdThreads>(q_s, q + (size_t(bh) * t_len + row0) * kHD, t_len - row0);
  load_tile<kFwdThreads>(kv_s, kb, min(kTile, s_len));
  load_tile<kFwdThreads>(kv_s + kTileBytes, vb, min(kTile, s_len));
  cp_async_commit();

  float o[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int s0 = j * kTile, n_keys = min(kTile, s_len - s0);
    const uint32_t k_s = kv_s + (j & 1) * 2 * kTileBytes, v_s = k_s + kTileBytes;
    cp_async_wait_all();
    __syncthreads();  // tile j (and Q) is in; every warp is done with tile j-1, whose buffers take tile j+1
    if (j + 1 < n_tiles) {
      const uint32_t next = kv_s + ((j + 1) & 1) * 2 * kTileBytes;
      const int n_next = min(kTile, s_len - s0 - kTile);
      load_tile<kFwdThreads>(next, kb + size_t(s0 + kTile) * kHD, n_next);
      load_tile<kFwdThreads>(next + kTileBytes, vb + size_t(s0 + kTile) * kHD, n_next);
      cp_async_commit();
    }
    AFrag qa;  // reloaded every tile: held across the loop they would not fit 128 registers
    load_a(qa, q_s, wrow, lane);

    // S = Q K^T: 16 rows x 64 keys a warp, 8 accumulator tiles of 8 keys.
    float s[8][4];
    gemm_abt<8>(s, qa, k_s, 0, lane);

    // Online softmax over the row's 64 keys: the quad of lanes 4g..4g+3 holds row g (and g + 8).
    // exp(x - m) = 2^(x log2(e) - m log2(e)): one FMA and one ex2 a weight.
    if (n_keys < kTile) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * n + 2 * c4 + (e & 1) >= n_keys) s[n][e] = -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);  // finite: every tile holds a real key
      const float ml = m_new * kLog2e;
      alpha[h] = ex2_approx(fmaf(m_run[h], kLog2e, -ml));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = ex2_approx(fmaf(s[n][2 * h + e], kLog2e, -ml));
          s[n][2 * h + e] = pv;
          sum += pv;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[h] = l_run[h] * alpha[h] + sum;
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: the S accumulators of keys 16kk..16kk+15 are P's A fragment; V by ldmatrix.trans.
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int kk = 2 * pp;
      const uint32_t a0[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t a1[4] = {pack_bf16(s[2 * kk + 2][0], s[2 * kk + 2][1]),
                              pack_bf16(s[2 * kk + 2][2], s[2 * kk + 2][3]),
                              pack_bf16(s[2 * kk + 3][0], s[2 * kk + 3][1]),
                              pack_bf16(s[2 * kk + 3][2], s[2 * kk + 3][3])};
      gemm_ab32<kNTiles>(o, a0, a1, v_s, 32 * pp, 0, kNTiles, lane);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wrow + g + 8 * h;
    if (r >= t_len) continue;
    const size_t grow = size_t(bh) * t_len + r;
    const float l = l_run[h];
    bf16* dst = out + grow * kHD + 2 * c4;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(o[n][2 * h] / l, o[n][2 * h + 1] / l);
    if (c4 == 0) lse[grow] = m_run[h] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// S = Q K^T and dP = dO V^T of one warp's 16 rows (from wrow) x 32 keys (from wkey) of a tile pair.
__device__ __forceinline__ void scores(float (&s)[4][4], float (&dp)[4][4], uint32_t q_s, uint32_t do_s, uint32_t k_s,
                                       uint32_t v_s, int wrow, int wkey, int lane) {
  AFrag a;
  load_a(a, q_s, wrow, lane);
  gemm_abt<4>(s, a, k_s, wkey, lane);
  load_a(a, do_s, wrow, lane);
  gemm_abt<4>(dp, a, v_s, wkey, lane);
}

// lse and delta of this thread's two rows (rows past the end: ok = false).
struct RowStats {
  float lse2[2], delta[2];  // lse2 = lse log2(e)
  bool ok[2];
};

__device__ __forceinline__ RowStats row_stats(const BwdParams<bf16>& p, int bh, int row0, int wrow, int g) {
  RowStats st;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wrow + g + 8 * h;
    st.ok[h] = r < p.t_len;
    st.lse2[h] = st.ok[h] ? p.lse[size_t(bh) * p.t_len + r] * kLog2e : 0.f;
    st.delta[h] = st.ok[h] ? p.delta[size_t(bh) * p.t_len + r] : 0.f;
  }
  return st;
}

// P = exp(s - lse) = 2^(s log2(e) - lse log2(e)) and dS = P (dP - delta), rounded to bf16, into the P / dS
// tiles (p_s may be null).
// Keys [0, n_keys) of the tile are real; the others, and rows past the end, get zeros.
__device__ __forceinline__ void probs(const float (&s)[4][4], const float (&dp)[4][4], const RowStats& st, int n_keys,
                                      uint8_t* p_s, uint8_t* ds_s, int wrow, int wkey, int g, int c4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + g + 8 * h;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int key = wkey + 8 * n + 2 * c4;
      float pv[2], dsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pv[e] = dsv[e] = 0.f;
        if (st.ok[h] && key + e < n_keys) {
          pv[e] = ex2_approx(fmaf(s[n][2 * h + e], kLog2e, -st.lse2[h]));
          dsv[e] = pv[e] * (dp[n][2 * h + e] - st.delta[h]);
        }
      }
      const uint32_t o = swz_p(row, key >> 3) + (key & 7) * 2;
      if (p_s != nullptr) *reinterpret_cast<uint32_t*>(p_s + o) = pack_bf16(pv[0], pv[1]);
      *reinterpret_cast<uint32_t*>(ds_s + o) = pack_bf16(dsv[0], dsv[1]);
    }
  }
}

// dK and dV of 64 keys of one (image, head) over all its query rows.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 2) mhsa_bwd_dkdv(BwdParams<bf16> p) {
  static_assert(HD == kHD, "head_dim 72 only");
  extern __shared__ __align__(128) uint8_t mhsa_smem[];
  const uint32_t k_s = smem_u32(mhsa_smem), v_s = k_s + kTileBytes;
  const uint32_t q_s0 = v_s + kTileBytes;        // two Q tiles
  const uint32_t do_s0 = q_s0 + 2 * kTileBytes;  // two dO tiles
  uint8_t* p_s = mhsa_smem + 6 * kTileBytes;
  uint8_t* ds_s = p_s + kProbBytes;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.y, s0 = blockIdx.x * kTile, n_keys = min(kTile, p.s_len - s0);
  const int n_row_tiles = (p.t_len + kTile - 1) / kTile;
  const int wrow = 16 * (warp & 3), wkey = 32 * (warp >> 2);  // scores: 16 rows x 32 keys
  const int dkey = 16 * (warp & 3);                            // products: 16 keys x 72 columns
  const bool is_dk = warp >= 4;                                // warps 0-3: dV, warps 4-7: dK
  const bf16* qb = p.q + size_t(bh) * p.t_len * kHD;
  const bf16* dob = p.dout + size_t(bh) * p.t_len * kHD;

  load_tile<kBwdThreads>(k_s, p.k + (size_t(bh) * p.s_len + s0) * kHD, n_keys);
  load_tile<kBwdThreads>(v_s, p.v + (size_t(bh) * p.s_len + s0) * kHD, n_keys);
  load_tile<kBwdThreads>(q_s0, qb, p.t_len);
  load_tile<kBwdThreads>(do_s0, dob, p.t_len);
  cp_async_commit();

  float acc[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_row_tiles; ++it) {
    const int row0 = it * kTile, buf = it & 1;
    const uint32_t q_s = q_s0 + buf * kTileBytes, do_s = do_s0 + buf * kTileBytes;
    cp_async_wait_all();
    __syncthreads();  // row tile `it` is in; every warp is done with tile it-1 (its buffers, P and dS)
    if (it + 1 < n_row_tiles) {
      const int rest = p.t_len - row0 - kTile;
      load_tile<kBwdThreads>(q_s0 + (buf ^ 1) * kTileBytes, qb + size_t(row0 + kTile) * kHD, rest);
      load_tile<kBwdThreads>(do_s0 + (buf ^ 1) * kTileBytes, dob + size_t(row0 + kTile) * kHD, rest);
      cp_async_commit();
    }
    const RowStats st = row_stats(p, bh, row0, wrow, g);
    float s[4][4], dp[4][4];
    scores(s, dp, q_s, do_s, k_s, v_s, wrow, wkey, lane);
    probs(s, dp, st, n_keys, p_s, ds_s, wrow, wkey, g, c4);
    __syncthreads();  // P and dS are in

    // dV += P^T dO (warps 0-3), dK += dS^T Q (warps 4-7) over the tile's 64 rows; P^T and dS^T by ldmatrix.trans.
    const uint32_t a_tile = smem_u32(is_dk ? ds_s : p_s), b_tile = is_dk ? q_s : do_s;
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      uint32_t a0[4], a1[4];
      const int r = 32 * pp + (lane & 7) + (lane >> 4) * 8, c = (dkey >> 3) + ((lane >> 3) & 1);
      ldmatrix_x4_trans(a0, a_tile + swz_p(r, c));
      ldmatrix_x4_trans(a1, a_tile + swz_p(r + 16, c));
      gemm_ab32<kNTiles>(acc, a0, a1, b_tile, 32 * pp, 0, kNTiles, lane);
    }
  }

  bf16* dst_base = is_dk ? p.dk : p.dv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = s0 + dkey + g + 8 * h;
    if (key >= p.s_len) continue;
    bf16* dst = dst_base + (size_t(bh) * p.s_len + key) * kHD + 2 * c4;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// dQ of 64 query rows of one (image, head) over all its keys.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 2) mhsa_bwd_dq(BwdParams<bf16> p) {
  static_assert(HD == kHD, "head_dim 72 only");
  constexpr int kLoTiles = 5;  // warps 0-3: n8 tiles 0-4 (columns 0-39); warps 4-7: tiles 5-8
  extern __shared__ __align__(128) uint8_t mhsa_smem[];
  const uint32_t q_s = smem_u32(mhsa_smem), do_s = q_s + kTileBytes;
  const uint32_t k_s0 = do_s + kTileBytes;      // two K tiles
  const uint32_t v_s0 = k_s0 + 2 * kTileBytes;  // two V tiles
  uint8_t* ds_s = mhsa_smem + 6 * kTileBytes;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.y, row0 = blockIdx.x * kTile;
  const int n_key_tiles = (p.s_len + kTile - 1) / kTile;
  const int wrow = 16 * (warp & 3), wkey = 32 * (warp >> 2);  // scores: 16 rows x 32 keys
  const int n0 = warp < 4 ? 0 : kLoTiles, n_cnt = warp < 4 ? kLoTiles : kNTiles - kLoTiles;
  const bf16* kb = p.k + size_t(bh) * p.s_len * kHD;
  const bf16* vb = p.v + size_t(bh) * p.s_len * kHD;

  load_tile<kBwdThreads>(q_s, p.q + (size_t(bh) * p.t_len + row0) * kHD, p.t_len - row0);
  load_tile<kBwdThreads>(do_s, p.dout + (size_t(bh) * p.t_len + row0) * kHD, p.t_len - row0);
  load_tile<kBwdThreads>(k_s0, kb, min(kTile, p.s_len));
  load_tile<kBwdThreads>(v_s0, vb, min(kTile, p.s_len));
  cp_async_commit();
  const RowStats st = row_stats(p, bh, row0, wrow, g);

  float acc[kLoTiles][4];
#pragma unroll
  for (int n = 0; n < kLoTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_key_tiles; ++j) {
    const int s0 = j * kTile, n_keys = min(kTile, p.s_len - s0), buf = j & 1;
    const uint32_t k_s = k_s0 + buf * kTileBytes, v_s = v_s0 + buf * kTileBytes;
    cp_async_wait_all();
    __syncthreads();  // key tile j is in; every warp is done with tile j-1 (its buffers and dS)
    if (j + 1 < n_key_tiles) {
      const int next = min(kTile, p.s_len - s0 - kTile);
      load_tile<kBwdThreads>(k_s0 + (buf ^ 1) * kTileBytes, kb + size_t(s0 + kTile) * kHD, next);
      load_tile<kBwdThreads>(v_s0 + (buf ^ 1) * kTileBytes, vb + size_t(s0 + kTile) * kHD, next);
      cp_async_commit();
    }
    float s[4][4], dp[4][4];
    scores(s, dp, q_s, do_s, k_s, v_s, wrow, wkey, lane);
    probs(s, dp, st, n_keys, nullptr, ds_s, wrow, wkey, g, c4);
    __syncthreads();  // dS is in

    // dQ += dS K: dS's A fragments straight from its tile, K as the B operand by ldmatrix.trans.
    const uint32_t dss = smem_u32(ds_s);
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      uint32_t a0[4], a1[4];
      const int r = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(a0, dss + swz_p(r, 4 * pp + (lane >> 4)));
      ldmatrix_x4(a1, dss + swz_p(r, 4 * pp + 2 + (lane >> 4)));
      gemm_ab32<kLoTiles>(acc, a0, a1, k_s, 32 * pp, n0, n_cnt, lane);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wrow + g + 8 * h;
    if (r >= p.t_len) continue;
    bf16* dst = p.dq + (size_t(bh) * p.t_len + r) * kHD + 8 * n0 + 2 * c4;
#pragma unroll
    for (int n = 0; n < kLoTiles; ++n)
      if (n < n_cnt)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// C entry points' bodies
// ---------------------------------------------------------------------------

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <int HD>
int fwd_entry(const void* q, const void* k, const void* v, void* out, void* lse, int batch_heads, int t_len,
              int s_len, void* stream) {
  if (batch_heads <= 0 || batch_heads > 65535 || t_len <= 0 || s_len <= 0 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(out))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(mhsa_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kFwdSmem));
  if (err != cudaSuccess) return int(err);
  mhsa_fwd<HD><<<dim3((t_len + kTile - 1) / kTile, batch_heads), kFwdThreads, kFwdSmem,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                                      static_cast<const bf16*>(v), static_cast<bf16*>(out),
                                                      static_cast<float*>(lse), t_len, s_len);
  return int(cudaGetLastError());
}

template <int HD>
int bwd_entry(const void* q, const void* k, const void* v, const void* out, const void* dout, const void* lse,
              void* delta, void* dq, void* dk, void* dv, int batch_heads, int t_len, int s_len, void* stream) {
  if (batch_heads <= 0 || batch_heads > 65535 || t_len <= 0 || s_len <= 0 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total_rows = batch_heads * t_len;
  const BwdParams<bf16> p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                          nullptr, static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
                          static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf16*>(dq),
                          static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_len, s_len, 1};
  // delta = rowsum(dO * O), by the scalar kernels' delta pass
  constexpr int kWarps = kThreads / 32;
  flash_bwd_delta<bf16, kHD><<<(total_rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(p, total_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(mhsa_bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kDkdvSmem));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(mhsa_bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kDqSmem));
  if (err != cudaSuccess) return int(err);
  mhsa_bwd_dkdv<HD><<<dim3((s_len + kTile - 1) / kTile, batch_heads), kBwdThreads, kDkdvSmem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  mhsa_bwd_dq<HD><<<dim3((t_len + kTile - 1) / kTile, batch_heads), kBwdThreads, kDqSmem, st>>>(p);
  return int(cudaGetLastError());
}

}  // namespace mhsa_mma
}  // namespace kai0
