// K3: the fused 8-bit blockwise AdamW step, over every parameter tensor of a
// step in one launch (`adam_q8_leaves_kernel`, the optimizer's path) or over one
// tensor (`adam_q8_kernel`, the first form, kept as the reference for its bits).
//
// Replaces kai0_tpu/ops/pallas_q8.py `_kernel` / `_pallas_blocks` (reached from
// `adam_q8_leaf`): per 2048-element block, decode both log-grid moments, run the
// f32 Adam recurrence, write the update a·m/(sqrt(v)+b) in the gradient's type,
// take the block absmax of the new moments and re-encode them with stochastic
// rounding in the log-index domain. Codec (kai0_tpu/training/optimizer.py
// `_q8_encode` / `_q8_decode`): mu signed int8, 127 levels; nu uint8, 255
// levels; 7 decades below the block absmax; code 0 is exact zero.
//
// What bounds it on the H100: not the bytes. It moves ~8 bytes a parameter
// (bf16 g read, int8 mu and nu read and written, bf16 update written, scales),
// 26.9 GB for the 3.353 B parameters of π₀.₅, 8.0 ms a step at 3.35 TB/s; but
// the exact arithmetic takes on the order of 200 instructions an element: five IEEE divides,
// an IEEE square root, two accurate logf, and a quarter of four
// Philox-4x32-10 draws. So instruction issue bounds it (measured in PERF.md:
// several times the bytes bound, and the deterministic mode, with no draws, a
// tenth faster). The design keeps every operation and removes what is not
// arithmetic:
//   * one launch over all tensors: a device table of the tensors (pointers, n,
//     seed, dtype, first block); a persistent grid of four 256-thread blocks
//     an SM walks over the 2048-element blocks of all tensors, each finding its
//     tensor by bisecting the table (811 launches a step before);
//   * the next block's codes and gradient are copied into shared memory by
//     16-byte `cp.async` while this one is computed (double buffer), and the
//     results go out by 16-byte stores; thread t keeps elements e*256 + t, so
//     its draws are the per-tensor kernel's;
//   * the decode's exp of each code comes from a 384-entry table made once a
//     block with the same expf (the same bits, no exp an element);
//   * both block maxima through one barrier; moments updated in place; a
//     tensor's tail block is masked (its missing elements count as zeros, as
//     the padding of the TPU path makes them).
// Written in CUDA rather than Triton so that it builds into the same
// nvcc-compiled library as the attention kernels, with one build path and no
// Triton cache to manage.
//
// Numerics: every operation is IEEE round-to-nearest in the order of the plain
// version (`adam_q8.adam_q8_leaf_plain`): products and sums go through
// __fmul_rn/__fadd_rn so that nvcc cannot contract them into FMAs, the divide
// and square root are the IEEE ones, and exp/log are the accurate expf/logf
// (no --use_fast_math, no __expf/__logf: an approximate log moves codes across
// the grid). The stochastic rounding draws u in [0, 1) with 24 bits from
// Philox-4x32-10 keyed by (seed, 0) with counter (block*256 + thread, e/4,
// moment, 0); `deterministic` sets u = 0.5, as the TPU kernel's test mode does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kBlock = 2048;
constexpr int kThreads = 256;
constexpr int kPer = kBlock / kThreads;  // 8 elements per thread
constexpr float kLevelsS = 127.f;
constexpr float kLevelsU = 255.f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u, kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kW0;
    k.y += kW1;
  }
  return c;
}

__device__ __forceinline__ float uniform24(uint32_t bits) { return float(bits >> 8) * (1.f / 16777216.f); }

// s * exp((|q| - levels) * step), signed for mu; code 0 is exact zero.
__device__ __forceinline__ float decode(float qf, float scale, float levels, float step) {
  if (qf == 0.f) return 0.f;
  const float mag = __fmul_rn(expf(__fmul_rn(__fadd_rn(fabsf(qf), -levels), step)), scale);
  return qf < 0.f ? -mag : mag;
}

// The log-grid code of |x| (0 for x = 0): floor(log(max(|x|/scale, 1e-38))/step + levels + u), clipped.
__device__ __forceinline__ float encode(float x, float safe_scale, float levels, float step, float u) {
  const float absx = fabsf(x);
  if (!(absx > 0.f)) return 0.f;
  const float lg = logf(fmaxf(__fdiv_rn(absx, safe_scale), 1e-38f));
  const float idx = floorf(__fadd_rn(__fadd_rn(__fdiv_rn(lg, step), levels), u));
  return fminf(fmaxf(idx, 0.f), levels);
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// The step's scalars, shared by every tensor of a step.
struct Q8Args {
  float b1, one_minus_b1, b2, one_minus_b2;
  float a, b;            // sqrt(c2)/c1 and eps*sqrt(c2), the folded bias correction
  float step_s, step_u;  // f32(7·ln10/127), f32(7·ln10/255)
  int deterministic;
};

// The rounding draws of thread t's elements e·256 + t of block `blk` (block-local index within its tensor):
// Philox-4x32-10 keyed by (seed, 0), counter (blk·256 + t, e / 4, moment, 0), lane e % 4; 0.5 when deterministic.
__device__ __forceinline__ void draws(long long blk, int t, uint32_t seed, int deterministic, float (&um)[kPer],
                                      float (&uv)[kPer]) {
  if (deterministic) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) um[e] = uv[e] = 0.5f;
    return;
  }
  const uint32_t counter = uint32_t(blk * kThreads + t);
  const uint2 key = make_uint2(seed, 0u);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 rm = philox4x32_10(make_uint4(counter, h, 0u, 0u), key);
    const uint4 rv = philox4x32_10(make_uint4(counter, h, 1u, 0u), key);
    um[4 * h + 0] = uniform24(rm.x); um[4 * h + 1] = uniform24(rm.y);
    um[4 * h + 2] = uniform24(rm.z); um[4 * h + 3] = uniform24(rm.w);
    uv[4 * h + 0] = uniform24(rv.x); uv[4 * h + 1] = uniform24(rv.y);
    uv[4 * h + 2] = uniform24(rv.z); uv[4 * h + 3] = uniform24(rv.w);
  }
}

// One tensor of n elements (the first version of K3, one launch a tensor; the reference for the bits of
// `adam_q8_leaves_kernel`).
template <typename G>
__global__ void __launch_bounds__(kThreads)
adam_q8_kernel(const G* __restrict__ g, int8_t* mq, float* ms, uint8_t* vq, float* vs, G* __restrict__ out,
               long long n, uint32_t seed, Q8Args args) {
  __shared__ float red[2][kThreads / 32];
  const int t = threadIdx.x;
  const long long blk = blockIdx.x;
  const long long base = blk * kBlock;
  const float m_scale = ms[blk], v_scale = vs[blk];

  float m[kPer], v[kPer], m_abs = 0.f, v_abs = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const long long i = base + e * kThreads + t;
    const bool in = i < n;
    const float gf = in ? to_f32(g[i]) : 0.f;
    const float dm = decode(in ? float(mq[i]) : 0.f, m_scale, kLevelsS, args.step_s);
    const float dv = decode(in ? float(vq[i]) : 0.f, v_scale, kLevelsU, args.step_u);
    m[e] = __fadd_rn(__fmul_rn(args.b1, dm), __fmul_rn(args.one_minus_b1, gf));
    v[e] = __fadd_rn(__fmul_rn(args.b2, dv), __fmul_rn(args.one_minus_b2, __fmul_rn(gf, gf)));
    if (in) store(out + i, __fdiv_rn(__fmul_rn(args.a, m[e]), __fadd_rn(__fsqrt_rn(v[e]), args.b)));
    m_abs = fmaxf(m_abs, fabsf(m[e]));
    v_abs = fmaxf(v_abs, fabsf(v[e]));
  }
  // Every thread has read ms[blk]/vs[blk] before the barrier inside block_max.
  const float m_new = block_max(m_abs, red[0]);
  const float v_new = block_max(v_abs, red[1]);
  if (t == 0) {
    ms[blk] = m_new;
    vs[blk] = v_new;
  }
  const float m_safe = m_new > 0.f ? m_new : 1.f, v_safe = v_new > 0.f ? v_new : 1.f;

  float um[kPer], uv[kPer];
  draws(blk, t, seed, args.deterministic, um, uv);
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const long long i = base + e * kThreads + t;
    if (i >= n) continue;
    const float cm = encode(m[e], m_safe, kLevelsS, args.step_s, um[e]);
    mq[i] = int8_t(m[e] < 0.f ? -int(cm) : int(cm));
    vq[i] = uint8_t(int(encode(v[e], v_safe, kLevelsU, args.step_u, uv[e])));
  }
}

// ---------------------------------------------------------------------------
// Every tensor of a step in one launch
// ---------------------------------------------------------------------------

// A row of the table of tensors that ops/adam_q8.py builds (10 int64 words a tensor).
struct Q8Leaf {
  long long g, mq, ms, vq, vs, out;  // addresses; out may be g (each block is staged before it is written)
  long long n;                       // elements
  long long first_block;             // the tensor's first block among the blocks of all tensors
  long long seed;                    // its rounding seed, a 32-bit value
  long long is_bf16;                 // g and out are bf16, else f32
};
static_assert(sizeof(Q8Leaf) == 80, "the table's rows are 10 int64 words");

__device__ __forceinline__ float load_g(const uint8_t* p, int i, bool bf16) {
  return bf16 ? to_f32(reinterpret_cast<const __nv_bfloat16*>(p)[i]) : reinterpret_cast<const float*>(p)[i];
}

// Element i of a tensor's gradient (or update) copied between two buffers of its type.
__device__ __forceinline__ void copy_g(uint8_t* dst, const uint8_t* src, int i, bool bf16) {
  if (bf16) {
    reinterpret_cast<uint16_t*>(dst)[i] = reinterpret_cast<const uint16_t*>(src)[i];
  } else {
    reinterpret_cast<uint32_t*>(dst)[i] = reinterpret_cast<const uint32_t*>(src)[i];
  }
}

// A block of the step: its tensor's row of the table, its index within the tensor, its elements, whether it
// moves in 16-byte pieces, and its scales (read ahead).
struct BlockRef {
  const Q8Leaf* leaf;
  long long blk;
  int count;
  bool vec, bf16;
  float m_scale, v_scale;
};

__device__ __forceinline__ BlockRef locate(const Q8Leaf* table, int leaves, int gb) {
  int lo = 0, hi = leaves - 1;  // the last tensor whose first block is at or before gb
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].first_block <= gb) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  BlockRef r;
  r.leaf = table + lo;
  r.blk = gb - r.leaf->first_block;
  r.count = int(min(static_cast<long long>(kBlock), r.leaf->n - r.blk * kBlock));
  r.bf16 = r.leaf->is_bf16 != 0;
  r.vec = r.count == kBlock && ((r.leaf->g | r.leaf->out | r.leaf->mq | r.leaf->vq) & 15) == 0;
  r.m_scale = reinterpret_cast<const float*>(r.leaf->ms)[r.blk];
  r.v_scale = reinterpret_cast<const float*>(r.leaf->vs)[r.blk];
  return r;
}

struct Stage {  // one block in shared memory
  uint8_t g[kBlock * 4];  // its gradient, then its update
  int8_t mq[kBlock];
  uint8_t vq[kBlock];
};

// The block's 16-byte pieces into `s` by `cp.async` (a block that moves byte by byte is read when it is used).
__device__ __forceinline__ void stage_in_async(const BlockRef& r, Stage& s, int t) {
  if (!r.vec) return;
  const int width = r.bf16 ? 2 : 4;
  const uint8_t* g = reinterpret_cast<const uint8_t*>(r.leaf->g) + r.blk * kBlock * width;
  for (int c = t; c < kBlock * width / 16; c += kThreads) cp_async16(smem_u32(s.g + 16 * c), g + 16 * c, 16);
  if (t < kBlock / 16) {
    cp_async16(smem_u32(s.mq + 16 * t), reinterpret_cast<const int8_t*>(r.leaf->mq) + r.blk * kBlock + 16 * t, 16);
  } else {
    const int c = t - kBlock / 16;
    cp_async16(smem_u32(s.vq + 16 * c), reinterpret_cast<const uint8_t*>(r.leaf->vq) + r.blk * kBlock + 16 * c, 16);
  }
}

// Persistent: a grid of a few blocks per SM walks over the 2048-element blocks of all tensors (block gb of the
// step is block gb - first_block of the tensor whose range holds it, found by bisecting the table). A block is
// staged into shared memory with 16-byte `cp.async` copies issued while the block before is computed (byte by
// byte for a tensor's tail block, or where an address is not 16-byte aligned); thread t then runs the first
// kernel's arithmetic on its elements e·256 + t, with the same draws, and the new codes and the update go back
// out with 16-byte stores. The decode's exp of every code is read from a table computed once a block with the
// same expf: the same bits, no exp an element.
__global__ void __launch_bounds__(kThreads, 4)
adam_q8_leaves_kernel(const Q8Leaf* __restrict__ table, int leaves, int blocks, Q8Args args) {
  __shared__ float exp_s[128], exp_u[256];  // exp((j - levels) · step) for |code| j
  __shared__ __align__(16) Stage stages[2];
  __shared__ float red[2][kThreads / 32];
  const int t = threadIdx.x;
  for (int j = t; j < 128 + 256; j += kThreads) {
    if (j < 128) {
      exp_s[j] = expf(__fmul_rn(__fadd_rn(float(j), -kLevelsS), args.step_s));
    } else {
      exp_u[j - 128] = expf(__fmul_rn(__fadd_rn(float(j - 128), -kLevelsU), args.step_u));
    }
  }
  if (int(blockIdx.x) >= blocks) return;
  BlockRef cur = locate(table, leaves, blockIdx.x);
  stage_in_async(cur, stages[0], t);
  cp_async_commit();
  for (int gb = blockIdx.x, buf = 0; gb < blocks; gb += gridDim.x, buf ^= 1) {
    Stage& s = stages[buf];
    BlockRef next;
    const bool more = gb + int(gridDim.x) < blocks;
    if (more) {
      next = locate(table, leaves, gb + gridDim.x);
      stage_in_async(next, stages[buf ^ 1], t);
    }
    cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this block's copies have landed
    const Q8Leaf& leaf = *cur.leaf;
    const bool bf16 = cur.bf16;
    const int count = cur.count, width = bf16 ? 2 : 4;
    const long long base = cur.blk * kBlock;
    if (!cur.vec) {
      const uint8_t* g = reinterpret_cast<const uint8_t*>(leaf.g) + base * width;
      for (int i = t; i < count; i += kThreads) {
        copy_g(s.g, g, i, bf16);
        s.mq[i] = reinterpret_cast<const int8_t*>(leaf.mq)[base + i];
        s.vq[i] = reinterpret_cast<const uint8_t*>(leaf.vq)[base + i];
      }
    }
    __syncthreads();  // the block is staged (and, on the first pass, the exp tables are written)

    float m[kPer], v[kPer], m_abs = 0.f, v_abs = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = e * kThreads + t;
      const bool in = i < count;
      const float gf = in ? load_g(s.g, i, bf16) : 0.f;
      const int cm = in ? s.mq[i] : 0, cv = in ? s.vq[i] : 0;
      const float am = __fmul_rn(exp_s[abs(cm)], cur.m_scale);
      const float dm = cm == 0 ? 0.f : (cm < 0 ? -am : am);
      const float dv = cv == 0 ? 0.f : __fmul_rn(exp_u[cv], cur.v_scale);
      m[e] = __fadd_rn(__fmul_rn(args.b1, dm), __fmul_rn(args.one_minus_b1, gf));
      v[e] = __fadd_rn(__fmul_rn(args.b2, dv), __fmul_rn(args.one_minus_b2, __fmul_rn(gf, gf)));
      if (in) {
        const float upd = __fdiv_rn(__fmul_rn(args.a, m[e]), __fadd_rn(__fsqrt_rn(v[e]), args.b));
        if (bf16) {
          store(reinterpret_cast<__nv_bfloat16*>(s.g) + i, upd);
        } else {
          store(reinterpret_cast<float*>(s.g) + i, upd);
        }
      }
      m_abs = fmaxf(m_abs, fabsf(m[e]));
      v_abs = fmaxf(v_abs, fabsf(v[e]));
    }
    // Both block maxima through one barrier.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m_abs = fmaxf(m_abs, __shfl_xor_sync(0xffffffffu, m_abs, off));
      v_abs = fmaxf(v_abs, __shfl_xor_sync(0xffffffffu, v_abs, off));
    }
    if (t % 32 == 0) {
      red[0][t / 32] = m_abs;
      red[1][t / 32] = v_abs;
    }
    __syncthreads();
    float m_new = red[0][0], v_new = red[1][0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) {
      m_new = fmaxf(m_new, red[0][w]);
      v_new = fmaxf(v_new, red[1][w]);
    }
    if (t == 0) {
      reinterpret_cast<float*>(leaf.ms)[cur.blk] = m_new;
      reinterpret_cast<float*>(leaf.vs)[cur.blk] = v_new;
    }
    const float m_safe = m_new > 0.f ? m_new : 1.f, v_safe = v_new > 0.f ? v_new : 1.f;
    float um[kPer], uv[kPer];
    draws(cur.blk, t, uint32_t(leaf.seed), args.deterministic, um, uv);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = e * kThreads + t;
      if (i >= count) continue;
      const float cm = encode(m[e], m_safe, kLevelsS, args.step_s, um[e]);
      s.mq[i] = int8_t(m[e] < 0.f ? -int(cm) : int(cm));
      s.vq[i] = uint8_t(int(encode(v[e], v_safe, kLevelsU, args.step_u, uv[e])));
    }
    __syncthreads();  // the codes and the update are in shared memory

    uint8_t* out = reinterpret_cast<uint8_t*>(leaf.out) + base * width;
    int8_t* mq = reinterpret_cast<int8_t*>(leaf.mq) + base;
    uint8_t* vq = reinterpret_cast<uint8_t*>(leaf.vq) + base;
    if (cur.vec) {
      for (int c = t; c < kBlock * width / 16; c += kThreads)
        reinterpret_cast<uint4*>(out)[c] = reinterpret_cast<const uint4*>(s.g)[c];
      if (t < kBlock / 16) {
        reinterpret_cast<uint4*>(mq)[t] = reinterpret_cast<const uint4*>(s.mq)[t];
      } else {
        reinterpret_cast<uint4*>(vq)[t - kBlock / 16] = reinterpret_cast<const uint4*>(s.vq)[t - kBlock / 16];
      }
    } else {
      for (int i = t; i < count; i += kThreads) {
        copy_g(out, s.g, i, bf16);
        mq[i] = s.mq[i];
        vq[i] = s.vq[i];
      }
    }
    __syncthreads();  // this stage is free for the block after next
    cur = next;
  }
}

}  // namespace

extern "C" int kai0_adam_q8(const void* g, void* mq, void* ms, void* vq, void* vs, void* out, long long n, float b1,
                            float one_minus_b1, float b2, float one_minus_b2, float a, float b, float step_s,
                            float step_u, unsigned int seed, int deterministic, int is_bf16, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const long long blocks = (n + kBlock - 1) / kBlock;
  if (blocks * kThreads > 0xFFFFFFFFll || blocks > 0x7FFFFFFFll) return int(cudaErrorInvalidValue);
  const Q8Args args{b1, one_minus_b1, b2, one_minus_b2, a, b, step_s, step_u, deterministic};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* mqp = static_cast<int8_t*>(mq);
  uint8_t* vqp = static_cast<uint8_t*>(vq);
  float* msp = static_cast<float*>(ms);
  float* vsp = static_cast<float*>(vs);
  if (is_bf16) {
    using G = __nv_bfloat16;
    adam_q8_kernel<G><<<unsigned(blocks), kThreads, 0, st>>>(static_cast<const G*>(g), mqp, msp, vqp, vsp,
                                                             static_cast<G*>(out), n, seed, args);
  } else {
    adam_q8_kernel<float><<<unsigned(blocks), kThreads, 0, st>>>(static_cast<const float*>(g), mqp, msp, vqp, vsp,
                                                                 static_cast<float*>(out), n, seed, args);
  }
  return int(cudaGetLastError());
}

// Every tensor of a step in one launch: table int64 [leaves, 10] on the device (Q8Leaf rows, first_block the
// prefix sums of the tensors' block counts), blocks the sum of those counts.
extern "C" int kai0_adam_q8_leaves(const void* table, int leaves, int blocks, float b1, float one_minus_b1, float b2,
                                   float one_minus_b2, float a, float b, float step_s, float step_u, int deterministic,
                                   void* stream) {
  if (leaves <= 0 || blocks <= 0) return int(cudaErrorInvalidValue);
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_q8_leaves_kernel, kThreads, 0);
  if (err != cudaSuccess) return int(err);
  const Q8Args args{b1, one_minus_b1, b2, one_minus_b2, a, b, step_s, step_u, deterministic};
  const int grid = int(min(static_cast<long long>(blocks), static_cast<long long>(per_sm) * sm_count()));
  adam_q8_leaves_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Q8Leaf*>(table), leaves, blocks, args);
  return int(cudaGetLastError());
}
