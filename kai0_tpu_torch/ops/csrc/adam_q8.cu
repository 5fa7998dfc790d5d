// K3: the fused 8-bit blockwise AdamW step of one parameter tensor.
//
// Replaces kai0_tpu/ops/pallas_q8.py `_kernel` / `_pallas_blocks` (reached from
// `adam_q8_leaf`): per 2048-element block, decode both log-grid moments, run the
// f32 Adam recurrence, write the update a·m/(sqrt(v)+b) in the gradient's type,
// take the block absmax of the new moments and re-encode them with stochastic
// rounding in the log-index domain. Codec (kai0_tpu/training/optimizer.py
// `_q8_encode` / `_q8_decode`): mu signed int8, 127 levels; nu uint8, 255
// levels; 7 decades below the block absmax; code 0 is exact zero.
//
// What bounds it on the H100: it is elementwise plus one reduction per block,
// ~8.4 bytes per parameter (bf16 g read, int8 mu and nu read and written, bf16
// update written, scales), 28 GB for the 3.353 B parameters of π₀.₅, >= 8.4 ms
// per step at 3.35 TB/s; a few dozen f32 operations per element are far below
// the compute roof. So it is bytes-bound, and the design reads and writes each
// byte once:
//   * one CUDA block per 2048-element block row, 256 threads x 8 elements,
//     element e*256 + t of the block for thread t, so each of the 8 loads of a
//     warp is contiguous; the moments are updated in place;
//   * decode, recurrence, update, absmax (warp shuffles, then 8 warps through
//     shared memory) and encode stay in registers: no f32 moment touches memory;
//   * the tail block of a tensor that is not a multiple of 2048 is masked, not
//     padded in memory (its missing elements count as zeros, as the padding of
//     the TPU path makes them).
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

struct Q8Args {
  long long n;           // elements of the tensor
  float b1, one_minus_b1, b2, one_minus_b2;
  float a, b;            // sqrt(c2)/c1 and eps*sqrt(c2), the folded bias correction
  float step_s, step_u;  // f32(7·ln10/127), f32(7·ln10/255)
  uint32_t seed;
  int deterministic;
};

template <typename G>
__global__ void __launch_bounds__(kThreads)
adam_q8_kernel(const G* __restrict__ g, int8_t* mq, float* ms, uint8_t* vq, float* vs, G* __restrict__ out,
               Q8Args args) {
  __shared__ float red[2][kThreads / 32];
  const int t = threadIdx.x;
  const long long blk = blockIdx.x;
  const long long base = blk * kBlock;
  const float m_scale = ms[blk], v_scale = vs[blk];

  float m[kPer], v[kPer], m_abs = 0.f, v_abs = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const long long i = base + e * kThreads + t;
    const bool in = i < args.n;
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
  if (args.deterministic) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) um[e] = uv[e] = 0.5f;
  } else {
    const uint32_t counter = uint32_t(blk * kThreads + t);
    const uint2 key = make_uint2(args.seed, 0u);
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
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const long long i = base + e * kThreads + t;
    if (i >= args.n) continue;
    const float cm = encode(m[e], m_safe, kLevelsS, args.step_s, um[e]);
    mq[i] = int8_t(m[e] < 0.f ? -int(cm) : int(cm));
    vq[i] = uint8_t(int(encode(v[e], v_safe, kLevelsU, args.step_u, uv[e])));
  }
}

}  // namespace

extern "C" int kai0_adam_q8(const void* g, void* mq, void* ms, void* vq, void* vs, void* out, long long n, float b1,
                            float one_minus_b1, float b2, float one_minus_b2, float a, float b, float step_s,
                            float step_u, unsigned int seed, int deterministic, int is_bf16, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const long long blocks = (n + kBlock - 1) / kBlock;
  if (blocks * kThreads > 0xFFFFFFFFll || blocks > 0x7FFFFFFFll) return int(cudaErrorInvalidValue);
  const Q8Args args{n, b1, one_minus_b1, b2, one_minus_b2, a, b, step_s, step_u, seed, deterministic};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* mqp = static_cast<int8_t*>(mq);
  uint8_t* vqp = static_cast<uint8_t*>(vq);
  float* msp = static_cast<float*>(ms);
  float* vsp = static_cast<float*>(vs);
  if (is_bf16) {
    using G = __nv_bfloat16;
    adam_q8_kernel<G><<<unsigned(blocks), kThreads, 0, st>>>(static_cast<const G*>(g), mqp, msp, vqp, vsp,
                                                             static_cast<G*>(out), args);
  } else {
    adam_q8_kernel<float><<<unsigned(blocks), kThreads, 0, st>>>(static_cast<const float*>(g), mqp, msp, vqp, vsp,
                                                                 static_cast<float*>(out), args);
  }
  return int(cudaGetLastError());
}
