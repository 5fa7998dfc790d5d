// K5: per-row symmetric int8 quantization of a 2-D activation in one launch.
//
// Replaces kai0_tpu/ops/pallas_rowquant.py `_kernel` / `row_quant`: for each
// row, amax = max|p|, s = max(amax, 1e-30) * (1/127) in f32, codes
// round_half_even(p / s) as int8; returns the codes [M, K] and the scales
// [M, 1]. p is the row itself, or, with a column scale c (f32 [K]), the f32
// product x * c: the straight-through backward quantizes the rows of dy * s
// (kai0_tpu/ops/quant.py `_bwd_dx`, `_qbwd_col`), which XLA fuses into the row
// quantization, so the product never reaches device memory; here it is formed
// in registers from dy as it is read.
//
// What bounds it on the H100: bytes. It reads x once (2 or 4 bytes an element;
// the column scale once a block) and writes one byte an element plus 4 bytes a
// row: 0.114 ms at 3.35 TB/s for a [7744, 16384] bf16 row chunk of Gemma-2B's
// FFN. A row's scale needs the whole row before any of its codes exist, so the
// row stays on chip from its one read until its codes are stored:
//   * `row_quant_regs_kernel<T, CS, TPR>` holds a row in registers: TPR threads
//     (one to sixteen warps; 512 at K = 16384, 64 at K = 2048) own a row, 32
//     elements a thread in 16-byte loads issued together before the amax is
//     reduced (warp shuffles, then one exchange through shared memory when the
//     row spans several warps). A persistent grid walks the rows, each thread
//     issuing the loads of its next row before it quantizes this one, so the
//     copy of one row overlaps the arithmetic of the last. With a column scale,
//     a thread keeps the 32 scales of its columns in registers for all its
//     rows: the scale vector is read once a block, not once a row. Each warp
//     stages its codes in shared memory and stores them as whole 16-byte
//     vectors. p is formed from the held loads twice, for the amax and for the
//     codes (57-123 registers, no spills).
//   * `row_quant_edge_kernel<T, CS>` (the two-sweep kernel that ran every
//     row before, made scalar) takes what the register kernel does not: K
//     not a multiple of 16, K above 16384, or a base that is not 16-byte
//     aligned. One block of 256 threads a row; a first sweep for the amax, a
//     second that re-reads the row (from L2 at best) and stores the codes a
//     byte at a time.
// Two things measured set the register kernel's launch. At most 512 threads an
// SM (one block at K = 16384, two of 256 threads below): with as many blocks as
// fit (2 at K = 16384 bf16) the same rows took 7-9% longer at [7744, 16384]
// and [30976, 2048] bf16, with no gain elsewhere. And the IEEE division leaves
// its fast path for a zero dividend or a tiny divisor, which a row of zeros
// and the padding past a short row's end bring: those take no division (code
// 0); dividing them cost a zero row's block about 3.5 us. Device time of one
// launch in a CUDA graph on an H100 80GB HBM3 at 700 W
// (`scripts/time_row_quant.py`): 0.135 ms at [7744, 16384] bf16 (84% of the
// bytes bound; the two-sweep kernel on every row took 0.172), 0.138 ms for
// that shape's dy * s (the cast, the multiply and the two-sweep kernel on the
// f32 product took 1.16), 0.069 ms at [30976, 2048] bf16 (83%), 0.211 ms at
// [7744, 16384] f32 (89%).
//
// Numerics: bit-equal to the plain version (`row_quant.row_quant_plain`). The
// max of absolute values is exact in any type, so taking it on the f32 images
// of bf16 values equals taking it in bf16 and casting. The product with the
// column scale is one IEEE multiply (`__fmul_rn`: nvcc may not contract it into
// an FMA), as torch's `x.float() * c`. The scale is the product with the f32
// constant 1/127, not a division: that is what the JAX package's `/ 127.0`
// compiles to under jit (XLA turns a division by a constant into a
// multiplication by its reciprocal), and a true division differs from it by one
// unit in the last place on some rows. The division p / s is IEEE (`__fdiv_rn`;
// no --use_fast_math, no reciprocal multiply) and the rounding is to nearest
// even, or codes would flip against `torch.round(p / s)`. The register kernel
// rounds by adding 1.5 * 2^23 (`__fadd_rn`): |p / s| <= 127.5, so the sum lies
// in [2^23, 2^24), where the float's unit is 1, the addition rounds half to
// even exactly as `__float2int_rn` does, and the low byte of the sum's bits is
// the two's-complement code. A row of zeros gives s = 1e-30 * (1/127) and
// codes 0. Non-finite inputs are not supported.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kEdgeThreads = 256;
constexpr int kThreadElems = 32;  // elements of a row a thread of the register kernel holds
constexpr int kMaxRowThreads = 512;
constexpr int kMaxRegsK = kThreadElems * kMaxRowThreads;  // 16384: wider rows take the edge kernel
constexpr float kRoundMagic = 12582912.0f;               // 1.5 * 2^23
constexpr int kResidentThreads = 512;  // threads of the register kernel an SM holds, at most (see the header)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Element i of a row as p: times its column scale, rounded once, with CS; itself without.
template <bool CS>
__device__ __forceinline__ float product(float x, const float* __restrict__ cs, int i) {
  if constexpr (CS) {
    return __fmul_rn(x, __ldg(cs + i));
  } else {
    return x;
  }
}

// The code of p as the low byte of a register: round_half_even(p / s) for |p / s| <= 127.5.
__device__ __forceinline__ uint32_t code_bits(float p, float s) {
  return __float_as_uint(__fadd_rn(__fdiv_rn(p, s), kRoundMagic));
}

__device__ __forceinline__ uint32_t pack_codes(float p0, float p1, float p2, float p3, float s) {
  const uint32_t lo = __byte_perm(code_bits(p0, s), code_bits(p1, s), 0x0040);
  const uint32_t hi = __byte_perm(code_bits(p2, s), code_bits(p3, s), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// The f32 images of the elements of one 16-byte load: 8 bf16 or 4 f32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* e);

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v, float* e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[2 * j] = __uint_as_float(w[j] << 16);
    e[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void unpack<float>(const uint4& v, float* e) {
  e[0] = __uint_as_float(v.x);
  e[1] = __uint_as_float(v.y);
  e[2] = __uint_as_float(v.z);
  e[3] = __uint_as_float(v.w);
}

// p of the elements of one 16-byte load: their f32 images, times their column scales c with CS.
template <typename T, bool CS>
__device__ __forceinline__ void products(const uint4& v, const float* c, float* p) {
  unpack<T>(v, p);
  if constexpr (CS) {
#pragma unroll
    for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j) p[j] = __fmul_rn(p[j], c[j]);
  }
}

template <typename T, int TPR>
struct RegsShape {
  static constexpr int kThreads = TPR > 256 ? TPR : 256;
  static constexpr int kRows = kThreads / TPR;           // rows a block holds at once
  static constexpr int kVec = 16 / sizeof(T);            // elements of one 16-byte load
  static constexpr int kLoads = kThreadElems / kVec;     // 16-byte loads of a row a thread makes
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRowWarps = TPR / 32;
  static constexpr int kSegment = 32 * kVec;             // codes of one load index over a warp, bytes
};

// Load v of thread t of a row covers elements [(v * TPR + t) * kVec, +kVec): the warp's loads are contiguous.
template <typename T, int TPR>
__device__ __forceinline__ void load_row(uint4 (&buf)[RegsShape<T, TPR>::kLoads], const T* __restrict__ x, int row,
                                         int m, int k, int t) {
  using S = RegsShape<T, TPR>;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * k);
  const int nvec = k / S::kVec;
#pragma unroll
  for (int v = 0; v < S::kLoads; ++v) {
    const int i = v * TPR + t;
    buf[v] = (row < m && i < nvec) ? __ldg(xr + i) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, bool CS, int TPR>
__global__ void __launch_bounds__(RegsShape<T, TPR>::kThreads)
row_quant_regs_kernel(const T* __restrict__ x, const float* __restrict__ cs, int8_t* __restrict__ xq,
                      float* __restrict__ sx, int m, int k) {
  using S = RegsShape<T, TPR>;
  constexpr int kVec = S::kVec, kLoads = S::kLoads;
  __shared__ float warp_max[2][S::kWarps];  // by parity of the row step: one barrier a step
  __shared__ __align__(16) uint8_t stage[S::kWarps][kThreadElems * 32];

  const int g = threadIdx.x / TPR, t = threadIdx.x % TPR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = k / kVec;

  float c[CS ? kThreadElems : 1];
  if constexpr (CS) {
#pragma unroll
    for (int v = 0; v < kLoads; ++v) {
      const int i = v * TPR + t;
#pragma unroll
      for (int h = 0; h < kVec / 4; ++h) {
        const float4 f = i < nvec ? __ldg(reinterpret_cast<const float4*>(cs) + i * (kVec / 4) + h)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        c[v * kVec + 4 * h] = f.x;
        c[v * kVec + 4 * h + 1] = f.y;
        c[v * kVec + 4 * h + 2] = f.z;
        c[v * kVec + 4 * h + 3] = f.w;
      }
    }
  }

  const int steps = (m + S::kRows - 1) / S::kRows;  // a step is kRows rows, one a row group
  const int stride = gridDim.x;
  uint4 next[kLoads];
  int step = blockIdx.x;
  load_row<T, TPR>(next, x, step * S::kRows + g, m, k, t);
  for (int parity = 0; step < steps; step += stride, parity ^= 1) {
    uint4 cur[kLoads];
#pragma unroll
    for (int v = 0; v < kLoads; ++v) cur[v] = next[v];
    if (step + stride < steps) load_row<T, TPR>(next, x, (step + stride) * S::kRows + g, m, k, t);
    const int row = step * S::kRows + g;

    // p is formed twice from the loads held, for the amax and for the codes: fewer registers than keeping it.
    float amax = 0.f;  // loads past the row's end (or past m) are zeros
#pragma unroll
    for (int v = 0; v < kLoads; ++v) {
      float p[kVec];
      products<T, CS>(cur[v], c + (CS ? v * kVec : 0), p);
#pragma unroll
      for (int j = 0; j < kVec; ++j) amax = fmaxf(amax, fabsf(p[j]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if constexpr (S::kRowWarps > 1) {
      if (lane == 0) warp_max[parity][warp] = amax;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < S::kRowWarps; ++w) amax = fmaxf(amax, warp_max[parity][g * S::kRowWarps + w]);
    }
    if (row >= m) continue;  // whole warps: a row group is whole warps
    const float s = __fmul_rn(fmaxf(amax, 1e-30f), 1.0f / 127.0f);
    if (t == 0) sx[row] = s;

    // Codes: each thread's loads into the warp's stage at their order in the row, then out as 16-byte vectors.
    // A row of zeros and the padding past the row's end take no division (see the header).
    __syncwarp();  // the lanes have read the last row's codes
#pragma unroll
    for (int v = 0; v < kLoads; ++v) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(stage[warp] + v * S::kSegment + lane * kVec);
      if (amax == 0.f || v * TPR + t >= nvec) {
#pragma unroll
        for (int j = 0; j < kVec / 4; ++j) dst[j] = 0u;
        continue;
      }
      float p[kVec];
      products<T, CS>(cur[v], c + (CS ? v * kVec : 0), p);
#pragma unroll
      for (int j = 0; j < kVec / 4; ++j) dst[j] = pack_codes(p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3], s);
    }
    __syncwarp();
    int8_t* qr = xq + static_cast<int64_t>(row) * k;
    const int first = t - lane;  // the warp's first thread in its row group
#pragma unroll
    for (int h = 0; h < kThreadElems / 16; ++h) {
      const int byte = (lane + 32 * h) * 16;
      const int col = ((byte / S::kSegment) * TPR + first) * kVec + byte % S::kSegment;
      if (col < k) *reinterpret_cast<uint4*>(qr + col) = *reinterpret_cast<const uint4*>(stage[warp] + byte);
    }
  }
}

__device__ __forceinline__ int8_t code(float p, float s) {
  return static_cast<int8_t>(__float2int_rn(__fdiv_rn(p, s)));
}

template <typename T, bool CS>
__global__ void __launch_bounds__(kEdgeThreads)
row_quant_edge_kernel(const T* __restrict__ x, const float* __restrict__ cs, int8_t* __restrict__ xq,
                      float* __restrict__ sx, int k) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * k;
  int8_t* qr = xq + row * k;

  float amax = 0.f;
  for (int i = threadIdx.x; i < k; i += kEdgeThreads)
    amax = fmaxf(amax, fabsf(product<CS>(to_f32(xr[i]), cs, i)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[kEdgeThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kEdgeThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float s = __fmul_rn(fmaxf(amax, 1e-30f), 1.0f / 127.0f);
  if (threadIdx.x == 0) sx[row] = s;
  for (int i = threadIdx.x; i < k; i += kEdgeThreads)
    qr[i] = code(product<CS>(to_f32(xr[i]), cs, i), s);
}

template <typename T, bool CS, int TPR>
cudaError_t launch_regs(const void* x, const float* cs, void* xq, void* sx, int m, int k, cudaStream_t st) {
  using S = RegsShape<T, TPR>;
  static int per_sm = 0;  // blocks an SM holds, read once for each form of the kernel
  if (per_sm == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_quant_regs_kernel<T, CS, TPR>, S::kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  const int blocks = min(per_sm, max(1, kResidentThreads / S::kThreads));
  const int steps = (m + S::kRows - 1) / S::kRows;
  const int grid = static_cast<int>(min(static_cast<long long>(steps), static_cast<long long>(blocks) * sm_count()));
  row_quant_regs_kernel<T, CS, TPR><<<grid, S::kThreads, 0, st>>>(static_cast<const T*>(x), cs,
                                                                   static_cast<int8_t*>(xq), static_cast<float*>(sx),
                                                                   m, k);
  return cudaGetLastError();
}

template <typename T, bool CS>
cudaError_t launch(const void* x, const float* cs, void* xq, void* sx, int m, int k, cudaStream_t st) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (k % 16 != 0 || k > kMaxRegsK || !aligned(x) || !aligned(xq) || (CS && !aligned(cs))) {
    row_quant_edge_kernel<T, CS><<<m, kEdgeThreads, 0, st>>>(static_cast<const T*>(x), cs, static_cast<int8_t*>(xq),
                                                             static_cast<float*>(sx), k);
    return cudaGetLastError();
  }
  // The fewest threads a row whose 32 elements each cover it.
  if (k <= 32 * kThreadElems) return launch_regs<T, CS, 32>(x, cs, xq, sx, m, k, st);
  if (k <= 64 * kThreadElems) return launch_regs<T, CS, 64>(x, cs, xq, sx, m, k, st);
  if (k <= 128 * kThreadElems) return launch_regs<T, CS, 128>(x, cs, xq, sx, m, k, st);
  if (k <= 256 * kThreadElems) return launch_regs<T, CS, 256>(x, cs, xq, sx, m, k, st);
  return launch_regs<T, CS, kMaxRowThreads>(x, cs, xq, sx, m, k, st);
}

}  // namespace

// x [m, k] bf16 or f32, contiguous; cs f32 [k] or null (then the rows of x itself are quantized); xq int8 [m, k];
// sx f32 [m].
extern "C" int kai0_row_quant(const void* x, const void* cs, void* xq, void* sx, int m, int k, int is_bf16,
                              void* stream) {
  if (m <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cs);
  cudaError_t err;
  if (is_bf16) {
    err = c ? launch<__nv_bfloat16, true>(x, c, xq, sx, m, k, st)
            : launch<__nv_bfloat16, false>(x, c, xq, sx, m, k, st);
  } else {
    err = c ? launch<float, true>(x, c, xq, sx, m, k, st) : launch<float, false>(x, c, xq, sx, m, k, st);
  }
  return static_cast<int>(err);
}
