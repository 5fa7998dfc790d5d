// K5: per-row symmetric int8 quantization of a 2-D activation in one launch.
//
// Replaces kai0_tpu/ops/pallas_rowquant.py `_kernel` / `row_quant`: for each
// row, amax = max|x|, s = max(amax, 1e-30) * (1/127) in f32, codes
// round_half_even(float(x) / s) as int8; returns the codes [M, K] and the
// scales [M, 1].
//
// What bounds it on the H100: bytes. It reads x once (2 or 4 bytes an element)
// and writes one byte an element plus 4 bytes a row; a division and a rounding
// an element are far below the f32 rate. The design: one block of 256 threads
// per row; a first sweep for the row's amax (16-byte loads, warp shuffles, one
// exchange through shared memory), a second sweep over the same row, which the
// first left in L1/L2 (a row is at most 64 KB here), that divides, rounds and
// stores 8 (bf16 input) or 4 (f32 input) codes a thread at a time. Rows are
// independent, so there is no tiling of M and no ragged edge; a K that is not
// a multiple of the vector width, or a misaligned base, takes scalar loads.
//
// Numerics: bit-equal to the plain version (`row_quant.row_quant_plain`). The
// max of absolute values is exact in any type, so taking it on the f32 images
// of bf16 values equals taking it in bf16 and casting. The scale is the product
// with the f32 constant 1/127, not a division: that is what the JAX package's
// `/ 127.0` compiles to under jit (XLA turns a division by a constant into a
// multiplication by its reciprocal), and a true division differs from it by one
// unit in the last place on some rows. The division x / s is IEEE (`__fdiv_rn`;
// no --use_fast_math, no reciprocal multiply) and the rounding is to nearest
// even (`__float2int_rn`), or codes would flip against
// `torch.round(x.float() / s)`. A row of zeros gives s = 1e-30 * (1/127) and
// codes 0. Non-finite inputs are not supported.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int8_t code(float x, float s) {
  return static_cast<int8_t>(__float2int_rn(__fdiv_rn(x, s)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int k, int vec_ok) {
  constexpr int kVec = 16 / sizeof(T);  // elements of one 16-byte load
  const int64_t row = blockIdx.x;
  const T* xr = x + row * k;
  int8_t* qr = xq + row * k;
  const int nvec = vec_ok ? k / kVec : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);

  float amax = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 v = xv[i];
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) amax = fmaxf(amax, fabsf(to_f32(e[j])));
  }
  for (int i = nvec * kVec + threadIdx.x; i < k; i += kThreads) amax = fmaxf(amax, fabsf(to_f32(xr[i])));

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float s = __fmul_rn(fmaxf(amax, 1e-30f), 1.0f / 127.0f);
  if (threadIdx.x == 0) sx[row] = s;

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 v = xv[i];
    const T* e = reinterpret_cast<const T*>(&v);
    uint32_t packed[kVec / 4];
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        word |= static_cast<uint32_t>(static_cast<uint8_t>(code(to_f32(e[4 * j + b]), s))) << (8 * b);
      packed[j] = word;
    }
    if constexpr (kVec == 8) {
      reinterpret_cast<uint2*>(qr)[i] = make_uint2(packed[0], packed[1]);
    } else {
      reinterpret_cast<uint32_t*>(qr)[i] = packed[0];
    }
  }
  for (int i = nvec * kVec + threadIdx.x; i < k; i += kThreads) qr[i] = code(to_f32(xr[i]), s);
}

}  // namespace

// x [m, k] bf16 or f32, contiguous; xq int8 [m, k]; sx f32 [m].
extern "C" int kai0_row_quant(const void* x, void* xq, void* sx, int m, int k, int is_bf16, void* stream) {
  if (m <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int elem = is_bf16 ? 2 : 4;
  const int vec = 16 / elem;
  const int vec_ok = (k % vec == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(xq) % 8 == 0);
  if (is_bf16) {
    row_quant_kernel<__nv_bfloat16><<<m, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), k, vec_ok);
  } else {
    row_quant_kernel<float><<<m, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), k, vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}
