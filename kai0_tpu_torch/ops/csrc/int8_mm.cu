// K4b and K4a: int8 x int8 -> int32 matrix product with the scaling epilogue,
// and the same product with a rank-r LoRA term added per output tile.
//
// Replaces kai0_tpu/ops/pallas_quant.py `_int8_mm_kernel` / `int8_matmul` (K4b)
// and `_int8_mm_lora_kernel` / `int8_matmul_lora` (K4a):
//
//   y[M, N] = float(xq . w) * sx[row] * sn[col]            (K4b; sn optional)
//   y[M, N] = float(xq . w) * sx[row] * sn[col] + lt       (K4a; nt only)
//   lt      = round_to_T(sum_r u[row, r] * b[r, col]),  f32 accumulation
//
// in two orientations of the weight: `nt` (w is [N, C], both operands contract
// their trailing axis; the layout of a torch Linear weight, used by every
// forward product) and `nn` (w is [C, N], contracted on its leading axis; the
// backward's dx = q_row(dy.s) @ q over the same stored weight). One copy of the
// weight serves both.
//
// What bounds it on the H100: operations at the training shapes (M = 30,976
// rows against weights of 2048 x 16384: 2 M N K int8 operations against M K +
// N K + 2 M N bytes is far above the card's ~590 operations a byte), bytes of
// the weight at the serving shapes (M = 50). Three hand-written kernels, chosen
// by shape (`launch`, `kai0_int8_mm_splitk`): both orientations at M > 64 with
// 16-byte aligned rows run on `wgmma` tiles fed by TMA, and K4b's forward
// orientation at M <= 64 on a kernel that splits the contraction over blocks
// (both in int8_mm_wgmma.cuh); the rest (K4a and `nn` at M <= 64, rows of
// other widths) on the warp-level `mma.sync.m16n8k32.s8` kernel below: a block
// of 8 warps owns a 128 x 128 (or 64 x 128 for M <= 64) tile of y, streams
// 64-byte slices of the contraction axis through a 3-stage
// `cp.async` ring in shared memory (16-byte chunks, XOR-swizzled so that
// `ldmatrix` reads without bank conflicts), and keeps the int32 sums in
// registers (64 a thread), so the accumulator never touches memory. Ragged
// edges are masked: rows and columns past the end are zero-filled on load
// (`cp.async` with a source size of 0) and skipped on store; an operand whose
// rows are not 16-byte aligned is loaded byte by byte. Nothing is padded in
// memory.
//
// In this kernel, the `nn` orientation needs B fragments that hold four consecutive
// contraction indices of one output column, but the weight's rows run along
// the output columns. `ldmatrix.trans` transposes 16-bit units, so one
// transposing load whose eight row addresses are the contraction rows
// {4j, 4j+1} (first matrix) and {4j+2, 4j+3} (second) hands each thread the
// 2 x 2 bytes (k, k+1) x (n, n+1) twice; two byte permutes (`prmt`) regroup
// them into the fragment of the even column and that of the odd column. A
// pair of 8-column mma tiles therefore covers 16 consecutive columns
// interleaved (even, odd), which the epilogue undoes when it stores.
//
// Numerics: the integer accumulation is exact. The epilogue converts with
// round-to-nearest and multiplies `acc * sx` then `* sn` with `__fmul_rn`, the
// order of the plain version, so K4b is bit-equal to it. K4a sums the rank-r
// term in f32 (bf16 factors: on the tensor cores, one or two `mma.m16n8k16`
// per 8-column tile, a first version with scalar sums out of shared memory
// took 2.6 times the product itself at K = 2048; f32 factors: plain sums in
// the order r = 0, 1, ...), rounds it to the activation type (bf16: one
// rounding, as a bf16 product of the plain version; f32: none) and adds it
// with `__fadd_rn` (no contraction into an FMA with the scaling). A library
// product sums the r terms in another order, so K4a equals its plain version
// up to isolated flips of one unit in the last place of the rank-r term.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kBN = 128;       // output columns of a block
constexpr int kBK = 64;        // contraction bytes of one stage
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 8 warps: 2 along M, 4 along N; a warp owns (BM/2) x 32
constexpr int kNI = 4;         // 8-column mma tiles of a warp
constexpr int kRankSlice = 32;  // LoRA rank staged in shared memory at a time: the epilogue loops over slices

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-byte chunk of row `row` of a row-major int8 matrix with leading dimension `ld` into shared memory,
// columns [col, col + 16) masked to [0, col_end): `cp.async` when rows are 16-byte aligned, else byte by
// byte; out of range reads as zero.
__device__ __forceinline__ void load_chunk(int8_t* dst, const int8_t* base, int64_t row, int rows, int col, int col_end,
                                           int ld, bool aligned) {
  if (aligned) {
    const bool valid = row < rows && col < col_end;
    cp_async16(smem_u32(dst), valid ? base + row * ld + col : base, valid ? 16 : 0);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[j] = (row < rows && col + j < col_end) ? base[row * ld + col + j] : int8_t(0);
  }
}

// Shared-memory offset of 16-byte chunk c of row r. Rows of 64 bytes (A, and B
// in the nt orientation): 8 consecutive rows of one chunk column land on 8
// distinct 16-byte bank groups.
__device__ __forceinline__ int swz64(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }
// Rows of 128 bytes (B in the nn orientation, rows = contraction index): the
// transposing load reads rows {4j, 4j+1} or {4j+2, 4j+3}, j = 0..3, of one
// chunk column; this XOR spreads either set over the 8 bank groups.
__device__ __forceinline__ int swz128(int r, int c) { return r * 128 + ((c ^ ((((r >> 2) & 3) << 1) | (r & 1))) << 4); }

template <typename TOut, int W>
__device__ __forceinline__ void store_vals(TOut* p, const float (&v)[W]) {
  if constexpr (sizeof(TOut) == 4) {
    if constexpr (W == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    if constexpr (W == 2) {
      *reinterpret_cast<__nv_bfloat162*>(p) = lo;
    } else {
      __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(p) = packed;
    }
  }
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The `wgmma` kernel of both orientations at M > 64 and the split-contraction kernel of nt at M <= 64.
#include "int8_mm_wgmma.cuh"

// BM: rows of the block tile (64 or 128). NN: the weight is [C, N] (else [N, C]).
// LORA: add the rank-r term (not with NN). TOut: type of y, and of u and b with LORA.
template <int BM, bool NN, bool LORA, typename TOut>
__global__ void __launch_bounds__(kThreads)
int8_mm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w, const float* __restrict__ sx,
               const float* __restrict__ sn, const TOut* __restrict__ u, const TOut* __restrict__ b,
               TOut* __restrict__ out, int m, int n, int kc, int rank, int a_aligned, int b_aligned) {
  constexpr int kMI = BM / 32;  // 16-row mma tiles of a warp
  constexpr int kWM = BM / 2;   // rows of a warp
  constexpr int kABytes = BM * kBK;
  constexpr int kBBytes = kBN * kBK;
  constexpr int kStageBytes = kABytes + kBBytes;
  __shared__ __align__(128) int8_t smem[kStages * kStageBytes];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, c4 = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int nk = (kc + kBK - 1) / kBK;

  auto load_stage = [&](int stage, int kt) {
    int8_t* a_s = smem + stage * kStageBytes;
    int8_t* b_s = a_s + kABytes;
    const int k0 = kt * kBK;
    for (int i = tid; i < BM * (kBK / 16); i += kThreads) {
      const int r = i >> 2, c = i & 3;
      load_chunk(a_s + swz64(r, c), xq, m0 + r, m, k0 + c * 16, kc, kc, a_aligned);
    }
    if constexpr (NN) {  // tile rows are contraction indices, 128 output columns wide
      for (int i = tid; i < kBK * (kBN / 16); i += kThreads) {
        const int r = i >> 3, c = i & 7;
        load_chunk(b_s + swz128(r, c), w, k0 + r, kc, n0 + c * 16, n, n, b_aligned);
      }
    } else {  // tile rows are output columns, 64 contraction bytes wide
      for (int i = tid; i < kBN * (kBK / 16); i += kThreads) {
        const int r = i >> 2, c = i & 3;
        load_chunk(b_s + swz64(r, c), w, n0 + r, n, k0 + c * 16, kc, kc, b_aligned);
      }
    }
  };

  int acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // tile kt has landed for every thread; stage (kt-1) % kStages is free
    if (kt + kStages - 1 < nk) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);

    const int8_t* a_s = smem + (kt % kStages) * kStageBytes;
    const int8_t* b_s = a_s + kABytes;
    const uint32_t a_base = smem_u32(a_s), b_base = smem_u32(b_s);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[kMI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        // matrices: (rows 0-7, k 0-15), (rows 8-15, k 0-15), (rows 0-7, k 16-31), (rows 8-15, k 16-31)
        const int r = warp_m * kWM + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = (ks >> 4) + (lane >> 4);
        ldmatrix_x4(af[mi], a_base + swz64(r, c));
      }
      uint32_t bf[kNI][2];
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) {
        uint32_t t[4];
        if constexpr (NN) {
          // matrices: contraction rows ks + {4j, 4j+1}, ks + {4j+2, 4j+3}, then the same 16 further on
          const int mat = lane >> 3, rr = lane & 7;
          const int kr = ks + (mat >> 1) * 16 + (rr >> 1) * 4 + (mat & 1) * 2 + (rr & 1);
          ldmatrix_x4_trans(t, b_base + swz128(kr, warp_n * 2 + nj));
          bf[2 * nj][0] = __byte_perm(t[0], t[1], 0x6420);      // even columns, k 0-15
          bf[2 * nj + 1][0] = __byte_perm(t[0], t[1], 0x7531);  // odd columns
          bf[2 * nj][1] = __byte_perm(t[2], t[3], 0x6420);      // k 16-31
          bf[2 * nj + 1][1] = __byte_perm(t[2], t[3], 0x7531);
        } else {
          // matrices: (cols 0-7, k 0-15), (cols 0-7, k 16-31), (cols 8-15, k 0-15), (cols 8-15, k 16-31)
          const int r = warp_n * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8;
          const int c = (ks >> 4) + ((lane >> 3) & 1);
          ldmatrix_x4(t, b_base + swz64(r, c));
          bf[2 * nj][0] = t[0];
          bf[2 * nj][1] = t[1];
          bf[2 * nj + 1][0] = t[2];
          bf[2 * nj + 1][1] = t[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // LoRA operands in shared memory (the ring is free now), a slice of up to kRankSlice ranks at a time: u as
  // [BM][ld] and b transposed as [BN][ld], the slice zero-padded to a multiple of 16 (the depth of one bf16 mma),
  // 4 bytes of padding a row. A rank of at most kRankSlice is staged once; a larger one is staged again for
  // every 16-row tile mi, so that only that tile's rank-r sums are live (their registers keep two blocks an SM).
  TOut* u_s = reinterpret_cast<TOut*>(smem);
  TOut* bt_s = u_s + BM * (kRankSlice + 2);
  int staged = -1;  // first rank of the slice in shared memory
  auto stage = [&](int r0, int rs, int rp, int ld) {
    __syncthreads();  // the ring, or the slice before, is no longer read
    for (int i = tid; i < BM * rp; i += kThreads) {
      const int r = i / rp, j = i - r * rp;
      u_s[r * ld + j] = (m0 + r < m && j < rs) ? u[static_cast<int64_t>(m0 + r) * rank + r0 + j] : TOut(0.f);
    }
    for (int i = tid; i < rp * kBN; i += kThreads) {
      const int j = i / kBN, col = i - j * kBN;  // consecutive threads read consecutive columns of b
      bt_s[col * ld + j] = (n0 + col < n && j < rs) ? b[static_cast<int64_t>(r0 + j) * n + n0 + col] : TOut(0.f);
    }
    __syncthreads();
    staged = r0;
  };

  // Epilogue. A group is a run of W consecutive output columns that one thread
  // holds: nt, the 2 columns of one mma tile; nn, 4 columns over an (even, odd)
  // pair of tiles.
  constexpr int W = NN ? 4 : 2;
  constexpr int kGroups = kNI * 2 / W;
  const bool vec_ok = (n % W == 0);
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
    const int rl0 = warp_m * kWM + mi * 16 + g;  // this thread's rows of the tile: rl0 and rl0 + 8
    float lt[kNI][4];  // the rank-r term of this thread's outputs, in the layout of acc[mi]
    if constexpr (LORA) {
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) lt[ni][e] = 0.f;
      // Over the slices the sums keep their order: the mma steps of 16 ranks (bf16), r = 0, 1, ... (f32).
      for (int r0 = 0; r0 < rank; r0 += kRankSlice) {
        const int rs = min(kRankSlice, rank - r0);
        const int rp = (rs + 15) & ~15;
        const int ld = rp + 4 / static_cast<int>(sizeof(TOut));
        if (staged != r0) stage(r0, rs, rp, ld);
        if constexpr (sizeof(TOut) == 2) {
          // bf16: the rank-r product on the tensor cores (m16n8k16, f32 accumulation); its accumulator
          // fragment has the layout of the int8 product's, so the sums line up element by element.
          for (int kk = 0; kk < rp; kk += 16) {
            uint32_t ua[4];
            ua[0] = *reinterpret_cast<const uint32_t*>(u_s + rl0 * ld + kk + 2 * c4);
            ua[1] = *reinterpret_cast<const uint32_t*>(u_s + (rl0 + 8) * ld + kk + 2 * c4);
            ua[2] = *reinterpret_cast<const uint32_t*>(u_s + rl0 * ld + kk + 8 + 2 * c4);
            ua[3] = *reinterpret_cast<const uint32_t*>(u_s + (rl0 + 8) * ld + kk + 8 + 2 * c4);
#pragma unroll
            for (int ni = 0; ni < kNI; ++ni) {
              const TOut* bcol = bt_s + (warp_n * 32 + ni * 8 + g) * ld + kk + 2 * c4;
              mma_bf16(lt[ni], ua, *reinterpret_cast<const uint32_t*>(bcol),
                       *reinterpret_cast<const uint32_t*>(bcol + 8));
            }
          }
        } else {
          // f32: plain sums in the order r = 0, 1, ...
#pragma unroll
          for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const TOut* urow = u_s + (rl0 + 8 * (e >> 1)) * ld;
              const TOut* bcol = bt_s + (warp_n * 32 + ni * 8 + 2 * c4 + (e & 1)) * ld;
              float sum = lt[ni][e];
              for (int r = 0; r < rs; ++r) sum = fmaf(to_f32(urow[r]), to_f32(bcol[r]), sum);
              lt[ni][e] = sum;
            }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + rl0 + 8 * h;
      if (row >= m) continue;
      const float srow = sx[row];
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const int col = n0 + warp_n * 32 + (NN ? q * 16 + 4 * c4 : q * 8 + 2 * c4);
        float vals[W];
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const int ni = NN ? 2 * q + (j & 1) : q;
          const int e = NN ? (j >> 1) : j;
          float y = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), srow);
          if (sn != nullptr) y = __fmul_rn(y, (col + j < n) ? sn[col + j] : 0.f);
          if constexpr (LORA) y = __fadd_rn(y, round_to(lt[ni][2 * h + e], TOut()));
          vals[j] = y;
        }
        TOut* dst = out + static_cast<int64_t>(row) * n + col;
        if (vec_ok && col + W <= n) {
          store_vals<TOut, W>(dst, vals);
        } else {
#pragma unroll
          for (int j = 0; j < W; ++j)
            if (col + j < n) store_one(dst + j, vals[j]);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's entry-point query (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// TMA descriptor of a row-major int8 matrix [rows, cols] (cols a multiple of 16, base 16-byte aligned) read
// in tiles of box_rows x 128 bytes, 128-byte swizzled; reads past the edges fill zeros. It holds the base
// pointer, so it is encoded per call (on the host, about a microsecond).
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kWgBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p, int ld) { return ld % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Output tiles of the `wgmma` kernel: 128 wgmma rows over the rows of y (nt) or its columns (NN), BN over the other.
template <int BN, bool NN>
int wgmma_tiles(int m, int n) {
  const int p = NN ? n : m, q = NN ? m : n;
  return ((p + kWgBM - 1) / kWgBM) * ((q + BN - 1) / BN);
}

// tma_a: xq in boxes of 128 rows (nt) or w [kc, n] in boxes of 128 contraction rows (NN); tma_b: w [n, kc] (nt)
// or xq (NN) in boxes of BN rows.
template <int BN, bool NN, bool LORA, typename TOut>
int launch_wgmma(const void* xq, const void* w, const void* sx, const void* sn, const void* u, const void* b, void* out,
                 int m, int n, int kc, int rank, cudaStream_t st) {
  CUtensorMap ta, tb;
  const bool mapped = NN ? tensor_map(&ta, w, kc, n, kWgBM) && tensor_map(&tb, xq, m, kc, BN)
                         : tensor_map(&ta, xq, m, kc, kWgBM) && tensor_map(&tb, w, n, kc, BN);
  if (!mapped) return static_cast<int>(cudaErrorInvalidValue);
  using T = WgTile<BN, LORA, TOut>;
  const auto kernel = int8_mm_wgmma_kernel<BN, NN, LORA, TOut>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<min(wgmma_tiles<BN, NN>(m, n), sm_count()), kWgThreads, T::kSmem, st>>>(
      ta, tb, static_cast<const float*>(sx), static_cast<const float*>(sn), static_cast<const TOut*>(u),
      static_cast<const TOut*>(b), static_cast<TOut*>(out), m, n, kc, rank);
  return static_cast<int>(cudaGetLastError());
}


// Two hand-written kernels, chosen by shape: both orientations at M > 64 with 16-byte aligned rows (every
// product the training paths launch, and int8 serving's prefill) run on the `wgmma` kernel; the rest (M <= 64
// for K4a and for nn, which no path launches, and rows of other widths) on the `mma.sync` tiles. K4b's nt at
// M <= 64 goes to the split kernel from the wrapper, which owns its workspace (kai0_int8_mm_splitk).
template <bool NN, bool LORA, typename TOut>
int launch(const void* xq, const void* w, const void* sx, const void* sn, const void* u, const void* b, void* out,
           int m, int n, int kc, int rank, cudaStream_t st) {
  const int a_aligned = aligned16(xq, kc);
  const int b_aligned = aligned16(w, NN ? n : kc);
  if (m > 64 && a_aligned && b_aligned) {
    // 128 x 256 tiles where they fill a wave of the card (fewer bytes a product); 128 x 128 tiles, twice as
    // many blocks, where they would not (the prefill's and the action expert's narrow products).
    return wgmma_tiles<256, NN>(m, n) >= sm_count()
               ? launch_wgmma<256, NN, LORA, TOut>(xq, w, sx, sn, u, b, out, m, n, kc, rank, st)
               : launch_wgmma<128, NN, LORA, TOut>(xq, w, sx, sn, u, b, out, m, n, kc, rank, st);
  }
  const dim3 block(kThreads);
#define KAI0_INT8_MM_LAUNCH(BM)                                                                                   \
  int8_mm_kernel<BM, NN, LORA, TOut><<<dim3((n + kBN - 1) / kBN, (m + BM - 1) / BM), block, 0, st>>>(             \
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w), static_cast<const float*>(sx),              \
      static_cast<const float*>(sn), static_cast<const TOut*>(u), static_cast<const TOut*>(b),                   \
      static_cast<TOut*>(out), m, n, kc, rank, a_aligned, b_aligned)
  if (m <= 64) {
    KAI0_INT8_MM_LAUNCH(64);
  } else {
    KAI0_INT8_MM_LAUNCH(128);
  }
#undef KAI0_INT8_MM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <int BN, typename TOut>
int launch_splitk(const void* xq, const void* w, const void* sx, const void* sn, void* out, void* ws, void* counters,
                  int m, int n, int kc, int splits, int chunk, cudaStream_t st) {
  int8_mm_splitk_kernel<BN, TOut><<<dim3((n + BN - 1) / BN, splits), kSkThreads, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w), static_cast<const float*>(sx),
      static_cast<const float*>(sn), static_cast<TOut*>(out), static_cast<int*>(ws), static_cast<int*>(counters), m, n,
      kc, chunk, splits, aligned16(xq, kc), aligned16(w, kc));
  return static_cast<int>(cudaGetLastError());
}

// NN: the weight is [kc, n]. Only the product without the rank-r term is built in that orientation.
template <bool NN, bool LORA>
int dispatch(const void* xq, const void* w, const void* sx, const void* sn, const void* u, const void* b, void* out,
             int m, int n, int kc, int rank, int is_bf16, void* stream) {
  static_assert(!(NN && LORA), "the rank-r term goes with the forward orientation only");
  if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (kc <= 0 || (LORA && rank <= 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<NN, LORA, __nv_bfloat16>(xq, w, sx, sn, u, b, out, m, n, kc, rank, st)
                 : launch<NN, LORA, float>(xq, w, sx, sn, u, b, out, m, n, kc, rank, st);
}

}  // namespace

// K4b. xq int8 [m, kc]; w int8 [n, kc] (nt) or [kc, n]; sx f32 [m]; sn f32 [n] or null; out [m, n] bf16 or f32.
extern "C" int kai0_int8_mm(const void* xq, const void* w, const void* sx, const void* sn, void* out, int m, int n,
                            int kc, int nt, int out_bf16, void* stream) {
  return nt ? dispatch<false, false>(xq, w, sx, sn, nullptr, nullptr, out, m, n, kc, 0, out_bf16, stream)
            : dispatch<true, false>(xq, w, sx, sn, nullptr, nullptr, out, m, n, kc, 0, out_bf16, stream);
}

// K4a. As K4b over w [n, kc] with sn required, plus u [m, rank] and b [rank, n] in out's type; any rank > 0.
extern "C" int kai0_int8_mm_lora(const void* xq, const void* w, const void* sx, const void* sn, const void* u,
                                 const void* b, void* out, int m, int n, int kc, int rank, int is_bf16,
                                 void* stream) {
  return dispatch<false, true>(xq, w, sx, sn, u, b, out, m, n, kc, rank, is_bf16, stream);
}

// K4b's nt at m <= 64, split over the contraction: `splits` ranges of `chunk` bytes (a multiple of 128) for
// column tiles of `bn` (16, 32 or 64); ws int32 [m, n] and counters int32 [ceil(n / bn)], both zero, and left
// zero for the next call.
extern "C" int kai0_int8_mm_splitk(const void* xq, const void* w, const void* sx, const void* sn, void* out, void* ws,
                                   void* counters, int m, int n, int kc, int bn, int splits, int chunk, int out_bf16,
                                   void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (m > kSkBM || kc <= 0 || splits <= 0 || chunk <= 0 || chunk % kWgBK != 0 || static_cast<int64_t>(splits) * chunk < kc ||
      static_cast<int64_t>(splits - 1) * chunk >= kc)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KAI0_INT8_MM_SPLITK(BN)                                                                                \
  if (bn == BN)                                                                                                \
    return out_bf16 ? launch_splitk<BN, __nv_bfloat16>(xq, w, sx, sn, out, ws, counters, m, n, kc, splits, chunk, st) \
                    : launch_splitk<BN, float>(xq, w, sx, sn, out, ws, counters, m, n, kc, splits, chunk, st);
  KAI0_INT8_MM_SPLITK(64)
  KAI0_INT8_MM_SPLITK(32)
  KAI0_INT8_MM_SPLITK(16)
#undef KAI0_INT8_MM_SPLITK
  return static_cast<int>(cudaErrorInvalidValue);
}
