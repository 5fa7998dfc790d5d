// The two kernels of K4b/K4a that int8_mm.cu dispatches to besides its
// `mma.sync` tiles; included by int8_mm.cu inside its anonymous namespace, after
// the helpers they share (`store_vals`, `round_to`, `swz64`, `mma_s8`).
//
// 1. `int8_mm_wgmma_kernel`: every product at M > 64 with 16-byte aligned rows,
//    K4b in both orientations and K4a. Bound by operations there (M = 1,600 to
//    30,976 rows against weights of 1-32 MB), so the design feeds Hopper's
//    warpgroup MMA, the only path to the int8 peak:
//    `wgmma.mma_async.m64nBNk32.s32.s8.s8`, which takes 8-bit operands K-major
//    only, B always from shared memory in 128-byte rows swizzled by TMA's
//    128-byte pattern.
//    - Forward (`nt`: xq [M, C] and the stored weight w [N, C], both contiguous
//      along the contraction): A (xq) and B (w) both from shared memory, as
//      they lie in memory.
//    - Backward (`nn`, the LoRA step's dx = q_row(dy·s) @ w over the same
//      stored w, here [C, N]): w is MN-major. The kernel computes yᵀ = wᵀ xqᵀ:
//      B is xq, K-major as it lies; A is the w tile, which TMA lands as 128
//      contraction rows of 128 columns and each warp turns into the register
//      form of A (`ldmatrix.trans` + two `prmt` a fragment pair, the `mma.sync`
//      kernel's B recipe) for `wgmma`'s register-A variant. No transposed copy
//      of the weight (2.3 GB at full width) and no transposing pass through
//      shared memory. A warp's fragments hold 16 consecutive columns of w
//      interleaved (even columns in A rows 0-7, odd ones in rows 8-15), so
//      each thread ends with two adjacent columns of y for 2 x BN/8 rows and
//      stores them as pairs: a warp's store fills whole 32-byte sectors.
//    Output tiles are 128 x 256 where they fill a wave of the card, else
//    128 x 128 (twice the blocks for narrow products). The kernel is
//    persistent: one block per SM walks over the tiles in groups of 16 row
//    tiles (so the operands of the tiles in flight stay in L2); one producer
//    thread issues two 2-D TMA tile loads per 128-byte stage of the
//    contraction into a ring of 3-6 `mbarrier`-guarded stages and runs on into
//    the next tile while the consumers finish this one; two consumer
//    warpgroups (64 rows each) run four k32 `wgmma` per stage and keep one
//    group in flight while they release the stage before. `setmaxnreg` moves
//    registers from the producer to the consumers. TMA zero-fills rows and
//    columns past the edges, so nothing is padded in memory and the ragged
//    contraction tail adds zeros.
//    The epilogue is the `mma.sync` kernel's: int32 -> f32 round to nearest,
//    `* sx` then `* sn` with `__fmul_rn` (K4b bit-equal to the plain version),
//    and K4a's rank-r term as bf16 `mma.m16n8k16` steps of 16 ranks in slices
//    of 32, whose accumulator fragment is `wgmma`'s per warp (rows g and g + 8,
//    columns 2 c4 and 2 c4 + 1 of each 8-column group): the term of every
//    output goes through the same steps in the same order as in the `mma.sync`
//    kernel, so K4a gives that kernel's bits.
// 2. `int8_mm_splitk_kernel`: K4b `nt` at M <= 64 (int8 serving's denoise
//    steps, 50 rows), bound by the weight's bytes. One 64-row tile would give
//    N / 128 blocks, 4-32 for 132 SMs, each streaming all of the contraction;
//    here BN-column tiles (64, 32 or 16) times `splits` contraction ranges of
//    `chunk` bytes (a multiple of 128; the last range may be shorter), chosen
//    by the wrapper to cover the SMs, each range on `mma.sync.m16n8k32`. The
//    int32 partial sums go into a zeroed workspace by `red.global.add.s32`;
//    integer addition is exact in any order, so the sum, and the output, are
//    deterministic. The last block of a tile to arrive (one counter a column
//    tile) applies the epilogue once to the full sums and zeroes its part of the
//    workspace and its counter for the next call: one launch, no second pass.
#pragma once

// ---------------------------------------------------------------------------
// PTX: mbarrier, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of `parity` has completed. A wait of 2^32 cycles (over two
// seconds) can only come from a broken pipeline: trap, so the launch fails instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

// A 2-D tile of `map` at (c0 along the contiguous axis, c1 along rows) into shared
// memory at `dst`; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator register across
// the asynchronous `wgmma` that owns it.
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand in 128-byte rows with the
// 128-byte swizzle: 8-row groups 1024 bytes apart (stride byte offset), the
// leading byte offset unused for this layout, layout type 1 (SWIZZLE_128B) in bits
// 62-63. The tile must start 1024-byte aligned; a k32 step adds 32 bytes (2 in the
// address field, which counts 16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The same products with A from registers (the register-A form of `wgmma`): a[0..3] hold this thread's
// fragment of the 64 x 32 A tile, laid out as `mma.m16n8k32`'s A fragment within each warp's 16 rows.
__device__ __forceinline__ void wgmma_s8_rs_n128(int (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_rs_n256(int (&d)[128], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (BN == 128) {
    wgmma_s8_n128(d, desc_a, desc_b, 1);
  } else {
    static_assert(BN == 256, "output tiles of 128 or 256 columns");
    wgmma_s8_n256(d, desc_a, desc_b, 1);
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (BN == 128) {
    wgmma_s8_rs_n128(d, a, desc_b);
  } else {
    static_assert(BN == 256, "output tiles of 128 or 256 columns");
    wgmma_s8_rs_n256(d, a, desc_b);
  }
}

template <int R>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// ---------------------------------------------------------------------------
// 1. M > 64: wgmma fed by TMA, both orientations
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;       // wgmma rows of a tile: two consumer warpgroups of 64
constexpr int kWgBK = 128;       // contraction bytes of a stage: one 128-byte swizzle row
constexpr int kWgThreads = 384;  // warpgroup 0: the producer (one thread issues); 1-2: consumers
constexpr int kEpiCols = 64;     // columns of the epilogue's chunk (the rank-r sums of one chunk are live)
constexpr int kSmemLimit = 232448;  // shared memory a block may have on the H100

template <int BN, bool LORA, typename TOut>
struct WgTile {
  static constexpr int kABytes = kWgBM * kWgBK;
  static constexpr int kStageBytes = kABytes + BN * kWgBK;  // a multiple of 1024: every tile stays aligned
  // LoRA operands, outside the ring (the producer fills the ring with the next tile during the epilogue):
  // a slice of u as [128][kRankSlice + 2] and of b transposed as [BN][kRankSlice + 2].
  static constexpr int kLoraBytes = LORA ? (kWgBM + BN) * (kRankSlice + 2) * static_cast<int>(sizeof(TOut)) : 0;
  static constexpr int kFixed = kLoraBytes + 1024 + 16 * 8;  // + alignment slack and the barriers
  static constexpr int kStages = (kSmemLimit - kFixed) / kStageBytes < 6 ? (kSmemLimit - kFixed) / kStageBytes : 6;
  static constexpr int kSmem = kStages * kStageBytes + kFixed;
  static_assert(kStages >= 3, "the ring needs three stages");
};

constexpr int kGroupRows = 16;  // row tiles of a group in the tile order

// Tile t of the order in which the blocks walk the output: groups of kGroupRows row tiles (of the 128 wgmma
// rows), rows fastest within a group. The ~132 tiles in flight then span at most 16 row tiles and about 9
// column tiles, so their operands stay in L2 while they are reread; with columns fastest over N = 16384 every
// block in flight read its own 512 KB slab of w.
__device__ __forceinline__ void tile_origin(int t, int p_tiles, int q_tiles, int bn, int& p0, int& q0) {
  const int per_group = kGroupRows * q_tiles;
  const int first = (t / per_group) * kGroupRows;
  const int rows = min(kGroupRows, p_tiles - first);
  const int r = t % per_group;
  p0 = (first + r % rows) * kWgBM;
  q0 = (r / rows) * bn;
}

// Persistent: a block per SM walks over the output tiles t = blockIdx.x, + gridDim.x, ... (in the order of
// `tile_origin`), and the ring's stages and phases run on across tiles. A tile is 128 wgmma rows (p) by BN
// wgmma columns (q): nt, p runs over the rows of y and q over its columns, tma_a maps xq [m, kc] and tma_b
// w [n, kc]; NN, p runs over the columns of y and q over its rows (the product is yᵀ = wᵀ xqᵀ), tma_a maps
// w [kc, n] in boxes of 128 contraction rows x 128 columns and tma_b maps xq.
template <int BN, bool NN, bool LORA, typename TOut>
__global__ void __launch_bounds__(kWgThreads, 1)
int8_mm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                     const float* __restrict__ sx, const float* __restrict__ sn, const TOut* __restrict__ u,
                     const TOut* __restrict__ b, TOut* __restrict__ out, int m, int n, int kc, int rank) {
  static_assert(!(NN && LORA), "the rank-r term goes with the forward orientation only");
  using T = WgTile<BN, LORA, TOut>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full = base + S * T::kStageBytes;  // full[s] at full + 8 s: the stage has landed
  const uint32_t empty = full + 8 * S;              // empty[s]: the 8 consumer warps are done with it
  const int p_tiles = ((NN ? n : m) + kWgBM - 1) / kWgBM, q_tiles = ((NN ? m : n) + BN - 1) / BN;
  const int tiles = p_tiles * q_tiles;
  const int nk = (kc + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;  // stage-loads issued by this block
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int p0, q0;
        tile_origin(t, p_tiles, q_tiles, BN, p0, q0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);  // the first round finds every stage free
          mbar_expect_tx(full + 8 * s, T::kStageBytes);   // zero-filled bytes past the edges count too
          const uint32_t a_s = base + s * T::kStageBytes;
          if constexpr (NN) {
            tma_load_2d(a_s, &tma_a, full + 8 * s, p0, kt * kWgBK);
          } else {
            tma_load_2d(a_s, &tma_a, full + 8 * s, kt * kWgBK, p0);
          }
          tma_load_2d(a_s + T::kABytes, &tma_b, full + 8 * s, kt * kWgBK, q0);
        }
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;                                  // wgmma rows 64 cw .. 64 cw + 63 of a tile
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int rl0 = cw * 64 + warp * 16 + g;  // this thread's wgmma rows of a tile: rl0 and rl0 + 8
  const int ct = threadIdx.x - 128;         // index among the 256 consumer threads
  TOut* u_s = reinterpret_cast<TOut*>(smem + S * T::kStageBytes + 16 * 8);
  TOut* bt_s = u_s + kWgBM * (kRankSlice + 2);
  int it = 0;  // stages consumed by this block

  // NN: the stage's w tile is [128 contraction rows][128 columns], MN-major, but `wgmma` takes 8-bit operands
  // K-major only, so A (16 columns of w a warp) comes from registers: one transposing `ldmatrix` a k32 step
  // reads contraction rows {4j, 4j+1} (matrices 0 and 2) and {4j+2, 4j+3} (1 and 3), j = 0..3, of the warp's
  // 16-byte column chunk, and two byte permutes a pair make the fragment of the even columns (A rows 0-7) and
  // of the odd ones (A rows 8-15), as the `mma.sync` kernel builds its B fragments. The fragments of two
  // stages alternate between two register sets: a stage's set is rewritten only after the `wgmma` group that
  // reads it has been waited for.
  const int w_chunk = cw * 4 + warp;  // the warp's 16 columns of the w tile, as a 16-byte chunk of its rows
  const int ld_row = (lane >> 4) * 16 + ((lane >> 1) & 3) * 4 + ((lane >> 3) & 1) * 2 + (lane & 1);
  auto nn_stage = [&](int kt, int (&acc)[BN / 2], uint32_t (&af)[4][4]) {
    const int s = it % S;
    mbar_wait(full + 8 * s, (it / S) & 1);
    const uint32_t w_s = base + s * T::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kWgBK / 32; ++kk) {
      const int kr = kk * 32 + ld_row;
      uint32_t tq[4];
      ldmatrix_x4_trans(tq, w_s + kr * kWgBK + ((w_chunk ^ (kr & 7)) << 4));  // TMA's 128-byte swizzle
      af[kk][0] = __byte_perm(tq[0], tq[1], 0x6420);  // even columns, k 0-15
      af[kk][1] = __byte_perm(tq[0], tq[1], 0x7531);  // odd columns
      af[kk][2] = __byte_perm(tq[2], tq[3], 0x6420);  // k 16-31
      af[kk][3] = __byte_perm(tq[2], tq[3], 0x7531);
      fence_operands(af[kk]);
    }
    const uint64_t db = desc_sw128(w_s + T::kABytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 32; ++kk) wgmma_s8_rs<BN>(acc, af[kk], db + 2 * kk);
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();  // the stage before has been read, and its fragments: hand it back to the producer
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
    }
    ++it;
  };

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int p0, q0;
    tile_origin(t, p_tiles, q_tiles, BN, p0, q0);
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_operands(acc);
    if constexpr (NN) {
      uint32_t af0[4][4], af1[4][4];
      for (int kt = 0; kt < nk; kt += 2) {
        nn_stage(kt, acc, af0);
        if (kt + 1 < nk) nn_stage(kt + 1, acc, af1);
      }
    } else {
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % S;
        mbar_wait(full + 8 * s, (it / S) & 1);
        const uint64_t da = desc_sw128(base + s * T::kStageBytes + cw * 64 * kWgBK);
        const uint64_t db = desc_sw128(base + s * T::kStageBytes + T::kABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 32; ++kk) wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        if (kt > 0) {
          wgmma_wait<1>();  // the stage before has been read: hand it back to the producer
          if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
        }
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));  // the tile's last stage: the producer runs on

    if constexpr (NN) {
      // Epilogue of yᵀ: this thread holds the columns col and col + 1 of y (A rows g and g + 8: even, odd) for
      // the rows q0 + 8 j + 2 c4 + e, in acc[4 j + e] and acc[4 j + 2 + e]; a warp's store covers 16 columns
      // (whole 32-byte sectors) of four rows.
      const int col = p0 + cw * 64 + warp * 16 + 2 * g;
      if (col >= n) continue;
      const bool pair = n % 2 == 0 && col + 2 <= n;
      const float sc0 = sn != nullptr ? sn[col] : 1.f, sc1 = sn != nullptr && col + 1 < n ? sn[col + 1] : 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = q0 + 8 * j + 2 * c4 + e;
          if (row >= m) continue;
          const float srow = sx[row];
          float vals[2] = {__fmul_rn(__int2float_rn(acc[4 * j + e]), srow),
                           __fmul_rn(__int2float_rn(acc[4 * j + 2 + e]), srow)};
          if (sn != nullptr) {
            vals[0] = __fmul_rn(vals[0], sc0);
            vals[1] = __fmul_rn(vals[1], sc1);
          }
          TOut* dst = out + static_cast<int64_t>(row) * n + col;
          if (pair) {
            store_vals<TOut, 2>(dst, vals);
          } else {
            store_one(dst, vals[0]);
            if (col + 1 < n) store_one(dst + 1, vals[1]);
          }
        }
      }
    } else {
      const int m0 = p0, n0 = q0;
      const bool vec_ok = (n % 2 == 0);

      // Epilogue, in chunks of 64 columns, while the producer loads the next tile. This thread's outputs: rows
      // rl0 and rl0 + 8, columns 8 j + 2 c4 + {0, 1}, held in acc[4 j + {0, 1}] and acc[4 j + {2, 3}].
      int staged = -1;  // first rank of the LoRA slice in shared memory, for this tile
      auto stage = [&](int r0, int rs, int rp, int ld) {
        asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the slice before is no longer read
        for (int i = ct; i < kWgBM * rp; i += 256) {
          const int r = i / rp, j = i - r * rp;
          u_s[r * ld + j] = (m0 + r < m && j < rs) ? u[static_cast<int64_t>(m0 + r) * rank + r0 + j] : TOut(0.f);
        }
        for (int i = ct; i < rp * BN; i += 256) {
          const int j = i / BN, col = i - j * BN;  // consecutive threads read consecutive columns of b
          bt_s[col * ld + j] = (n0 + col < n && j < rs) ? b[static_cast<int64_t>(r0 + j) * n + n0 + col] : TOut(0.f);
        }
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        staged = r0;
      };
#pragma unroll
      for (int q = 0; q < BN / kEpiCols; ++q) {
        constexpr int kNI = kEpiCols / 8;
        float lt[kNI][4];  // the rank-r term of this chunk's outputs, in the layout of acc
        if constexpr (LORA) {
#pragma unroll
          for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) lt[ni][e] = 0.f;
          for (int r0 = 0; r0 < rank; r0 += kRankSlice) {  // the sums keep the order of the mma.sync kernel's
            const int rs = min(kRankSlice, rank - r0);
            const int rp = (rs + 15) & ~15;
            const int ld = rp + 4 / static_cast<int>(sizeof(TOut));
            if (staged != r0) stage(r0, rs, rp, ld);
            if constexpr (sizeof(TOut) == 2) {
              for (int kk = 0; kk < rp; kk += 16) {
                uint32_t ua[4];
                ua[0] = *reinterpret_cast<const uint32_t*>(u_s + rl0 * ld + kk + 2 * c4);
                ua[1] = *reinterpret_cast<const uint32_t*>(u_s + (rl0 + 8) * ld + kk + 2 * c4);
                ua[2] = *reinterpret_cast<const uint32_t*>(u_s + rl0 * ld + kk + 8 + 2 * c4);
                ua[3] = *reinterpret_cast<const uint32_t*>(u_s + (rl0 + 8) * ld + kk + 8 + 2 * c4);
#pragma unroll
                for (int ni = 0; ni < kNI; ++ni) {
                  const TOut* bcol = bt_s + (q * kEpiCols + ni * 8 + g) * ld + kk + 2 * c4;
                  mma_bf16(lt[ni], ua, *reinterpret_cast<const uint32_t*>(bcol), *reinterpret_cast<const uint32_t*>(bcol + 8));
                }
              }
            } else {
#pragma unroll
              for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const TOut* urow = u_s + (rl0 + 8 * (e >> 1)) * ld;
                  const TOut* bcol = bt_s + (q * kEpiCols + ni * 8 + 2 * c4 + (e & 1)) * ld;
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
          for (int ni = 0; ni < kNI; ++ni) {
            const int col = n0 + q * kEpiCols + ni * 8 + 2 * c4;
            float vals[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float y = __fmul_rn(__int2float_rn(acc[4 * (q * kNI + ni) + 2 * h + e]), srow);
              if (sn != nullptr) y = __fmul_rn(y, (col + e < n) ? sn[col + e] : 0.f);
              if constexpr (LORA) y = __fadd_rn(y, round_to(lt[ni][2 * h + e], TOut()));
              vals[e] = y;
            }
            TOut* dst = out + static_cast<int64_t>(row) * n + col;
            if (vec_ok && col + 2 <= n) {
              store_vals<TOut, 2>(dst, vals);
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (col + e < n) store_one(dst + e, vals[e]);
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. nt at M <= 64: split contraction, exact int32 reduction in one launch
// ---------------------------------------------------------------------------

constexpr int kSkBM = 64;        // rows: all of M
constexpr int kSkBK = 64;        // contraction bytes of a stage
constexpr int kSkStages = 3;
constexpr int kSkThreads = 128;  // 4 warps, 16 rows each, all BN columns

// Grid (column tiles, splits). ws: int32 [m, n], zero between calls; counters: int32, one a column tile, zero
// between calls.
template <int BN, typename TOut>
__global__ void __launch_bounds__(kSkThreads)
int8_mm_splitk_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w, const float* __restrict__ sx,
                      const float* __restrict__ sn, TOut* __restrict__ out, int* __restrict__ ws,
                      int* __restrict__ counters, int m, int n, int kc, int chunk, int splits, int a_aligned,
                      int b_aligned) {
  constexpr int kNI = BN / 8;
  constexpr int kABytes = kSkBM * kSkBK;
  constexpr int kStageBytes = kABytes + BN * kSkBK;
  __shared__ __align__(128) int8_t smem[kSkStages * kStageBytes];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.y * chunk, k_end = min(kc, k_begin + chunk);
  const int nk = (k_end - k_begin + kSkBK - 1) / kSkBK;

  auto load_stage = [&](int stage, int kt) {
    int8_t* a_s = smem + stage * kStageBytes;
    int8_t* b_s = a_s + kABytes;
    const int k0 = k_begin + kt * kSkBK;
    for (int i = tid; i < kSkBM * (kSkBK / 16); i += kSkThreads) {
      const int r = i >> 2, c = i & 3;
      load_chunk(a_s + swz64(r, c), xq, r, m, k0 + c * 16, k_end, kc, a_aligned);
    }
    for (int i = tid; i < BN * (kSkBK / 16); i += kSkThreads) {
      const int r = i >> 2, c = i & 3;
      load_chunk(b_s + swz64(r, c), w, n0 + r, n, k0 + c * 16, k_end, kc, b_aligned);
    }
  };

  int acc[kNI][4];
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0;
  for (int s = 0; s < kSkStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kSkStages - 2));
    __syncthreads();
    if (kt + kSkStages - 1 < nk) load_stage((kt + kSkStages - 1) % kSkStages, kt + kSkStages - 1);
    cp_async_commit();
    const int8_t* a_s = smem + (kt % kSkStages) * kStageBytes;
    const uint32_t a_base = smem_u32(a_s), b_base = smem_u32(a_s + kABytes);
#pragma unroll
    for (int ks = 0; ks < kSkBK; ks += 32) {
      uint32_t af[4];
      ldmatrix_x4(af, a_base + swz64(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, (ks >> 4) + (lane >> 4)));
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) {
        uint32_t t[4];
        ldmatrix_x4(t, b_base + swz64(nj * 16 + (lane & 7) + (lane >> 4) * 8, (ks >> 4) + ((lane >> 3) & 1)));
        mma_s8(acc[2 * nj], af, t[0], t[1]);
        mma_s8(acc[2 * nj + 1], af, t[2], t[3]);
      }
    }
  }
  cp_async_wait_all();

  // This range's partial sums into the workspace (rows and columns past the edge hold zeros: skipped).
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = warp * 16 + g + 8 * (e >> 1), col = n0 + ni * 8 + 2 * c4 + (e & 1);
      if (row < m && col < n)
        asm volatile("red.global.add.s32 [%0], %1;\n" ::"l"(ws + static_cast<int64_t>(row) * n + col), "r"(acc[ni][e])
                     : "memory");
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();  // every range's sums are in the workspace

  // The last block: the epilogue of the whole sums, four columns of a row at a time, every load of the
  // tile issued before the first store (one round trip to L2); then zero the tile for the next call.
  constexpr int kGroups = BN / 4;                      // 4-column groups of a row
  constexpr int kPer = kSkBM * kGroups / kSkThreads;   // groups a thread
  const bool vec_ok = (n % 4 == 0);
  int4 sums[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int i = tid + t * kSkThreads, row = i / kGroups, col = n0 + 4 * (i % kGroups);
    const int* src = ws + static_cast<int64_t>(row) * n + col;
    if (row >= m || col >= n) {
      sums[t] = make_int4(0, 0, 0, 0);
    } else if (vec_ok) {
      sums[t] = __ldcg(reinterpret_cast<const int4*>(src));
    } else {
      sums[t] = make_int4(__ldcg(src), col + 1 < n ? __ldcg(src + 1) : 0, col + 2 < n ? __ldcg(src + 2) : 0,
                          col + 3 < n ? __ldcg(src + 3) : 0);
    }
  }
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int i = tid + t * kSkThreads, row = i / kGroups, col = n0 + 4 * (i % kGroups);
    if (row >= m || col >= n) continue;
    const int acc[4] = {sums[t].x, sums[t].y, sums[t].z, sums[t].w};
    const float srow = sx[row];
    float vals[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = __fmul_rn(__int2float_rn(acc[e]), srow);
      if (sn != nullptr) y = __fmul_rn(y, (col + e < n) ? sn[col + e] : 0.f);
      vals[e] = y;
    }
    TOut* dst = out + static_cast<int64_t>(row) * n + col;
    int* src = ws + static_cast<int64_t>(row) * n + col;
    if (vec_ok) {
      store_vals<TOut, 4>(dst, vals);
      __stcg(reinterpret_cast<int4*>(src), make_int4(0, 0, 0, 0));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < n) {
          store_one(dst + e, vals[e]);
          __stcg(src + e, 0);
        }
    }
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}
