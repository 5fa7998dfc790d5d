// K1 backward: gradients of masked multi-query attention for the Gemma experts.
//
// Replaces kai0_tpu/ops/pallas_attention.py `_mqa_bwd_kernel` / `_mqa_bwd_impl`
// (the backward of `flash_mha`): from q [B,T,N,H], k/v [B,S,1,H], bool mask
// [B,T,S], the forward's out and lse [B,T*N] and dO, it writes dq [B,T,N,H] and
// dk/dv [B,S,1,H] (accumulated in f32, written once in k's type).
//
// What bounds it on the H100, at the π₀.₅ training shape (T=S=1018, N=8,
// H=256, bf16): the five products of the flash backward are 10·T·S·N·H =
// 21.2 GFLOP per sample per layer, >= 21.4 µs at the 989 TFLOP/s bf16 tensor
// core peak, against ~8 MB of operands: compute-bound by far.
// What the design does about it:
//   * bf16 (flash_mqa_mma.cuh): every product on the tensor cores
//     (`mma.sync.m16n8k16`, f32 accumulation) from XOR-swizzled shared-memory
//     tiles filled by `cp.async` and read by `ldmatrix` / `ldmatrix.trans`; the
//     next Q/dO (dK/dV kernel) or K/V tile (dQ kernel) loads while the current
//     one is multiplied;
//   * the 8 heads are folded into rows, so every K/V tile serves all 8 heads and
//     dK/dV sum over the heads inside the accumulator, as on the TPU;
//   * no atomics, so two calls give the same bits: a block owns 64 keys and loops
//     over all T·8 rows for dK/dV (2 x 64 x 256 f32 accumulators spread over 8
//     warps' registers), and a second kernel owns 64 rows and loops over the
//     keys for dQ. This recomputes S and dP once more (7 products for 5). At
//     batch 2 the dK/dV grid is only B·⌈S/64⌉ = 32 blocks for 132 SMs;
//   * f32 inputs take the scalar-FMA kernels of flash_bwd.cuh (a choice by
//     element type, as in the forward).
#include "flash_mqa_mma.cuh"

extern "C" int kai0_flash_mqa_bwd(const void* q, const void* k, const void* v, const void* mask, const void* out,
                                  const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                                  int batch, int t_len, int s_len, int heads, int head_dim, int is_bf16,
                                  void* stream) {
  if (head_dim != 256 || mask == nullptr) return int(cudaErrorInvalidValue);
  if (is_bf16)
    return kai0::mqa_mma::bwd_entry<256>(q, k, v, mask, out, dout, lse, delta, dq, dk, dv, batch, t_len, s_len,
                                         heads, stream);
  return kai0::flash_bwd_entry<256>(q, k, v, mask, out, dout, lse, delta, dq, dk, dv, batch, t_len, s_len, heads,
                                    stream);
}
