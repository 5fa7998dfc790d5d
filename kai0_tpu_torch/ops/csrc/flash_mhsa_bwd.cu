// K2 backward: gradients of dense, unmasked multi-head attention for SigLIP.
//
// Replaces kai0_tpu/ops/pallas_attention.py `_mhsa_bwd_kernel` / `_mhsa_bwd_impl`
// (the backward of `flash_mhsa`): from head-major q/k/v [B,N,T,H] (q pre-scaled),
// the forward's out and lse [B,N,T] and dO, it writes dq, dk, dv [B,N,T,H]
// (dk/dv accumulated in f32, written once in k's type).
//
// What bounds it on the H100, at the So400m/14 training shape (N=16,
// T=S=256, H=72, bf16, B=96 for three cameras of 32 samples): 10·B·N·T·S·H =
// 72.5 GFLOP of its five products (0.073 ms at the bf16 tensor-core peak)
// against 455 MB of operands (0.136 ms at 3.35 TB/s): bytes, by a factor of two.
// What the design does about it:
//   * bf16 (flash_mhsa_mma.cuh): every product on the tensor cores
//     (`mma.sync`, f32 accumulation) from 144-byte shared-memory rows filled by
//     `cp.async` and read by `ldmatrix` / `ldmatrix.trans`; the next Q/dO tile
//     (dK/dV kernel) or K/V tile (dQ kernel) loads while the current one is
//     multiplied;
//   * no atomics, so two calls give the same bits: a block owns 64 keys of one
//     (image, head) and loops over its 256 rows for dK/dV (2 x 64 x 72 f32
//     accumulators over 8 warps' registers, 36 a thread), and a second kernel
//     owns 64 rows and loops over the keys for dQ; the four blocks of one
//     (image, head) read the same 74 KB of Q and dO (or K and V), which L2
//     serves after the first; S and dP are recomputed (7 products for 5);
//   * f32 inputs take the scalar-FMA kernels of flash_bwd.cuh (a choice by
//     element type, as in the forward).
#include "flash_mhsa_mma.cuh"

extern "C" int kai0_flash_mhsa_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
                                   const void* lse, void* delta, void* dq, void* dk, void* dv, int batch_heads,
                                   int t_len, int s_len, int head_dim, int is_bf16, void* stream) {
  if (head_dim != 72) return int(cudaErrorInvalidValue);
  if (is_bf16)
    return kai0::mhsa_mma::bwd_entry<72>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch_heads, t_len, s_len,
                                         stream);
  return kai0::flash_bwd_entry<72>(q, k, v, nullptr, out, dout, lse, delta, dq, dk, dv, batch_heads, t_len, s_len, 1,
                                   stream);
}
