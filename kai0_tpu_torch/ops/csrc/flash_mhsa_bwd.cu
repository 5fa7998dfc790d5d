// K2 backward: gradients of dense, unmasked multi-head attention for SigLIP.
//
// Replaces kai0_tpu/ops/pallas_attention.py `_mhsa_bwd_kernel` / `_mhsa_bwd_impl`
// (the backward of `flash_mhsa`): from head-major q/k/v [B,N,T,H] (q pre-scaled),
// the forward's out and lse [B,N,T] and dO, it writes dq, dk, dv [B,N,T,H]
// (dk/dv accumulated in f32, written once in k's type).
//
// What bounds it on the H100, at the So400m/14 training shapes (N=16,
// T=S=256, H=72, bf16, three cameras per sample): 10·T·S·N·H = 0.75 GFLOP
// per image per layer, 2.26 GFLOP per sample, >= 2.3 µs at the bf16 tensor core
// peak; ~1.3 MB of operands per image.
// What the design does about it (see flash_bwd.cuh):
//   * each (image, head) is one batch element of the shared backward
//     (heads = 1, no mask): 8 key tiles x 48 heads per sample for dK/dV and
//     4 row tiles x 48 heads for dQ, enough blocks to fill the SMs at batch 1;
//   * head_dim 72 is kept as 72 columns in shared memory (rows padded to 73
//     floats), the fifth column group of each thread masks its 8 spare lanes,
//     as in the forward. Nothing is padded in device memory;
//   * scalar f32 FMAs, as the forward (a first, simple kernel).
#include "flash_bwd.cuh"

extern "C" int kai0_flash_mhsa_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
                                   const void* lse, void* delta, void* dq, void* dk, void* dv, int batch_heads,
                                   int t_len, int s_len, int head_dim, int is_bf16, void* stream) {
  if (head_dim != 72) return int(cudaErrorInvalidValue);
  return kai0::flash_bwd_entry<72>(q, k, v, nullptr, out, dout, lse, delta, dq, dk, dv, batch_heads, t_len, s_len, 1,
                                   is_bf16, stream);
}
