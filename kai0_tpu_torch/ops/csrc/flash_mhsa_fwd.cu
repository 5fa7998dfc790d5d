// K2 forward: dense, unmasked multi-head attention for the SigLIP encoder.
//
// Replaces kai0_tpu/ops/pallas_attention.py `_mhsa_fwd_kernel` / `_mhsa_fwd_impl`
// (the forward of `flash_mhsa`): head-major q/k/v [B,N,T,H] with q pre-scaled by
// the caller -> out [B,N,T,H] and lse f32 [B,N,T].
//
// What bounds it on the H100, at the So400m/14 shapes (N=16, T=S=256, H=72,
// bf16; B = 3 cameras x samples): bytes. 4·B·N·T·S·H is 0.30 GFLOP per image
// against 2.4 MB of q/k/v/out/lse, ~127 FLOP/byte, under the card's bf16
// balance point of ~295: at the training shape B=96 the bound is 0.068 ms of
// bytes against 0.029 ms of operations. A serving request (B=3) is 27 calls of a
// few microseconds each, so launch and grid shape matter as much as either roof.
// What the design does about it:
//   * bf16 (flash_mhsa_mma.cuh): both products on the tensor cores
//     (`mma.sync.m16n8k16` plus one m16n8k8 step for columns 64-71, f32
//     accumulation), operands by `ldmatrix` from 144-byte shared-memory rows
//     filled by `cp.async` straight from the unpadded [.., 72] tensors; a block
//     takes 64 query rows of one (image, head) and streams its K/V in
//     double-buffered 64-key tiles with an online softmax; the output stays in
//     registers and is written once with the lse (no split, no combine, no
//     workspace); four 46 KB blocks share an SM;
//   * f32 inputs take the scalar-FMA kernel of flash_fwd.cuh (a choice by element
//     type: TF32 tensor cores would not hold the f32 checks' 1e-4): each (image,
//     head) is one batch element of the shared streaming kernel, the key axis
//     split when that brings the grid nearer two waves of the SMs, shared memory
//     rows padded to 73 floats and the fifth 16-column group masked to 72.
#include "flash_mhsa_mma.cuh"

extern "C" int kai0_flash_mhsa_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                                   void* part_acc, void* part_ml, int batch_heads, int t_len, int s_len,
                                   int head_dim, int splits, int chunk, int is_bf16, void* stream) {
  if (head_dim != 72) return int(cudaErrorInvalidValue);
  if (is_bf16) {
    if (splits != 1) return int(cudaErrorInvalidValue);  // the tensor-core kernel never splits the key axis
    return kai0::mhsa_mma::fwd_entry<72>(q, k, v, out, lse, batch_heads, t_len, s_len, stream);
  }
  return kai0::flash_fwd_entry<72>(q, k, v, nullptr, out, lse, part_acc, part_ml, batch_heads, t_len, s_len, 1,
                                   splits, chunk, stream);
}
