// K2 forward: dense, unmasked multi-head attention for the SigLIP encoder.
//
// Replaces kai0_tpu/ops/pallas_attention.py `_mhsa_fwd_kernel` / `_mhsa_fwd_impl`
// (the forward of `flash_mhsa`): head-major q/k/v [B,N,T,H] with q pre-scaled by
// the caller -> out [B,N,T,H] and lse f32 [B,N,T].
//
// What bounds it on the H100, at the So400m/14 shapes (N=16, T=S=256, H=72, bf16,
// three cameras at batch 1 so B=3): 4·B·N·T·S·H = 0.91 GFLOP against ~3.5 MB of
// q/k/v/out, ~256 FLOP/byte — near the card's balance point, and 27 calls of a
// few microseconds each per request, so launch and grid shape matter as much as
// either roof.
// What the design does about it:
//   * each (image, head) is one "batch element" of the shared streaming kernel
//     (heads = 1): a block takes 64 query rows of one head and streams its K/V in
//     64-key tiles with an online softmax, with no mask;
//   * the key axis is split in two when that brings the grid (48 heads x 4 row
//     tiles = 192 blocks) nearer two waves of the SMs;
//   * head_dim 72 is not a multiple of 16 or 32: shared memory holds exactly 72
//     columns (rows padded to 73 floats against bank conflicts, not to 80 or 128),
//     and the P·V step masks the 8 spare lanes of its fifth column group
//     (ceil(72/16) = 5). Nothing is padded in device memory.
#include "flash_fwd.cuh"

extern "C" int kai0_flash_mhsa_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                                   void* part_acc, void* part_ml, int batch_heads, int t_len, int s_len,
                                   int head_dim, int splits, int chunk, int is_bf16, void* stream) {
  if (head_dim != 72) return int(cudaErrorInvalidValue);
  return kai0::flash_fwd_entry<72>(q, k, v, nullptr, out, lse, part_acc, part_ml, batch_heads, t_len, s_len, 1,
                                   splits, chunk, is_bf16, stream);
}
