// K1 forward: masked multi-query attention for the Gemma experts.
//
// Replaces kai0_tpu/ops/pallas_attention.py `_mqa_fwd_kernel` / `_mqa_fwd_impl`
// (the forward of `flash_mha`): q [B,T,N,H] already RoPE'd and scaled, one K/V
// head k/v [B,S,1,H], bool mask [B,T,S] -> out [B,T,N,H] and lse f32 [B,T*N]
// (rows t-major, t*N+n, as the TPU kernel folds them).
//
// What bounds it on the H100 (N=8, H=256, bf16): operations. The training shape
// B=32, T=S=1018 is 4·T·N·S·H = 272 GFLOP a call (about half of it on unmasked
// pairs) against ~0.3 GB of q/k/v/mask/out; the serving prefill T=S=968 is
// ~770 FLOP/byte, the card's bf16 balance point ~295. The denoise shape T=50,
// S=1018 is near balance and small enough that the grid, not the card, is the
// limit: 400 query rows make only 7 row tiles of 64.
// What the design does about it:
//   * bf16 (flash_mqa_mma.cuh): both products on the tensor cores
//     (`mma.sync.m16n8k16`, f32 accumulation), operands by `ldmatrix` from
//     XOR-swizzled shared memory filled by `cp.async`, the online softmax and
//     the 16 x 256 output accumulator of each warp in registers, V's load
//     overlapping Q·Kᵀ and the next K's overlapping P·V;
//   * the 8 heads are folded into rows, so each K/V tile in shared memory serves
//     all 8 heads (the MQA saving the TPU kernel also takes);
//   * S is streamed in 64-key tiles with an online softmax: the TPU kernel keeps
//     the whole [rows, S] f32 logit block in VMEM, which 227 KB of shared memory
//     cannot hold;
//   * S is split across blocks (flash-decoding) until the grid covers ~2 waves of
//     the SMs, and a second kernel merges the splits: this is what keeps the
//     denoise shape from running on 7 SMs; one split writes the output directly;
//   * f32 inputs take the scalar-FMA kernel of flash_fwd.cuh (a choice by element
//     type: TF32 tensor cores would not hold the f32 checks' 1e-4).
#include "flash_mqa_mma.cuh"

extern "C" int kai0_flash_mqa_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
                                  void* lse, void* part_acc, void* part_ml, int batch, int t_len, int s_len,
                                  int heads, int head_dim, int splits, int chunk, int is_bf16, void* stream) {
  if (head_dim != 256 || mask == nullptr) return int(cudaErrorInvalidValue);
  if (is_bf16)
    return kai0::mqa_mma::fwd_entry<256>(q, k, v, mask, out, lse, part_acc, part_ml, batch, t_len, s_len, heads,
                                         splits, chunk, stream);
  return kai0::flash_fwd_entry<256>(q, k, v, mask, out, lse, part_acc, part_ml, batch, t_len, s_len, heads,
                                    splits, chunk, stream);
}
