// K1 forward: masked multi-query attention for the Gemma experts.
//
// Replaces kai0_tpu/ops/pallas_attention.py `_mqa_fwd_kernel` / `_mqa_fwd_impl`
// (the forward of `flash_mha`): q [B,T,N,H] already RoPE'd and scaled, one K/V
// head k/v [B,S,1,H], bool mask [B,T,S] -> out [B,T,N,H] and lse f32 [B,T*N]
// (rows t-major, t*N+n, as the TPU kernel folds them).
//
// What bounds it on the H100, at the π₀.₅ serving shapes (N=8, H=256, bf16):
//   * prefill T=S=968: 4·T·N·S·H = 7.7 GFLOP against ~10 MB of q/k/v/mask/out,
//     ~770 FLOP/byte — compute-bound (the card's bf16 balance point is ~295);
//   * denoise T=50, S=1018: 0.42 GFLOP against ~1.5 MB — near balance, and small
//     enough that the grid, not the card, is the limit: 400 query rows make only
//     7 row tiles of 64.
// What the design does about it:
//   * the 8 heads are folded into rows, so each K/V tile loaded into shared memory
//     serves all 8 heads (the MQA saving the TPU kernel also takes);
//   * S is streamed in 64-key tiles with an online softmax: the TPU kernel keeps
//     the whole [rows, S] f32 logit block in VMEM, which 227 KB of shared memory
//     cannot hold;
//   * S is split across blocks (flash-decoding) until the grid covers ~2 waves of
//     the SMs, and a second kernel merges the splits — this is what keeps the
//     denoise shape from running on 7 SMs;
//   * the products are scalar f32 FMAs (a first, simple kernel). Tensor cores
//     (mma/wgmma) and TMA are the next step; they are what the prefill needs.
#include "flash_fwd.cuh"

extern "C" int kai0_flash_mqa_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
                                  void* lse, void* part_acc, void* part_ml, int batch, int t_len, int s_len,
                                  int heads, int head_dim, int splits, int chunk, int is_bf16, void* stream) {
  if (head_dim != 256 || mask == nullptr) return int(cudaErrorInvalidValue);
  return kai0::flash_fwd_entry<256>(q, k, v, mask, out, lse, part_acc, part_ml, batch, t_len, s_len, heads,
                                    splits, chunk, is_bf16, stream);
}
