"""Masked grouped-query attention and dense head-major attention.

Counterpart of ``kai0_tpu/ops/attention.py:89-198``: f32 logits, the Gemma
``BIG_NEG`` mask constant, f32 softmax, probabilities cast to the activation
dtype before P·V. ``mha_reference`` is the plain formulation; ``mha`` and
``mhsa_dense_hm`` route to the CUDA kernels in ``flash_attention`` (which take
the plain path for CPU tensors).
"""

from __future__ import annotations

import torch

from kai0_tpu_torch.ops import flash_attention as _flash

BIG_NEG = _flash.BIG_NEG

# q [B,T,N,H] RoPE'd and scaled, k/v [B,S,K,H], mask bool [B,T,S] or [B,1,T,S] -> [B,T,N,H].
mha_reference = _flash.flash_mha_plain


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
    """Attention for the Gemma experts: the MQA kernel (every π₀ Gemma variant has one KV head)."""
    return _flash.flash_mha(q, k, v, attn_mask)


def mhsa_dense_hm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense MHA in head-major layout [B, N, T, H], q pre-scaled: the SigLIP kernel."""
    return _flash.flash_mhsa(q, k, v)
