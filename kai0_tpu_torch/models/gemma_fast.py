"""Single-expert Gemma with a fixed-size decode KV cache written in place (π₀-FAST), PyTorch.

Counterpart of ``kai0_tpu/models/gemma_fast.py``. The expert is the PaliGemma
``GemmaModel`` of ``gemma.py`` (with its embedding); the blocks are
``gemma.py``'s projections, norms and gated FFN (LoRA terms and int8 holders
included) around an attention that reads a preallocated cache.

Cache: ``KVCache`` holds k and v of every layer, ``[L, B, S_cache, K, H]`` in
the activation dtype, and ``idx``, the next write offset, which is the same
for every row (JAX reads ``idx[0]``). The prefill allocates it with the mask's
key length as capacity (the prefill tokens, then zeros), and each decode step
writes its token's k and v at ``idx`` by slice assignment, where JAX uses
``dynamic_update_slice``; nothing is concatenated, so every step attends over
the same ``S_cache`` keys, the mask's padding hiding the unwritten ones. In
training (``return_kv_cache=False``) no cache is made: the blocks attend over
their own k and v, and with gradients on and ``remat`` each block runs under
``torch.utils.checkpoint``.

Attention is ``ops.attention.mha``: on the card the MQA kernel K1f (8 query
heads over one K/V head of dim 256; the prefill's rows fold as ``t·8+n``, a
decode step's 8 rows against the whole cache), on the CPU its plain version.
JAX computes the same function as two einsums (``gemma_fast.py:59-67``): f32
logits, ``BIG_NEG`` masking, f32 softmax, probabilities cast to the
activation dtype before P·V.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from kai0_tpu_torch.models import gemma as _gemma
from kai0_tpu_torch.ops import attention as _attention
from kai0_tpu_torch.ops import masks as _masks

Config = _gemma.Config
get_config = _gemma.get_config
embed = _gemma.embed
decode_logits = _gemma.decode_logits


@dataclasses.dataclass
class KVCache:
    """k, v ``[L, B, S_cache, K, H]``; ``idx``: the next write offset (a host int, the same for every row)."""

    idx: int
    k: torch.Tensor
    v: torch.Tensor


def _block(layer: _gemma.DecoderLayer, x, positions, mask, cache: tuple[torch.Tensor, torch.Tensor] | None, idx: int):
    """One block; ``cache`` = this layer's (k, v) ``[B, S_cache, K, H]``, written at ``idx`` in place, or None."""
    attn = layer.self_attn
    normed, _ = _gemma.rms_norm(layer.input_layernorm, x, None)
    q, k, v = _gemma.project_qkv(attn, normed)
    q = _masks.apply_rope(q, positions=positions) * attn.config.head_dim**-0.5
    k = _masks.apply_rope(k, positions=positions)
    if cache is not None:
        cache[0][:, idx : idx + k.shape[1]] = k
        cache[1][:, idx : idx + v.shape[1]] = v
        k, v = cache
    else:  # the kernel takes contiguous k and v; the joint int8 holder and LoRA's stacked term give views
        k, v = k.contiguous(), v.contiguous()
    x = x + _gemma.project_out(attn, _attention.mha(q, k, v, mask))
    normed, _ = _gemma.rms_norm(layer.post_attention_layernorm, x, None)
    return x + layer.mlp(normed)


def apply(
    model: _gemma.GemmaModel,
    embedded: torch.Tensor,
    positions: torch.Tensor,
    mask: torch.Tensor,
    *,
    kv_cache: KVCache | None = None,
    embed_dtype: torch.dtype = torch.bfloat16,
    return_kv_cache: bool = True,
    remat: bool = True,
) -> tuple[torch.Tensor, KVCache | None]:
    """Run the stack; returns (prelogits [B, T, D] after the final norm, the cache or None).

    ``mask`` bool ``[B, T, S]`` (or ``[B, 1, T, S]``). Prefill (``kv_cache`` None,
    ``return_kv_cache``): a cache of capacity S (pad the mask's key axis to
    prefill + decode steps) holds the T tokens at ``[0, T)`` and ``idx`` = T.
    Decode: pass the cache back with T = 1; it is written at ``idx`` and
    returned with ``idx`` + T. Without a cache (training), S = T.
    """
    x = embedded.to(embed_dtype)
    if mask.ndim == 3:
        mask = mask[:, None]
    b, t = x.shape[:2]
    config = model.config
    if kv_cache is None and return_kv_cache:
        shape = (config.depth, b, mask.shape[-1], config.num_kv_heads, config.head_dim)
        kv_cache = KVCache(idx=0, k=x.new_zeros(shape), v=x.new_zeros(shape))
    recompute = remat and kv_cache is None and torch.is_grad_enabled()
    for i, layer in enumerate(model.layers):
        cache = None if kv_cache is None else (kv_cache.k[i], kv_cache.v[i])
        if recompute:
            x = checkpoint(_block, layer, x, positions, mask, None, 0, use_reentrant=False)
        else:
            x = _block(layer, x, positions, mask, cache, 0 if kv_cache is None else kv_cache.idx)
    prelogits, _ = _gemma.rms_norm(model.norm, x, None)
    if kv_cache is not None:
        kv_cache = dataclasses.replace(kv_cache, idx=kv_cache.idx + t)
    return prelogits, kv_cache
