"""Two-expert Gemma stack with joint attention, PyTorch.

Counterpart of ``kai0_tpu/models/gemma.py:182-427``; the projections and the
gated FFN go through ``kai0_tpu_torch.models.lora``, which adds the LoRA terms of
the ``*_lora`` variants and dispatches on whether a base weight is a
``nn.Linear`` or a frozen int8 ``QuantLinear``. Each expert is a ``GemmaModel`` in the
HF layout the ``PI0Pytorch`` state dict uses (``layers.{i}.self_attn.q_proj``,
``mlp.gate_proj``, ``input_layernorm``, ``norm``; the PaliGemma expert also owns
``embed_tokens``). ``apply`` runs layer i of every expert together: tokens of
each expert get their own projections, norms and FFN, but attend jointly over
the concatenated sequence.

Numerics: RMSNorm variance in f32, eps 1e-6, ``x·(1+w)``; adaRMS modulation in
the activation dtype with gated residuals; RoPE in f32 on q and k, then q scaled
by ``head_dim**-0.5``; embedding scaled by √width; GeGLU with tanh gelu.

With gradients on and ``remat=True`` (the JAX default policy ``nothing``,
``gemma.py:327-384``), each block runs under ``torch.utils.checkpoint``: the
backward recomputes the block from its inputs, so attention's forward kernel
runs twice per layer and step. ``remat=False`` is JAX's ``none``.
"""

from __future__ import annotations

from collections.abc import Sequence
import dataclasses
import math

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kai0_tpu_torch.models import lora as _lora
from kai0_tpu_torch.ops import attention as _attention
from kai0_tpu_torch.ops import masks as _masks

PALIGEMMA_VOCAB_SIZE = 257_152


@dataclasses.dataclass(frozen=True)
class Config:
    width: int
    depth: int
    mlp_dim: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    lora_attn: _lora.LoRAConfig | None = None
    lora_ffn: _lora.LoRAConfig | None = None


def _with_lora(config: Config, rank: int) -> Config:
    lora = _lora.LoRAConfig(rank=rank, alpha=float(rank))
    return dataclasses.replace(config, lora_attn=lora, lora_ffn=lora)


_VARIANTS = {
    "dummy": Config(width=64, depth=4, mlp_dim=128, num_heads=8, num_kv_heads=1, head_dim=16),
    "gemma_300m": Config(width=1024, depth=18, mlp_dim=4096, num_heads=8, num_kv_heads=1, head_dim=256),
    "gemma_2b": Config(width=2048, depth=18, mlp_dim=16_384, num_heads=8, num_kv_heads=1, head_dim=256),
}
_VARIANTS.update({
    "dummy_lora": _with_lora(_VARIANTS["dummy"], 4),  # test size: the freeze filter and the int8 base on the CPU
    "gemma_300m_lora": _with_lora(_VARIANTS["gemma_300m"], 32),
    "gemma_2b_lora": _with_lora(_VARIANTS["gemma_2b"], 16),
})


def get_config(variant: str) -> Config:
    """Gemma variant table (``kai0_tpu.models.gemma.get_config``)."""
    if variant not in _VARIANTS:
        raise ValueError(f"Unknown variant: {variant}")
    return _VARIANTS[variant]


class RMSNorm(nn.Module):
    def __init__(self, width: int, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(width, **factory))


class AdaRMSNorm(nn.Module):
    """adaRMS: ``dense`` maps the conditioning vector to scale, shift and gate."""

    def __init__(self, width: int, **factory):
        super().__init__()
        self.dense = nn.Linear(width, 3 * width, **factory)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    y = x @ layer.weight.to(x.dtype).T
    return y if layer.bias is None else y + layer.bias.to(x.dtype)


def rms_norm(norm: RMSNorm | AdaRMSNorm, x: torch.Tensor, cond: torch.Tensor | None):
    """RMSNorm / adaRMSNorm. Returns (normed, gate); gate is None without conditioning."""
    dtype = x.dtype
    var = x.float().square().mean(dim=-1, keepdim=True)
    normed = x * torch.reciprocal(torch.sqrt(var + 1e-06))  # promotes to f32
    if cond is None:
        if not isinstance(norm, RMSNorm):
            raise ValueError("adaRMS norm params but no conditioning vector provided")
        # 1 + w in f32 whatever w is stored in: jitted JAX keeps the sum's precision for a bf16 (frozen) scale,
        # and rounding it to bf16 here moved the gradients by 1% against it.
        return (normed * (1 + norm.weight.to(torch.float32))).to(dtype), None
    modulation = _linear(cond.to(dtype), norm.dense)
    scale, shift, gate = torch.chunk(modulation[:, None, :], 3, dim=-1)
    normed = normed * (1 + scale) + shift
    return normed.to(dtype), gate


class Attention(nn.Module):
    def __init__(self, config: Config, **factory):
        super().__init__()
        self.config = config
        w, n, k, h = config.width, config.num_heads, config.num_kv_heads, config.head_dim
        self.q_proj = nn.Linear(w, n * h, bias=False, **factory)
        self.k_proj = nn.Linear(w, k * h, bias=False, **factory)
        self.v_proj = nn.Linear(w, k * h, bias=False, **factory)
        self.o_proj = nn.Linear(n * h, w, bias=False, **factory)
        if lora := config.lora_attn:
            # Per-head factors in the JAX package's shapes (``lora.init_einsum``); kv stacks K then V.
            for name, shape in (("q", (n, w, h)), ("kv", (2, k, w, h)), ("o", (n, h, w))):
                for ab, shp in zip("ab", _lora.lora_shapes(shape, lora), strict=True):
                    setattr(self, f"{name}_lora_{ab}", nn.Parameter(torch.zeros(shp, **factory)))

    def lora(self, name: str) -> tuple[torch.Tensor | None, torch.Tensor | None]:
        return getattr(self, f"{name}_lora_a", None), getattr(self, f"{name}_lora_b", None)


class FeedForward(nn.Module):
    def __init__(self, config: Config, **factory):
        super().__init__()
        d, f = config.width, config.mlp_dim
        self.gate_proj = nn.Linear(d, f, bias=False, **factory)
        self.up_proj = nn.Linear(d, f, bias=False, **factory)
        self.down_proj = nn.Linear(f, d, bias=False, **factory)
        if lora := config.lora_ffn:
            r = lora.rank
            self.gating_lora_a = nn.Parameter(torch.zeros((2, d, r), **factory))
            self.gating_lora_b = nn.Parameter(torch.zeros((2, r, f), **factory))
            self.linear_lora_a = nn.Parameter(torch.zeros((f, r), **factory))
            self.linear_lora_b = nn.Parameter(torch.zeros((r, d), **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _lora.apply_ffn(self, x)


class DecoderLayer(nn.Module):
    def __init__(self, config: Config, adarms: bool, **factory):
        super().__init__()
        norm = AdaRMSNorm if adarms else RMSNorm
        self.self_attn = Attention(config, **factory)
        self.mlp = FeedForward(config, **factory)
        self.input_layernorm = norm(config.width, **factory)
        self.post_attention_layernorm = norm(config.width, **factory)


class GemmaModel(nn.Module):
    """One expert: ``layers``, final ``norm`` and (for PaliGemma) ``embed_tokens``."""

    def __init__(self, config: Config, *, adarms: bool, embed: bool, **factory):
        super().__init__()
        self.config = config
        if embed:
            self.embed_tokens = nn.Embedding(PALIGEMMA_VOCAB_SIZE, config.width, **factory)
        self.layers = nn.ModuleList(DecoderLayer(config, adarms, **factory) for _ in range(config.depth))
        self.norm = (AdaRMSNorm if adarms else RMSNorm)(config.width, **factory)


def embed(model: GemmaModel, tokens: torch.Tensor, embed_dtype: torch.dtype) -> torch.Tensor:
    """Token embedding lookup scaled by sqrt(width)."""
    table = model.embed_tokens.weight
    x = F.embedding(tokens, table)
    x = x * torch.tensor(math.sqrt(table.shape[-1]), dtype=torch.float32).to(x.dtype)
    return x.to(embed_dtype)


def _attn(
    layers: Sequence[DecoderLayer],
    xs: Sequence[torch.Tensor | None],
    positions: torch.Tensor,
    attn_mask: torch.Tensor,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None,
):
    """Joint attention over the concatenated expert tokens. Returns (outputs, (k, v))."""
    config = layers[0].self_attn.config
    qs, ks, vs = [], [], []
    for x, layer in zip(xs, layers, strict=True):
        if x is None:
            continue
        attn, c = layer.self_attn, layer.self_attn.config
        b, t, _ = x.shape
        q = _lora.linear(x, attn.q_proj).view(b, t, c.num_heads, c.head_dim)
        if hasattr(attn, "kv_proj"):  # frozen int8: K and V are one quantized matrix, as JAX's stacked kv_einsum leaf
            k, v = _lora.linear(x, attn.kv_proj).view(b, t, 2, c.num_kv_heads, c.head_dim).unbind(dim=2)
        else:
            k, v = (_lora.linear(x, p).view(b, t, c.num_kv_heads, c.head_dim) for p in (attn.k_proj, attn.v_proj))
        qs.append(_lora.apply_einsum(q, "BTD,NDH->BTNH", x, *attn.lora("q"), c.lora_attn))
        if c.lora_attn is not None:
            k, v = _lora.apply_einsum(torch.stack([k, v]), "BSD,2KDH->2BSKH", x, *attn.lora("kv"), c.lora_attn)
        ks.append(k)
        vs.append(v)

    q = torch.cat(qs, dim=1)
    k = torch.cat(ks, dim=1)
    v = torch.cat(vs, dim=1)

    q = _masks.apply_rope(q, positions=positions)
    q = q * config.head_dim**-0.5
    k = _masks.apply_rope(k, positions=positions)

    if kv_cache is not None:
        cache_k, cache_v = kv_cache
        k = torch.cat([cache_k, k], dim=1)
        v = torch.cat([cache_v, v], dim=1)

    encoded = _attention.mha(q, k, v, attn_mask)

    out, start = [], 0
    for x, layer in zip(xs, layers, strict=True):
        if x is None:
            out.append(None)
            continue
        end = start + x.shape[1]
        attn, chunk = layer.self_attn, encoded[:, start:end]
        base = _lora.linear(chunk.reshape(*chunk.shape[:2], -1), attn.o_proj)
        out.append(_lora.apply_einsum(base, "BTNH,NHD->BTD", chunk, *attn.lora("o"), attn.config.lora_attn))
        start = end
    return out, (k, v)


def _gated_residual(x, y, gate):
    if x is None:
        return None
    if gate is None:
        return x + y
    return x + y * gate


def _block(layers, xs, kv_cache, positions, attn_mask, adarms_cond):
    """One transformer block over all experts."""
    pre_attn, gates = [], []
    for layer, x, cond in zip(layers, xs, adarms_cond, strict=True):
        gate = None
        if x is not None:
            x, gate = rms_norm(layer.input_layernorm, x, cond)
        pre_attn.append(x)
        gates.append(gate)

    post_attn, kv_cache = _attn(layers, pre_attn, positions, attn_mask, kv_cache)
    xs = [_gated_residual(x, y, g) for x, y, g in zip(xs, post_attn, gates, strict=True)]

    out, gates = [], []
    for layer, x, cond in zip(layers, xs, adarms_cond, strict=True):
        gate = None
        if x is not None:
            x, gate = rms_norm(layer.post_attention_layernorm, x, cond)
            x = layer.mlp(x)
        out.append(x)
        gates.append(gate)
    xs = [_gated_residual(x, y, g) for x, y, g in zip(xs, out, gates, strict=True)]
    return xs, kv_cache


def apply(
    experts: Sequence[GemmaModel],
    embedded: Sequence[torch.Tensor | None],
    positions: torch.Tensor,
    mask: torch.Tensor,
    adarms_cond: Sequence[torch.Tensor | None] | None = None,
    *,
    kv_cache: list[tuple[torch.Tensor, torch.Tensor]] | None = None,
    embed_dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
    return_kv_cache: bool = True,
):
    """Run the layer stack.

    Returns (per-expert outputs, per-layer KV cache [(k, v)], each [B,S,K,H]);
    the cache is None when ``return_kv_cache`` is False (training builds none).
    """
    xs = [e.to(embed_dtype) if e is not None else None for e in embedded]
    if adarms_cond is None:
        adarms_cond = [None] * len(experts)
    if mask.ndim == 3:
        mask = mask[:, None, :, :]
    depth = experts[0].config.depth
    if any(e.config.depth != depth for e in experts):
        raise ValueError("experts must have the same depth")

    def block(layers, xs, layer_cache):
        xs, layer_kv = _block(layers, xs, layer_cache, positions, mask, adarms_cond)
        return (xs, layer_kv) if return_kv_cache else (xs, None)

    recompute = remat and torch.is_grad_enabled()
    new_cache = []
    for i in range(depth):
        layers = [e.layers[i] for e in experts]
        layer_cache = None if kv_cache is None else kv_cache[i]
        if recompute:
            xs, layer_kv = checkpoint(block, layers, xs, layer_cache, use_reentrant=False)
        else:
            xs, layer_kv = block(layers, xs, layer_cache)
        new_cache.append(layer_kv)

    outs = []
    for expert, x, cond in zip(experts, xs, adarms_cond, strict=True):
        outs.append(None if x is None else rms_norm(expert.norm, x, cond)[0])
    return outs, (new_cache if return_kv_cache else None)
