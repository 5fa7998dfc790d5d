"""LoRA: low-rank adaptation for the Gemma projections and the gated FFN, PyTorch.

Counterpart of ``kai0_tpu/models/lora.py``. The factors keep the JAX package's
per-layer shapes, so that they cross between the packages as they are: the
attention factors are **per head** (q: ``[N, D, r]`` and ``[N, r, H]``; kv:
``[2, K, D, r]`` and ``[2, K, r, H]``; out: ``[N, H, r]`` and ``[N, r, D]``,
from the einsum equations below), not one rank-r pair over the flattened
projection; the FFN's are ``[2, D, r]`` / ``[2, r, F]`` (gate, up) and
``[F, r]`` / ``[r, D]`` (down). The reference quirk is kept: the FFN terms
carry **no** alpha/rank scaling, the einsum terms do.

The base weights are ``nn.Linear`` layers (``[out, in]``), frozen int8
``QuantLinear`` holders, or ``SwitchBackLinear`` layers (int8 products over
weights that train); each projection dispatches on which it is
(``ops/quant.product``), and a LoRA term is added after the base product.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch
from torch import nn
import torch.nn.functional as F

from kai0_tpu_torch.ops import quant as _quant


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int
    alpha: float = 1.0
    # stddev of the normal init for lora params.
    init_stddev: float = 0.01
    # Rank-stabilized LoRA (https://arxiv.org/pdf/2312.03732).
    rslora: bool = False
    # Axes of the base weight to factorize (the last two).
    axes: tuple[int, int] = (-2, -1)
    # Einsum label for the rank axis; must not appear in the base equation.
    label: str = "L"

    @property
    def scaling_value(self) -> float:
        return self.alpha / math.sqrt(self.rank) if self.rslora else self.alpha / self.rank


def lora_shapes(shape: tuple[int, ...], config: LoRAConfig) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Shapes of (lora_a, lora_b) for a base einsum weight of ``shape`` (``init_einsum``)."""
    shape_a, shape_b = list(shape), list(shape)
    shape_a[config.axes[1]] = config.rank
    shape_b[config.axes[0]] = config.rank
    return tuple(shape_a), tuple(shape_b)


def make_lora_eqns(eqn: str, config: LoRAConfig) -> tuple[str, str]:
    """The two einsum equations of the low-rank term, derived from the base equation."""
    if config.label in eqn:
        raise ValueError(f"{config.label} already in eqn: {eqn}")
    if not (m := re.match("(.*),(.*)->(.*)", eqn)):
        raise ValueError(f"Unsupported einsum eqn: {eqn}")
    lhs, rhs, out = m.groups()
    a_label, b_label = (rhs[x] for x in config.axes)
    label = config.label
    a_rhs = rhs.replace(b_label, label)
    a_out = out.replace(b_label, label)
    eqn_a = f"{lhs},{a_rhs}->{a_out}"
    b_rhs = rhs.replace(a_label, label)
    eqn_b = f"{a_out},{b_rhs}->{out}"
    return eqn_a, eqn_b


def _letters(eqn: str) -> str:
    """torch.einsum takes letters only: a digit label (a stacked axis, ``2``) becomes a free lower-case letter."""
    free = iter(c for c in "zyxwvu" if c not in eqn)
    for digit in sorted(set(re.findall(r"\d", eqn))):
        eqn = eqn.replace(digit, next(free))
    return eqn


def linear(x: torch.Tensor, layer: nn.Linear | _quant.QuantLinear) -> torch.Tensor:
    """``x [..., in] -> [..., out]`` in x's dtype, by the layer's route (``ops.quant.product``)."""
    return _quant.product(x, layer)


def apply_einsum(base: torch.Tensor, eqn: str, x: torch.Tensor, lora_a, lora_b, config: LoRAConfig | None):
    """``base`` (the einsum of ``eqn`` over x and the base weight) plus the scaled low-rank term.

    ``lora_a`` / ``lora_b`` are the per-head factors of ``lora_shapes`` or
    None; the term is computed in x's dtype, as ``kai0_tpu.models.lora.apply_einsum``.
    """
    if config is None or lora_a is None:
        return base
    eqn_a, eqn_b = (_letters(e) for e in make_lora_eqns(eqn, config))
    lora = torch.einsum(eqn_a, x, lora_a.to(x.dtype))
    lora = torch.einsum(eqn_b, lora, lora_b.to(x.dtype))
    return base + lora * config.scaling_value


def apply_ffn(mlp: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Gated-GELU FFN with optional (unscaled, reference-parity) LoRA terms.

    ``mlp`` has ``gate_proj``, ``up_proj``, ``down_proj`` (``nn.Linear``,
    ``QuantLinear`` or ``SwitchBackLinear``) and, with LoRA,
    ``gating_lora_a [2, D, r]``, ``gating_lora_b [2, r, F]``,
    ``linear_lora_a [F, r]``, ``linear_lora_b [r, D]``. All three quantized
    (and not weight-only): the fused op of ``ops.quant`` (K4a with LoRA, K4b
    without). All three SwitchBack, without LoRA and not weight-only: the
    fused SwitchBack op (``sb_fused_ffn``). Otherwise each projection on its
    own, a quantized one taking its LoRA term in the product's epilogue.
    """

    def lora_term(x, lora_ab):
        a, b = lora_ab
        return (x @ a.to(x.dtype)) @ b.to(x.dtype)

    def dot(x, layer, lora_ab):
        if _quant.is_quant(layer):
            return _quant.linear(x, layer, add=None if lora_ab is None else lora_term(x, lora_ab))
        y = _quant.product(x, layer)
        return y if lora_ab is None else y + lora_term(x, lora_ab)

    ga, gb = getattr(mlp, "gating_lora_a", None), getattr(mlp, "gating_lora_b", None)
    la, lb = getattr(mlp, "linear_lora_a", None), getattr(mlp, "linear_lora_b", None)
    layers = (mlp.gate_proj, mlp.up_proj, mlp.down_proj)
    fused = not any(getattr(layer, "weight_only", False) for layer in layers)  # ``fused_ffn_enabled``
    if fused and all(_quant.is_quant(layer) for layer in layers) and (ga is None) == (la is None):
        lora_params = None if ga is None else (ga[0], gb[0], ga[1], gb[1], la, lb)
        return _quant.apply_fused_ffn(*layers, x, lora_params)
    if fused and all(_quant.is_switchback(layer) for layer in layers) and ga is None and la is None:
        return _quant.sb_fused_ffn(x, *(layer.weight for layer in layers))
    gate = dot(x, mlp.gate_proj, None if ga is None else (ga[0], gb[0]))
    up = dot(x, mlp.up_proj, None if ga is None else (ga[1], gb[1]))
    activations = F.gelu(gate, approximate="tanh") * up
    return dot(activations, mlp.down_proj, None if la is None else (la, lb))
