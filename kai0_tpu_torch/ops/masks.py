"""Attention-mask and positional-embedding primitives.

Counterpart of ``kai0_tpu/ops/masks.py``. The frequency tables are computed the
way XLA computes them (an f32 ``linspace`` as iota times a rounded reciprocal,
``pow`` rounded from float64), so that positions near 10³ give the same angles
in both packages rather than angles one f32 ulp of the table apart.
"""

from __future__ import annotations

import math

import torch


def make_attn_mask(input_mask: torch.Tensor, mask_ar) -> torch.Tensor:
    """``bool[B, T, T]`` mask: a token attends to valid tokens whose cumulative
    ``mask_ar`` is <= its own (see ``kai0_tpu.ops.masks.make_attn_mask``).

    Args:
      input_mask: bool[B, N], True for real tokens, False for padding.
      mask_ar: bool-ish[?B, N], True where a token starts a new attention block.
    """
    mask_ar = torch.as_tensor(mask_ar, device=input_mask.device).broadcast_to(input_mask.shape)
    cumsum = torch.cumsum(mask_ar.to(torch.int32), dim=1)
    attn_mask = cumsum[:, None, :] <= cumsum[:, :, None]
    valid_mask = input_mask[:, None, :] & input_mask[:, :, None]
    return attn_mask & valid_mask


def _linspace01(num: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, num)`` bit for bit: iota times the f32 reciprocal, exact endpoint."""
    step = torch.arange(num - 1, dtype=torch.float32, device=device) * torch.tensor(
        1.0 / (num - 1), dtype=torch.float32
    )
    return torch.cat([step, torch.ones(1, dtype=torch.float32, device=device)])


def posemb_sincos(pos: torch.Tensor, embedding_dim: int, min_period: float, max_period: float) -> torch.Tensor:
    """Sine-cosine embedding of scalar positions ``pos: f32[b]`` -> ``f32[b, d]``."""
    if embedding_dim % 2 != 0:
        raise ValueError(f"embedding_dim ({embedding_dim}) must be divisible by 2")
    fraction = _linspace01(embedding_dim // 2, pos.device)
    period = min_period * ((max_period / min_period) ** fraction.double()).float()
    sinusoid_input = pos.float()[:, None] * (1.0 / period * 2 * math.pi)[None, :]
    return torch.cat([torch.sin(sinusoid_input), torch.cos(sinusoid_input)], dim=-1)


def apply_rope(x: torch.Tensor, *, positions: torch.Tensor, max_wavelength: float = 10_000) -> torch.Tensor:
    """RoPE for ``x: [B, L, H, D]`` with ``positions: [B, L]``; computed in f32, cast back."""
    freq_exponents = (2.0 / x.shape[-1]) * torch.arange(x.shape[-1] // 2, dtype=torch.float32, device=x.device)
    timescale = (max_wavelength ** freq_exponents.double()).float()
    radians = positions[..., None].float() / timescale[None, None, :]
    radians = radians[..., None, :]
    sin, cos = torch.sin(radians), torch.cos(radians)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    res = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return res.to(x.dtype)
