"""SigLIP ViT image encoder (So400m/14 for the π₀ family), PyTorch.

Counterpart of ``kai0_tpu/models/siglip.py:168-322``, head-major attention path
only. Module names follow the HF ``SiglipVisionModel`` layout that the
``PI0Pytorch`` state dict uses (``embeddings.patch_embedding``,
``encoder.layers.{i}.self_attn.q_proj``, ``mlp.fc1``, ``post_layernorm``); the
2048-wide ``head`` is PaliGemma's ``multi_modal_projector.linear``, which lives
outside the tower.

Numerics: patch embedding and posemb in f32 (an im2col matmul, so no TF32
convolution on the card); encoder body in the model dtype; LayerNorm upcasts to
f32 with eps 1e-6; MLP gelu is the tanh approximation (``jax.nn.gelu``'s default).
With gradients on and ``remat=True`` each encoder block runs under
``torch.utils.checkpoint`` (JAX's default ``nothing`` policy).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kai0_tpu_torch.ops import attention as _attention


@dataclasses.dataclass(frozen=True)
class Config:
    num_classes: int
    width: int = 1152
    depth: int = 27
    mlp_dim: int = 4304
    num_heads: int = 16
    patch_size: tuple[int, int] = (14, 14)
    dtype_mm: str = "float32"


_VARIANTS = {
    # width, depth, mlp_dim, num_heads — as kai0_tpu/models/siglip.py
    "mu": (32, 1, 128, 2),
    "Ti": (192, 12, 768, 3),
    "S": (384, 12, 1536, 6),
    "M": (512, 12, 2048, 8),
    "B": (768, 12, 3072, 12),
    "L": (1024, 24, 4096, 16),
    "So400m": (1152, 27, 4304, 16),
    "H": (1280, 32, 5120, 16),
}


def get_config(num_classes: int, variant: str = "So400m/14", dtype_mm: str = "float32") -> Config:
    v, patch = variant, {}
    if "/" in variant:
        v, p = variant.split("/")
        patch = {"patch_size": (int(p), int(p))}
    width, depth, mlp_dim, num_heads = _VARIANTS[v]
    return Config(
        num_classes=num_classes, width=width, depth=depth, mlp_dim=mlp_dim, num_heads=num_heads,
        dtype_mm=dtype_mm, **patch,
    )


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """x·Wᵀ, then the bias, each rounded in x's dtype (as the JAX einsum + add)."""
    return x @ layer.weight.to(x.dtype).T + layer.bias.to(x.dtype)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.rsqrt(var + 1e-6)
    return (normed * norm.weight + norm.bias).to(x.dtype)


class Embeddings(nn.Module):
    def __init__(self, config: Config, grid: int, **factory):
        super().__init__()
        ph, pw = config.patch_size
        self.patch_embedding = nn.Conv2d(3, config.width, (ph, pw), stride=(ph, pw), **factory)
        self.position_embedding = nn.Embedding(grid, config.width, **factory)


class Attention(nn.Module):
    def __init__(self, config: Config, **factory):
        super().__init__()
        w = config.width
        self.num_heads = config.num_heads
        self.q_proj = nn.Linear(w, w, **factory)
        self.k_proj = nn.Linear(w, w, **factory)
        self.v_proj = nn.Linear(w, w, **factory)
        self.out_proj = nn.Linear(w, w, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        n = self.num_heads

        def heads(y):  # [B,T,N·H] -> head-major [B,N,T,H], contiguous for the kernel
            return y.view(b, t, n, -1).permute(0, 2, 1, 3).contiguous()

        q, k, v = (heads(_linear(x, p)) for p in (self.q_proj, self.k_proj, self.v_proj))
        head_dim = q.shape[-1]
        encoded = _attention.mhsa_dense_hm(q * (1.0 / math.sqrt(head_dim)), k, v)
        return _linear(encoded.permute(0, 2, 1, 3).reshape(b, t, -1), self.out_proj)


class Mlp(nn.Module):
    def __init__(self, config: Config, **factory):
        super().__init__()
        self.fc1 = nn.Linear(config.width, config.mlp_dim, **factory)
        self.fc2 = nn.Linear(config.mlp_dim, config.width, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(F.gelu(_linear(x, self.fc1), approximate="tanh"), self.fc2)


class EncoderLayer(nn.Module):
    def __init__(self, config: Config, **factory):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(config.width, eps=1e-6, **factory)
        self.self_attn = Attention(config, **factory)
        self.layer_norm2 = nn.LayerNorm(config.width, eps=1e-6, **factory)
        self.mlp = Mlp(config, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(_layer_norm(self.layer_norm1, x))
        return x + self.mlp(_layer_norm(self.layer_norm2, x))


class Encoder(nn.Module):
    def __init__(self, config: Config, **factory):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(config, **factory) for _ in range(config.depth))


class VisionModel(nn.Module):
    """The tower without its head: ``embeddings``, ``encoder``, ``post_layernorm``."""

    def __init__(self, config: Config, image_resolution: tuple[int, int] = (224, 224), **factory):
        super().__init__()
        self.config = config
        ph, pw = config.patch_size
        grid = (image_resolution[0] // ph) * (image_resolution[1] // pw)
        self.embeddings = Embeddings(config, grid, **factory)
        self.encoder = Encoder(config, **factory)
        self.post_layernorm = nn.LayerNorm(config.width, eps=1e-6, **factory)


def apply(model: VisionModel, head: nn.Linear | None, image: torch.Tensor, *, remat: bool = True) -> torch.Tensor:
    """Encode ``[B, H, W, 3]`` images in [-1, 1] to patch tokens ``[B, N, num_classes]``."""
    config = model.config
    image = image.float()
    n, hh, ww, cc = image.shape
    ph, pw = config.patch_size
    gh, gw = hh // ph, ww // pw
    # The stride-14 patch "conv" is non-overlapping: im2col + one f32 matmul.
    patches = image.reshape(n, gh, ph, gw, pw, cc).permute(0, 1, 3, 2, 4, 5).reshape(n, gh * gw, ph * pw * cc)
    conv = model.embeddings.patch_embedding
    kernel = conv.weight.float().permute(2, 3, 1, 0).reshape(ph * pw * cc, -1)  # [out,in,h,w] -> HWIO rows
    x = patches @ kernel + conv.bias.float()
    x = x + model.embeddings.position_embedding.weight.float()

    x = x.to(getattr(torch, config.dtype_mm))
    recompute = remat and torch.is_grad_enabled()
    for layer in model.encoder.layers:
        x = checkpoint(layer, x, use_reentrant=False) if recompute else layer(x)
    x = _layer_norm(model.post_layernorm, x)
    if head is not None:
        x = _linear(x, head)
    return x
