"""FSQ action tokenizer: a finite-scalar-quantization autoencoder over action chunks, PyTorch.

Counterpart of ``kai0_tpu/models/fsq_tokenizer.py``: an MLP encoder maps an
``[ah, ad]`` chunk to ``num_tokens`` latent vectors, each dimension bounded by
tanh to ``[-(b-1)/2, (b-1)/2]`` and rounded (half to even, as ``jnp.round``),
and the token id is the mixed-radix number of those digits; the decoder maps
the digits back through an MLP (gelu, tanh approximation, between layers).

Parameters are a flat dict of tensors, ``{encoder,decoder}.{i}.{kernel,bias}``
with JAX's ``[in, out]`` kernels: ``params_from_jax`` carries a JAX tree across
(the weight function), and ``load_params`` reads them from a ``.safetensors``
file (``interop.write_safetensors`` of that dict). There is no initializer:
the port cannot draw JAX's ``jax.random.key(0)`` weights, and an untrained
codebook decodes nothing useful.
"""

from __future__ import annotations

from collections.abc import Mapping
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

# Bins per latent dim by target codebook size (FSQ paper; ``fsq_tokenizer.py:22-29``).
_FSQ_BINS = {
    2**8: (8, 6, 5),
    2**10: (8, 5, 5, 5),
    2**12: (7, 5, 5, 5, 5),
    2**14: (8, 8, 8, 6, 5),
    2**16: (8, 8, 8, 5, 5, 5),
}


@dataclasses.dataclass(frozen=True)
class FsqConfig:
    action_horizon: int = 50
    action_dim: int = 32
    num_tokens: int = 16
    target_codebook_size: int = 2**10
    hidden: int = 512

    @property
    def bins_per_dim(self) -> tuple[int, ...]:
        if self.target_codebook_size not in _FSQ_BINS:
            raise ValueError(f"Codebook size {self.target_codebook_size} not supported.")
        return _FSQ_BINS[self.target_codebook_size]

    @property
    def latent_dim(self) -> int:
        return len(self.bins_per_dim)

    @property
    def vocab_size(self) -> int:
        return int(np.prod(self.bins_per_dim))


def params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The port's flat parameters from JAX's tree ``{"encoder": [{"kernel", "bias"}, ...], "decoder": [...]}``."""
    return {
        f"{part}.{i}.{leaf}": torch.from_numpy(np.array(layer[leaf], copy=True))
        for part in ("encoder", "decoder")
        for i, layer in enumerate(params[part])
        for leaf in ("kernel", "bias")
    }


def load_params(path) -> dict[str, torch.Tensor]:
    """Parameters from a ``.safetensors`` file (``interop.write_safetensors`` of the flat dict)."""
    from kai0_tpu_torch import interop

    return interop.read_safetensors(path)


def _mlp(params: Mapping[str, torch.Tensor], part: str, x: torch.Tensor) -> torch.Tensor:
    depth = sum(1 for name in params if name.startswith(f"{part}.") and name.endswith(".kernel"))
    for i in range(depth):
        x = x @ params[f"{part}.{i}.kernel"].to(x.dtype) + params[f"{part}.{i}.bias"].to(x.dtype)
        if i < depth - 1:
            x = F.gelu(x, approximate="tanh")
    return x


def _digits(config: FsqConfig, z: torch.Tensor) -> torch.Tensor:
    """Per-dim digits int32 [..., L] of latents z [..., L]."""
    half = (torch.tensor(config.bins_per_dim, dtype=z.dtype, device=z.device) - 1) / 2
    return (torch.round(torch.tanh(z) * half) + half).to(torch.int32)


def _digitize(config: FsqConfig, digits: torch.Tensor) -> torch.Tensor:
    """Mixed-radix digits [..., L] → token ids [...]."""
    ids = torch.zeros(digits.shape[:-1], dtype=torch.int32, device=digits.device)
    for i, b in enumerate(config.bins_per_dim):
        ids = ids * b + digits[..., i]
    return ids


def _undigitize(config: FsqConfig, ids: torch.Tensor) -> torch.Tensor:
    """Token ids [...] → per-dim quantized values f32 [..., L]."""
    digits, rest = [], ids
    for b in reversed(config.bins_per_dim):
        digits.append(torch.remainder(rest, b))
        rest = torch.div(rest, b, rounding_mode="floor")
    digits = torch.stack(list(reversed(digits)), dim=-1).to(torch.float32)
    half = (torch.tensor(config.bins_per_dim, dtype=torch.float32, device=ids.device) - 1) / 2
    return digits - half


def encode(params: Mapping[str, torch.Tensor], config: FsqConfig, actions: torch.Tensor) -> torch.Tensor:
    """[B, ah, ad] → token ids int32 [B, num_tokens]."""
    z = _mlp(params, "encoder", actions.reshape(actions.shape[0], -1))
    return _digitize(config, _digits(config, z.reshape(actions.shape[0], config.num_tokens, config.latent_dim)))


def decode(params: Mapping[str, torch.Tensor], config: FsqConfig, token_ids: torch.Tensor) -> torch.Tensor:
    """Token ids [B, num_tokens] → reconstructed actions f32 [B, ah, ad]."""
    values = _undigitize(config, token_ids)
    flat = _mlp(params, "decoder", values.reshape(token_ids.shape[0], -1))
    return flat.reshape(token_ids.shape[0], config.action_horizon, config.action_dim)
