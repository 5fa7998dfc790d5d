"""Carry weights from the JAX package's parameter tree into the port.

- ``load_jax_state``: a ``PI0Pytorch``-layout state dict of numpy arrays (what
  ``kai0_tpu.interop.torch_safetensors.jax_to_torch_state`` returns for a JAX
  tree without LoRA factors: torch key names, ``[out, in]`` layouts) into the
  model. bfloat16 values (ml_dtypes arrays, which numpy knows only as a 2-byte
  type) cross through a ``uint16`` view, bit for bit.
- ``lora_state_from_jax``: the LoRA factors of a flattened JAX tree
  (``PaliGemma/llm/layers/attn/q_einsum/lora_a`` of shape ``[L, N, D, r]``,
  ``.../mlp/gating_einsum_lora_b`` of shape ``[L, 2, r, F]``, the ``_1`` twins
  of the action expert) as the port's per-layer parameters, which keep the
  JAX shapes without the depth axis.
- ``quant_state_from_jax``: quantized weights (JAX's ``QuantArray.q [L, K, N]``
  and ``.s [L, N]``) as the ``qweight [N, K]`` / ``scale [N]`` buffers of the
  port's ``QuantLinear`` holders. JAX quantizes the stacked ``kv_einsum`` and
  ``gating_einsum`` leaves as one ``[K, 2·…]`` matrix with per-column scales:
  ``kv_einsum`` is the port's joint ``kv_proj`` holder as it is, and the column
  halves of ``gating_einsum`` are ``gate_proj`` and ``up_proj``, value for value.

The map from the port's names to JAX parameter paths is ``param_paths.py``.
All of these work on numpy arrays and plain names; none imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from kai0_tpu_torch.param_paths import EXPERT_ROOTS, LAYER_LEAVES, LLM, LORA_TAILS

def _to_tensor(x: np.ndarray) -> torch.Tensor:
    x = np.array(x, copy=True, order="C")  # writable and owned by the tensor
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def load_jax_state(model: nn.Module, state: Mapping[str, np.ndarray]) -> nn.Module:
    """``model.load_state_dict`` with ``strict=True`` from a numpy state dict.

    Values are copied into the model's parameters and buffers (and cast to
    their dtype); a missing or unexpected key raises.
    """
    model.load_state_dict({k: _to_tensor(v) for k, v in state.items()}, strict=True)
    return model


def lora_state_from_jax(flat: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The port's LoRA parameters from a flattened JAX tree (``a/b/c`` keys): one per layer and factor."""
    state = {}
    for root, sfx in EXPERT_ROOTS:
        for tail in LORA_TAILS:
            key = f"{LLM}/layers/{LAYER_LEAVES[tail].format(s=sfx)}"
            if key in flat:
                for i, value in enumerate(np.asarray(flat[key])):
                    state[f"{root}.layers.{i}.{tail}"] = value
    return state


def quant_state_from_jax(flat: Mapping[str, tuple[np.ndarray, np.ndarray]]) -> dict[str, np.ndarray]:
    """The port's ``QuantLinear`` buffers from JAX's quantized leaves.

    ``flat`` maps a flattened JAX path to ``(q [L, K, N], s [L, N])``.
    ``gating_einsum``'s columns are split evenly over ``gate_proj`` and
    ``up_proj``; every other leaf is one holder.
    """
    holders = ("self_attn.q_proj", "self_attn.kv_proj", "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")
    state = {}
    for root, sfx in EXPERT_ROOTS:
        by_leaf: dict[str, list[str]] = {}
        for tail in holders:
            by_leaf.setdefault(f"{LLM}/layers/{LAYER_LEAVES[tail].format(s=sfx)}", []).append(tail)
        for key, tails in by_leaf.items():
            if key not in flat:
                continue
            q, s = (np.asarray(x) for x in flat[key])
            cols = q.shape[-1] // len(tails)
            for i in range(q.shape[0]):
                for j, tail in enumerate(tails):
                    span = slice(j * cols, (j + 1) * cols)
                    state[f"{root}.layers.{i}.{tail}.qweight"] = np.ascontiguousarray(q[i][:, span].T)
                    state[f"{root}.layers.{i}.{tail}.scale"] = s[i][span]
    return state
