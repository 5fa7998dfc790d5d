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

- ``read_safetensors`` / ``write_safetensors``: the ``model.safetensors``
  file format (an 8-byte little-endian header length, a JSON header of dtype,
  shape and data offsets, then the raw little-endian bytes), with the standard
  library and torch only; bf16 crosses as a 2-byte integer view.
  ``load_torch_checkpoint`` reads a checkpoint in the ``PI0Pytorch`` key
  layout into the model (the advantage estimator's too, whose head is
  ``value_head.{0,2,4}``, as ``kai0_tpu/interop/torch_safetensors.py:320-321``
  names it; a π₀.₅ model skips those keys), counterpart of
  ``kai0_tpu/interop/torch_safetensors.py:405``, and ``save_torch_checkpoint``
  writes one (``:393``); ``is_torch_checkpoint`` is the reference's detection
  rule and ``load_norm_stats`` reads ``<assets>/<asset_id>/norm_stats.json``
  (``kai0_tpu/training/checkpoints.py:137``).

The map from the port's names to JAX parameter paths is ``param_paths.py``.
All of these work on numpy arrays, torch tensors and plain names; none imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
import json
import logging
import mmap
import pathlib
import re
import struct

import numpy as np
import torch
from torch import nn

from kai0_tpu_torch.param_paths import EXPERT_ROOTS, LAYER_LEAVES, LLM, LORA_TAILS
from kai0_tpu_torch.shared import normalize as _normalize

logger = logging.getLogger("kai0_tpu_torch")


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


# --------------------------------------------------------------------------------------
# model.safetensors
# --------------------------------------------------------------------------------------

CHECKPOINT_FILE = "model.safetensors"

# safetensors dtype names; bf16 is read and written through a 2-byte integer view.
_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64,
    "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}

_PG = "paligemma_with_expert.paligemma.model"
# Module paths of older transformers releases, normalized as the JAX package's reader does.
_LEGACY_PREFIXES = (
    (re.compile(r"^paligemma_with_expert\.paligemma\.language_model\.model\."), f"{_PG}.language_model."),
    (re.compile(r"^paligemma_with_expert\.paligemma\.vision_tower\."), f"{_PG}.vision_tower."),
    (re.compile(r"^paligemma_with_expert\.paligemma\.multi_modal_projector\."), f"{_PG}.multi_modal_projector."),
    (re.compile(r"^paligemma_with_expert\.gemma_expert\.model\.model\."), "paligemma_with_expert.gemma_expert.model."),
)


def is_torch_checkpoint(ckpt_dir) -> bool:
    """The reference's detection rule: a torch checkpoint ships ``model.safetensors``."""
    return (pathlib.Path(ckpt_dir) / CHECKPOINT_FILE).exists()


def read_safetensors(path) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors over a private (copy-on-write) map of the file."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + header_len
    tensors = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        if end == begin:
            tensors[name] = torch.empty(entry["shape"], dtype=dtype)
            continue
        raw = torch.frombuffer(data, dtype=torch.uint8, count=end - begin, offset=base + begin)
        if (base + begin) % dtype.itemsize:
            raw = raw.clone()  # a view as a wider type needs an aligned start
        if dtype == torch.bfloat16:
            tensor = raw.view(torch.int16).view(torch.bfloat16)
        else:
            tensor = raw.view(dtype)
        tensors[name] = tensor.reshape(entry["shape"])
    return tensors


def write_safetensors(tensors: Mapping[str, torch.Tensor], path) -> pathlib.Path:
    """Write tensors (any device) as a safetensors file; returns the path.

    Wider types first, then by name (as the ``safetensors`` package orders them),
    so that every tensor starts aligned to its element size.
    """
    path = pathlib.Path(path)
    names = sorted(tensors, key=lambda name: (-tensors[name].element_size(), name))
    header, offset = {}, 0
    for name in names:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
    return path


def save_torch_checkpoint(model: nn.Module, ckpt_dir) -> pathlib.Path:
    """Write the model's state dict as ``<ckpt_dir>/model.safetensors`` in the ``PI0Pytorch`` key layout."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    return write_safetensors(model.state_dict(), ckpt_dir / CHECKPOINT_FILE)


def load_torch_checkpoint(model: nn.Module, ckpt_dir) -> nn.Module:
    """Load ``model.safetensors`` (a file or its directory) into the model, cast to its parameters' dtypes.

    Keys of older transformers releases are renamed and ``lm_head`` (tied to the
    embedding) is dropped; a missing key raises, and keys the model does not
    have are logged and skipped, as the JAX package's serving load does
    (``strict=False``).
    """
    path = pathlib.Path(ckpt_dir)
    if path.is_dir():
        path = path / CHECKPOINT_FILE
    state = {}
    for key, value in read_safetensors(path).items():
        for rx, repl in _LEGACY_PREFIXES:
            key = rx.sub(repl, key)
        if not (".lm_head." in key or key.endswith("lm_head.weight")):
            state[key] = value
    expected = model.state_dict().keys()
    if extra := sorted(set(state) - set(expected)):
        logger.warning(f"unmapped torch keys: {extra[:8]} (+{max(len(extra) - 8, 0)} more)")
    model.load_state_dict({k: v for k, v in state.items() if k in expected}, strict=True)
    return model


def load_norm_stats(assets_dir, asset_id: str) -> dict[str, _normalize.NormStats]:
    """The norm stats of ``<assets_dir>/<asset_id>/norm_stats.json``; raises ``FileNotFoundError`` without one."""
    norm_stats_dir = pathlib.Path(assets_dir) / asset_id
    norm_stats = _normalize.load(norm_stats_dir)
    logger.info(f"Loaded norm stats from {norm_stats_dir}")
    return norm_stats
