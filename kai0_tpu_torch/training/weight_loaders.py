"""Weight loaders: the starting weights of a training run.

Counterpart of ``kai0_tpu/training/weight_loaders.py:21-82``. A loader takes
the freshly initialised model's state dict (``PI0Pytorch`` key layout, name ->
tensor) and returns a dict with the same keys, shapes and dtypes;
``train_lib.init_train_state`` checks that and copies the loaded values into
the model (``_load_weights_and_validate``).

- ``NoOpWeightLoader`` keeps the fresh init.
- ``CheckpointWeightLoader(params_path)`` reads a local ``model.safetensors``
  (the file or its directory) through ``interop.read_safetensors``, renames
  the keys of older transformers releases and drops ``lm_head`` as the
  serving reader does, casts each value to the model's dtype, drops keys the
  model does not have and fills the missing keys that match ``.*lora.*``
  from the fresh init (``_merge_params``). A JAX Orbax checkpoint reaches the
  port through ``kai0_tpu.interop.save_torch_checkpoint``, which writes one.
  Only LoRA keys are filled: a π₀.₅ checkpoint, which has no
  ``value_head.*``, cannot start an advantage estimator, and the validation
  refuses it as the JAX package's ``check_pytree_equality`` does
  (``kai0_tpu/training/weight_loaders.py:48-49``, ``train_lib.py:44``); an
  estimator starts from an estimator checkpoint.
- ``PaliGemmaWeightLoader`` raises: its weights are a ``gs://`` download and
  the port downloads nothing.
"""

from __future__ import annotations

from collections.abc import Mapping
import dataclasses
import logging
import pathlib
import re
from typing import Protocol, runtime_checkable

import torch

logger = logging.getLogger("kai0_tpu_torch")


@runtime_checkable
class WeightLoader(Protocol):
    def load(self, params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Loaded values under the keys of ``params`` (a value of ``params`` itself keeps the init)."""


@dataclasses.dataclass(frozen=True)
class NoOpWeightLoader(WeightLoader):
    def load(self, params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return dict(params)


@dataclasses.dataclass(frozen=True)
class CheckpointWeightLoader(WeightLoader):
    """Loads a full parameter set from a local ``model.safetensors`` (a file, or the directory holding it)."""

    params_path: str

    def load(self, params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        from kai0_tpu_torch import interop

        if "://" in self.params_path:
            raise NotImplementedError(
                f"{self.params_path}: the port reads local checkpoints only; fetch it, export it with "
                "kai0_tpu.interop.save_torch_checkpoint and pass --weight_loader.params_path=<dir>/model.safetensors"
            )
        path = pathlib.Path(self.params_path)
        if path.is_dir():
            path = path / interop.CHECKPOINT_FILE
        loaded = {}
        for key, value in interop.read_safetensors(path).items():
            for rx, repl in interop._LEGACY_PREFIXES:
                key = rx.sub(repl, key)
            if not (".lm_head." in key or key.endswith("lm_head.weight")):
                loaded[key] = value
        # Add all missing LoRA weights from the reference (fresh-init) params.
        return _merge_params(loaded, params, missing_regex=".*lora.*")


@dataclasses.dataclass(frozen=True)
class PaliGemmaWeightLoader(WeightLoader):
    """The official PaliGemma npz release: a ``gs://`` download, which the port does not make."""

    weight_path: str = "gs://vertex-model-garden-paligemma-us/paligemma/pt_224.npz"

    def load(self, params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        raise NotImplementedError(
            f"PaliGemmaWeightLoader reads {self.weight_path}, a download; the port reads local checkpoints only "
            "(CheckpointWeightLoader on a model.safetensors)"
        )


def _merge_params(loaded: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor], *, missing_regex: str):
    """Loaded values over the keys of ``params``, cast to their dtypes; missing keys matching the regex from ``params``."""
    result = {k: v.to(params[k].dtype) for k, v in loaded.items() if k in params}
    if dropped := len(loaded) - len(result):
        logger.info(f"Weight loader: {dropped} checkpoint keys the model does not have were dropped")
    pattern = re.compile(missing_regex)
    for k, v in params.items():
        if k not in result and pattern.fullmatch(k):
            result[k] = v
    return result
