"""The train state, the trainable split and the batch summary that the training loop logs.

Counterpart of ``kai0_tpu/training/utils.py``. ``params`` are the model's own
parameters by name, frozen ones included (the step updates the trainable ones
in place), so the module and the state never disagree. ``split_by_mask``
separates them by a name -> bool mask (True = trainable), as JAX's splits its
tree; a frozen int8 weight is a buffer of its ``QuantLinear`` holder, not a
parameter, so it is in neither part.
"""

from __future__ import annotations

from collections.abc import Mapping
import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict[str, torch.Tensor]
    opt_state: dict
    ema: dict[str, torch.Tensor] | None = None


def split_by_mask(params: Mapping[str, torch.Tensor], trainable_mask: Mapping[str, bool]):
    """(trainable, frozen) dicts of ``params``; a name missing from the mask counts as trainable."""
    trainable = {k: p for k, p in params.items() if trainable_mask.get(k, True)}
    frozen = {k: p for k, p in params.items() if not trainable_mask.get(k, True)}
    return trainable, frozen


def array_tree_to_info(tree) -> str:
    """One line ``  <path>: <shape> <dtype> <device>`` for each tensor or array of a nested batch (at most 200)."""
    lines = []

    def visit(path: str, x) -> None:
        if isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                visit(f"{path}[{i}]", v)
        elif isinstance(x, Mapping):
            for k, v in x.items():
                visit(f"{path}[{k!r}]", v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                visit(f"{path}.{f.name}", getattr(x, f.name))
        elif isinstance(x, torch.Tensor):
            lines.append(f"  {path}: {tuple(x.shape)} {str(x.dtype).removeprefix('torch.')} {x.device}")
        elif hasattr(x, "shape") and hasattr(x, "dtype"):
            lines.append(f"  {path}: {tuple(x.shape)} {x.dtype}")

    visit("", tree)
    return "\n".join(lines[:200])
