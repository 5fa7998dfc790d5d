"""The train state and the trainable split.

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
