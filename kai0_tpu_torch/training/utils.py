"""The train state.

Counterpart of ``kai0_tpu/training/utils.py``'s ``TrainState``. ``params`` are
the model's own parameters by name (the step updates them in place), so the
module and the state never disagree. Every parameter is trainable in the full
fine-tune, so JAX's ``split_by_mask`` / ``merge_by_mask`` are the identity here;
freeze masks come with LoRA.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict[str, torch.Tensor]
    opt_state: dict
    ema: dict[str, torch.Tensor] | None = None
