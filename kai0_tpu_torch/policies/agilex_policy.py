"""Agilex (dual Piper arms, 3 RealSense cams) policy transforms.

Counterpart of ``kai0_tpu/policies/agilex_policy.py``, without JAX.
Parity: reference ``src/openpi/policies/agilex_policy.py`` — camera renames
top_head/hand_left/hand_right → base/left_wrist/right_wrist, state filtered to
[−π, π] (:92-94), outputs truncated to 14 dims (:146-148), optional ``his_-100_*``
history cameras for the advantage estimator (:39-49).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.policies import bimanual as _bimanual


def make_agilex_example() -> dict:
    return {
        "images": {
            "top_head": np.random.randint(256, size=(3, 480, 640), dtype=np.uint8),
            "hand_left": np.random.randint(256, size=(3, 480, 640), dtype=np.uint8),
            "hand_right": np.random.randint(256, size=(3, 480, 640), dtype=np.uint8),
        },
        "state": np.random.uniform(-1, 1, size=(14,)).astype(np.float32),
        "prompt": "fold the cloth",
    }


@dataclasses.dataclass(frozen=True)
class AgilexInputs(_bimanual.BimanualInputs):
    model_type: _model.ModelType = _model.ModelType.PI0
    clip_to_pi: bool = True


@dataclasses.dataclass(frozen=True)
class AgilexOutputs(_bimanual.BimanualOutputs):
    pass
