"""Shared input/output transforms for dual-arm 3-camera robots (Agilex, ARX).

Counterpart of ``kai0_tpu/policies/bimanual.py``, without JAX. The reference implements these twice (``src/openpi/policies/agilex_policy.py`` and
``arx_policy.py``, near-identical); here the common behavior lives once and the
robot modules parameterize it. Behavior contract:

- images arrive CHW (LeRobot float32) or HWC uint8 under the robot camera names and
  are renamed to the model keys (``base_0_rgb``/``left_wrist_0_rgb``/
  ``right_wrist_0_rgb``; history cameras ``his_-100_*`` → ``*_-100_rgb`` for the
  advantage estimator) and converted to uint8 HWC (agilex_policy.py:70-89);
- state/actions are padded to the model action dim; out-of-range values
  (>π or <−π) are zeroed when ``clip_to_pi`` (agilex_policy.py:92-94, Agilex only);
- padding masks are only produced for π₀/π₀-RTC models (agilex_policy.py:57);
- outputs are truncated to the first 14 dims (13 joints + gripper,
  agilex_policy.py:146-148).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kai0_tpu_torch import transforms as _transforms
from kai0_tpu_torch.models import model as _model

REQUIRED_RENAME_MAP = {
    "top_head": "base_0_rgb",
    "hand_left": "left_wrist_0_rgb",
    "hand_right": "right_wrist_0_rgb",
}
# Optional history cameras for advantage-estimator training.
OPTIONAL_RENAME_MAP = {
    "his_-100_top_head": "base_-100_rgb",
    "his_-100_hand_left": "left_wrist_-100_rgb",
    "his_-100_hand_right": "right_wrist_-100_rgb",
}
ALL_RENAME_MAP = {**REQUIRED_RENAME_MAP, **OPTIONAL_RENAME_MAP}

# Advantage-estimator passthrough fields.
_PASSTHROUGH_KEYS = (
    "frame_index",
    "episode_length",
    "progress",
    "image_original",
    "episode_index",
    "action_advantage",
    "action_advantage_original",
)


def parse_image(img) -> np.ndarray:
    """Float CHW/HWC → uint8 HWC."""
    img = np.asarray(img)
    if np.issubdtype(img.dtype, np.floating):
        img = (255 * img).astype(np.uint8)
    if img.shape[0] == 3:
        img = np.transpose(img, (1, 2, 0))
    return img


@dataclasses.dataclass(frozen=True)
class BimanualInputs(_transforms.DataTransformFn):
    action_dim: int
    model_type: _model.ModelType = _model.ModelType.PI0
    # Agilex filters joint values outside [-π, π] to 0; ARX does not.
    clip_to_pi: bool = False
    # Zero the state input (ablation knob, agilex_policy.py:53).
    mask_state: bool = False

    def __call__(self, data: dict) -> dict:
        mask_padding = self.model_type in (_model.ModelType.PI0, _model.ModelType.PI0_RTC)
        in_images = data["images"]
        unknown = set(in_images) - set(ALL_RENAME_MAP)
        if unknown:
            raise ValueError(f"Unexpected cameras {sorted(unknown)}; expected {sorted(ALL_RENAME_MAP)}")

        state = _transforms.pad_to_dim(np.asarray(data["state"]), self.action_dim)
        state = state.squeeze()

        images, image_masks = {}, {}
        for camera, model_name in ALL_RENAME_MAP.items():
            if camera in in_images:
                images[model_name] = parse_image(in_images[camera])
                image_masks[model_name] = np.True_
            elif camera in REQUIRED_RENAME_MAP:
                raise ValueError(f"Camera {camera} not found in data")

        if self.clip_to_pi:
            state = np.where(np.abs(state) > np.pi, 0, state)

        inputs = {
            "image": images,
            "image_mask": image_masks,
            "state": np.zeros_like(state) if self.mask_state else state,
        }

        if "actions" in data:
            actions = _transforms.pad_to_dim(np.asarray(data["actions"]), self.action_dim)
            if self.clip_to_pi:
                actions = np.where(np.abs(actions) > np.pi, 0, actions)
            if mask_padding:
                action_mask = np.ones_like(actions, dtype=bool)
                action_mask[:, self.action_dim :] = False
                inputs["action_mask"] = action_mask
            inputs["actions"] = actions.squeeze()

        if "prompt" in data:
            inputs["prompt"] = data["prompt"]
        for key in _PASSTHROUGH_KEYS:
            if key in data:
                inputs[key] = data[key]
        return inputs


@dataclasses.dataclass(frozen=True)
class BimanualOutputs(_transforms.DataTransformFn):
    # 13 joints + 1 gripper per the dual-arm layout.
    action_dim: int = 14

    def __call__(self, data: dict) -> dict:
        return {"actions": np.asarray(data["actions"][:, : self.action_dim])}
