"""Aloha (Trossen bimanual) policy transforms.

Counterpart of ``kai0_tpu/policies/aloha_policy.py``, without JAX.
Parity: reference ``src/openpi/policies/aloha_policy.py`` — 4 cameras with cam_low
dropped, joint-flip mask between Aloha and π joint conventions, and the gripper
linear↔angular conversions with the Interbotix constants (:117-160).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np

from kai0_tpu_torch import transforms as _transforms
from kai0_tpu_torch.policies.bimanual import parse_image


def make_aloha_example() -> dict:
    """A syntactically valid Aloha observation (used for serve warmup and tests)."""
    rand_cam = lambda: np.random.randint(256, size=(3, 224, 224), dtype=np.uint8)  # noqa: E731
    return {
        "state": np.ones((14,)),
        "images": {cam: rand_cam() for cam in AlohaInputs.EXPECTED_CAMERAS},
        "prompt": "do something",
    }


@dataclasses.dataclass(frozen=True)
class AlohaInputs(_transforms.DataTransformFn):
    """state [14]; images CHW keyed by EXPECTED_CAMERAS; actions [horizon, 14]."""

    # Convert joints/grippers between the Aloha space and the π-internal space the
    # base model was trained in.
    adapt_to_pi: bool = True

    EXPECTED_CAMERAS: ClassVar[tuple[str, ...]] = (
        "cam_high",
        "cam_low",
        "cam_left_wrist",
        "cam_right_wrist",
    )

    def __call__(self, data: dict) -> dict:
        in_images = {name: parse_image(img) for name, img in data["images"].items()}
        if set(in_images) - set(self.EXPECTED_CAMERAS):
            raise ValueError(f"Expected images {self.EXPECTED_CAMERAS}, got {tuple(in_images)}")

        state = _decode_state(np.asarray(data["state"]), adapt_to_pi=self.adapt_to_pi)

        # Model slots ← Aloha cameras (cam_low has no slot and is dropped). Missing
        # wrist cams become masked-out zero frames.
        base_image = in_images["cam_high"]
        slot_map = (("base_0_rgb", "cam_high"), ("left_wrist_0_rgb", "cam_left_wrist"), ("right_wrist_0_rgb", "cam_right_wrist"))
        images, image_masks = {}, {}
        for slot, cam in slot_map:
            present = cam in in_images
            images[slot] = in_images[cam] if present else np.zeros_like(base_image)
            image_masks[slot] = np.bool_(present)

        inputs = {"image": images, "image_mask": image_masks, "state": state}
        if "actions" in data:
            inputs["actions"] = _encode_actions_inv(np.asarray(data["actions"]), adapt_to_pi=self.adapt_to_pi)
        if "prompt" in data:
            inputs["prompt"] = data["prompt"]
        return inputs


@dataclasses.dataclass(frozen=True)
class AlohaOutputs(_transforms.DataTransformFn):
    adapt_to_pi: bool = True

    def __call__(self, data: dict) -> dict:
        actions = np.asarray(data["actions"][:, :14])
        return {"actions": _encode_actions(actions, adapt_to_pi=self.adapt_to_pi)}


# Per-joint sign differences between the Aloha joint convention and the π-internal
# one π₀ pretrained in ([L 6 joints, L gripper, R 6 joints, R gripper]; the gripper
# slots are always +1 — they are remapped below, not flipped).
_PI_SIGN = np.array([1, -1, -1, 1, 1, 1, 1, 1, -1, -1, 1, 1, 1, 1])
_GRIPPER_IDX = [6, 13]

# Hardware constants, all taken from the Aloha/Interbotix stacks (the reference
# carries the same numbers at aloha_policy.py:117-153):
# - puppet gripper slider travel in meters (POSITION_CLOSED..POSITION_OPEN),
# - the four-bar linkage geometry converting slider travel to horn rotation,
# - π₀'s gripper normalization window: encoder counts (2405, 3110) of 4096 with
#   zero at 2048, i.e. radians (0.5476, 1.6296),
# - puppet gripper *joint* command range in radians (JOINT_CLOSE..JOINT_OPEN).
_SLIDER_TRAVEL = (0.01844, 0.05800)
_LINKAGE_ARM_LEN = 0.036
_LINKAGE_HORN_RADIUS = 0.022
_PI_GRIPPER_RAD = (0.5476, 1.6296)
_ALOHA_JOINT_RAD = (-0.6213, 1.4910)


def _lerp(unit, lo, hi):
    return unit * (hi - lo) + lo


def _inv_lerp(value, lo, hi):
    return (value - lo) / (hi - lo)


def _slider_to_horn_angle(slider: np.ndarray) -> np.ndarray:
    """Invert the Interbotix four-bar linkage: slider extension (m) → horn angle (rad)."""
    cos_like = (_LINKAGE_HORN_RADIUS**2 + slider**2 - _LINKAGE_ARM_LEN**2) / (2 * _LINKAGE_HORN_RADIUS * slider)
    return np.arcsin(np.clip(cos_like, -1.0, 1.0))


def _gripper_to_angular(unit_pos: np.ndarray) -> np.ndarray:
    # Aloha reports the puppet gripper as a normalized *linear* slider position;
    # π₀ was pretrained on normalized *angular* positions. Chain: unit → meters →
    # horn radians → π₀'s unit window.
    radians = _slider_to_horn_angle(_lerp(unit_pos, *_SLIDER_TRAVEL))
    return _inv_lerp(radians, *_PI_GRIPPER_RAD)


def _gripper_from_angular(unit_angle: np.ndarray) -> np.ndarray:
    # π₀ output → Aloha gripper-joint command. Both sides are angular; only the
    # zero point and normalization window differ.
    return _inv_lerp(unit_angle + _PI_GRIPPER_RAD[0], *_ALOHA_JOINT_RAD)


def _gripper_from_angular_inv(unit_cmd: np.ndarray) -> np.ndarray:
    return _lerp(unit_cmd, *_ALOHA_JOINT_RAD) - _PI_GRIPPER_RAD[0]


def _joint_flip_mask() -> np.ndarray:
    return _PI_SIGN


def _decode_state(state: np.ndarray, *, adapt_to_pi: bool = False) -> np.ndarray:
    """Aloha robot state → π space (sign flips + gripper linear→angular)."""
    if adapt_to_pi:
        state = _PI_SIGN * state
        state[_GRIPPER_IDX] = _gripper_to_angular(state[_GRIPPER_IDX])
    return state


def _encode_actions(actions: np.ndarray, *, adapt_to_pi: bool = False) -> np.ndarray:
    """π-space action chunk → Aloha command space."""
    if adapt_to_pi:
        actions = _PI_SIGN * actions
        actions[:, _GRIPPER_IDX] = _gripper_from_angular(actions[:, _GRIPPER_IDX])
    return actions


def _encode_actions_inv(actions: np.ndarray, *, adapt_to_pi: bool = False) -> np.ndarray:
    """Aloha-recorded action chunk → π space (training direction)."""
    if adapt_to_pi:
        actions = _PI_SIGN * actions
        actions[:, _GRIPPER_IDX] = _gripper_from_angular_inv(actions[:, _GRIPPER_IDX])
    return actions
