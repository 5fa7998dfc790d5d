"""Synthetic DROID episodes in the RLDS schema, shared by the RLDS test files.

An episode is ``{"steps": {...}, "episode_metadata": {...}}`` as tfds stores
it: joint and gripper positions drawn as float32 (the on-disk width, so the
float64 the reader returns is exact), three cameras as JPEG bytes (cv2), three
instructions a step, a recording folder and a file path.
"""

from __future__ import annotations

import cv2
import numpy as np

CAMERAS = ("exterior_image_1_left", "exterior_image_2_left", "wrist_image_left")
INSTRUCTIONS = ("language_instruction", "language_instruction_2", "language_instruction_3")


def jpeg(image: np.ndarray, quality: int = 90) -> bytes:
    """RGB uint8 HWC → JPEG bytes."""
    ok, encoded = cv2.imencode(".jpg", np.ascontiguousarray(image[..., ::-1]), [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return encoded.tobytes()


def _image(rng: np.random.Generator, hw: tuple[int, int]) -> np.ndarray:
    h, w = hw
    y, x = np.mgrid[0:h, 0:w]
    base = np.sin(x / rng.uniform(2, 6)) * 60 + np.cos(y / rng.uniform(2, 6)) * 60 + 128
    return np.clip(np.stack([base + rng.normal(0, 4, (h, w)) for _ in range(3)], -1), 0, 255).astype(np.uint8)


def droid_episode(rng: np.random.Generator, *, length: int, file_path: str, recording: str,
                  hw: tuple[int, int] = (24, 32), distinct: bool = True, prefix: str = "") -> dict:
    """One episode. With ``distinct`` False both exterior cameras hold the same frames and the three instructions
    are one string, so the frame pipeline's draws cannot tell in what it gives."""
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    frames = [_image(rng, hw) for _ in CAMERAS]
    if not distinct:
        frames[1] = frames[0]
    cameras = {name: [jpeg(np.roll(frame, t, axis=1)) for t in range(length)] for name, frame in zip(CAMERAS, frames)}
    texts = [f"{prefix}pick up the cup", f"{prefix}grab the cup", f"{prefix}lift the cup"]
    if not distinct:
        texts = [texts[0]] * 3
    return {
        "steps": {
            "action_dict": {"joint_position": f32(length, 7), "joint_velocity": f32(length, 7),
                            "gripper_position": rng.uniform(size=(length, 1)).astype(np.float32)},
            "observation": {**cameras, "joint_position": f32(length, 7),
                            "gripper_position": rng.uniform(size=(length, 1)).astype(np.float32)},
            **{key: [text] * length for key, text in zip(INSTRUCTIONS, texts)},
        },
        "episode_metadata": {"file_path": file_path, "recording_folderpath": recording},
    }


def trajectory(episode: dict) -> dict:
    """The trajectory view (dlimp's ``from_rlds``) of ``episode`` as the test builds it, bytes as object arrays."""
    steps = episode["steps"]
    length = len(steps["action_dict"]["joint_position"])

    def strings(values):
        out = np.empty(len(values), object)
        out[:] = [v.encode() if isinstance(v, str) else v for v in values]
        return out

    meta = episode["episode_metadata"]
    return {
        "action_dict": {k: v.astype(np.float64) for k, v in steps["action_dict"].items()},
        "observation": {**{k: strings(steps["observation"][k]) for k in CAMERAS},
                        "joint_position": steps["observation"]["joint_position"].astype(np.float64),
                        "gripper_position": steps["observation"]["gripper_position"].astype(np.float64)},
        **{k: strings(steps[k]) for k in INSTRUCTIONS},
        "traj_metadata": {"episode_metadata": {k: strings([meta[k]] * length) for k in meta}},
    }
