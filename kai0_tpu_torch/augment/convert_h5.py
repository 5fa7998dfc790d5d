"""Convert DAgger/ALOHA-style HDF5 episodes (with per-camera mp4s) to a LeRobot dataset.

The port's copy of ``kai0_tpu/augment/convert_h5.py:22-88``, on the port's
``LeRobotDatasetWriter``. The input is the DAgger collector's layout:

    <src>/episode_N.hdf5             /observations/{qpos,qvel,effort}, /action
    <src>/video/<cam>/episode_N.mp4  per-camera RGB export

``h5py`` is imported when a conversion starts; without it the conversion
raises ``ImportError`` naming the package.
"""

from __future__ import annotations

import pathlib

import numpy as np

from kai0_tpu_torch.data import lerobot_meta as _meta
from kai0_tpu_torch.data.lerobot_dataset import _require
from kai0_tpu_torch.data.lerobot_writer import LeRobotDatasetWriter, feature_spec

_STATE_KEY = "observations/qpos"
_ACTION_KEY = "action"


def _read_video(path: pathlib.Path) -> np.ndarray:
    """Every frame of an mp4 as uint8 RGB ``[T, H, W, 3]``."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise FileNotFoundError(f"Cannot open video {path}")
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[..., ::-1].copy())
    finally:
        cap.release()
    return np.stack(frames)


def convert_h5_to_lerobot(
    src_dir: pathlib.Path | str,
    dst: pathlib.Path | str,
    *,
    task: str,
    cameras: list[str],
    fps: float = 30.0,
) -> _meta.LeRobotMetadata:
    """Convert every ``episode_*.hdf5`` under ``src_dir`` into a LeRobot dataset at ``dst``."""
    h5py = _require("h5py", "h5py", "read the HDF5 episodes", user="convert_h5_to_lerobot")

    src_dir = pathlib.Path(src_dir)
    episode_files = sorted(src_dir.glob("episode_*.hdf5"), key=lambda p: int(p.stem.split("_")[-1]))
    if not episode_files:
        raise ValueError(f"No episode_*.hdf5 files under {src_dir}")

    # The dims and image sizes come from the first episode.
    with h5py.File(episode_files[0]) as f:
        state_dim = f[_STATE_KEY].shape[1]
        action_dim = f[_ACTION_KEY].shape[1]
    first_idx = episode_files[0].stem.split("_")[-1]
    cam_sizes = {cam: _read_video(src_dir / "video" / cam / f"episode_{first_idx}.mp4").shape[1:3] for cam in cameras}

    feats = feature_spec(state_dim=state_dim, action_dim=action_dim, cameras=cam_sizes, fps=fps)
    writer = LeRobotDatasetWriter(dst, feats, fps=fps)

    for path in episode_files:
        idx = path.stem.split("_")[-1]
        with h5py.File(path) as f:
            state = np.asarray(f[_STATE_KEY], dtype=np.float32)
            action = np.asarray(f[_ACTION_KEY], dtype=np.float32)
        videos = {}
        for cam in cameras:
            frames = _read_video(src_dir / "video" / cam / f"episode_{idx}.mp4")
            videos[f"observation.images.{cam}"] = frames[: min(len(frames), len(state))]
        n = min(len(state), *(len(v) for v in videos.values()))
        writer.add_episode(
            {"observation.state": state[:n], "action": action[:n]},
            task=task,
            videos={k: v[:n] for k, v in videos.items()},
        )
    return writer.finalize()
