"""LeRobot dataset writer, on ``pyarrow`` and OpenCV.

The port's copy of ``kai0_tpu/data/lerobot_writer.py``: episodes are
appended one at a time; vector and scalar features go to a per-episode
parquet (written with ``pyarrow``: the same columns, types and values as the
JAX writer's ``pandas`` tables), video features are encoded to mp4 by
``cv2.VideoWriter`` with the ``mp4v`` codec (the JAX writer's settings, so the
videos decode to the same frames; the cameras of an episode in parallel
threads), and the meta files are written by
``finalize()``. The Stage Advantage pipeline uses it to write a dataset on the
card's machine, which has ``pyarrow`` and ``cv2`` and is not promised
``pandas``.
"""

from __future__ import annotations

import concurrent.futures
import pathlib

import numpy as np

from kai0_tpu_torch.data import lerobot_meta as _meta


def feature_spec(
    *,
    state_dim: int | None = None,
    action_dim: int | None = None,
    cameras: dict[str, tuple[int, int]] | None = None,
    fps: float = 30.0,
    extra: dict[str, dict] | None = None,
) -> dict[str, dict]:
    """The features schema of a common robot dataset: state, action, RGB cameras and ``extra``."""
    features: dict[str, dict] = {}
    if state_dim is not None:
        features["observation.state"] = {
            "dtype": "float32", "shape": [state_dim], "names": [f"motor_{i}" for i in range(state_dim)],
        }
    if action_dim is not None:
        features["action"] = {
            "dtype": "float32", "shape": [action_dim], "names": [f"motor_{i}" for i in range(action_dim)],
        }
    for cam, (h, w) in (cameras or {}).items():
        features[f"observation.images.{cam}"] = {
            "dtype": "video",
            "shape": [h, w, 3],
            "names": ["height", "width", "channel"],
            "info": {"video.fps": fps, "video.codec": "mp4v", "video.pix_fmt": "yuv420p"},
        }
    features.update(extra or {})
    return features


class LeRobotDatasetWriter:
    """Append-only LeRobot dataset writer."""

    def __init__(
        self,
        root: pathlib.Path | str,
        features: dict[str, dict],
        *,
        fps: float = 30.0,
        robot_type: str = "unknown",
        chunks_size: int = _meta.DEFAULT_CHUNK_SIZE,
    ):
        self.root = pathlib.Path(root)
        if self.root.exists() and any(self.root.iterdir()):
            raise FileExistsError(f"Dataset root {self.root} already exists and is not empty")
        self.root.mkdir(parents=True, exist_ok=True)
        self.metadata = _meta.LeRobotMetadata(
            root=self.root,
            info=_meta.new_info(features, fps, robot_type=robot_type, chunks_size=chunks_size),
            episodes=[],
            tasks={},
        )
        self._task_to_index: dict[str, int] = {}
        self._total_frames = 0

    @property
    def video_keys(self) -> list[str]:
        return self.metadata.video_keys

    def task_index(self, task: str) -> int:
        if task not in self._task_to_index:
            index = len(self._task_to_index)
            self._task_to_index[task] = index
            self.metadata.tasks[index] = task
        return self._task_to_index[task]

    def add_episode(
        self,
        data: dict[str, np.ndarray],
        *,
        task: str | list[str],
        videos: dict[str, np.ndarray] | None = None,
    ) -> int:
        """Append one episode.

        ``data`` holds per-frame features ``[T, ...]``; ``videos`` holds uint8
        RGB arrays ``[T, H, W, 3]`` per video key. ``task`` is one string for
        the episode or one per frame.
        """
        import pyarrow as pa
        import pyarrow.parquet as pq

        videos = videos or {}
        episode_index = len(self.metadata.episodes)
        lengths = {len(v) for v in list(data.values()) + list(videos.values())}
        if len(lengths) != 1:
            raise ValueError(f"Inconsistent episode lengths: { {k: len(v) for k, v in data.items()} }")
        (length,) = lengths

        if isinstance(task, str):
            task_list = [task] * length
        else:
            task_list = list(task)
            if len(task_list) != length:
                raise ValueError("Per-frame task list length mismatch")
        task_indices = np.asarray([self.task_index(t) for t in task_list], dtype=np.int64)

        columns: dict[str, object] = {}
        for name, value in data.items():
            value = np.asarray(value)
            # A vector feature is a list column (pandas' inference for a column of arrays).
            columns[name] = pa.array(list(value)) if value.ndim > 1 else pa.array(value)
        columns.setdefault("timestamp", pa.array(np.arange(length, dtype=np.float32) / self.metadata.fps))
        columns.setdefault("frame_index", pa.array(np.arange(length, dtype=np.int64)))
        columns["episode_index"] = pa.array(np.full(length, episode_index, dtype=np.int64))
        columns["index"] = pa.array(np.arange(self._total_frames, self._total_frames + length, dtype=np.int64))
        columns["task_index"] = pa.array(task_indices)

        path = self.metadata.data_path(episode_index)
        path.parent.mkdir(parents=True, exist_ok=True)
        pq.write_table(pa.table(columns), path)

        if missing := [key for key in self.video_keys if key not in videos]:
            raise ValueError(f"Missing video for feature {missing[0]}")
        # One encoder a camera, in threads (OpenCV releases the GIL while it encodes).
        with concurrent.futures.ThreadPoolExecutor(max(1, len(self.video_keys))) as pool:
            list(pool.map(lambda key: self._write_video(self.metadata.video_path(episode_index, key), videos[key]),
                          self.video_keys))

        self.metadata.episodes.append(
            {"episode_index": episode_index, "tasks": sorted(set(task_list)), "length": int(length)}
        )
        self._total_frames += length
        return episode_index

    def _write_video(self, path: pathlib.Path, frames: np.ndarray) -> None:
        import cv2

        path.parent.mkdir(parents=True, exist_ok=True)
        h, w = frames.shape[1:3]
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), self.metadata.fps, (w, h))
        if not writer.isOpened():
            raise IOError(f"Cannot open video writer for {path}")
        for frame in frames:
            writer.write(np.ascontiguousarray(frame[..., ::-1]))  # RGB → BGR
        writer.release()

    def finalize(self) -> _meta.LeRobotMetadata:
        info = self.metadata.info
        n = len(self.metadata.episodes)
        info["total_episodes"] = n
        info["total_frames"] = self._total_frames
        info["total_tasks"] = len(self.metadata.tasks)
        info["total_videos"] = n * len(self.video_keys)
        info["total_chunks"] = (n + self.metadata.chunks_size - 1) // self.metadata.chunks_size
        info["splits"] = {"train": f"0:{n}"}
        self.metadata.save()
        return self.metadata
