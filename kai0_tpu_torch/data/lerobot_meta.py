"""LeRobot dataset metadata: info.json / episodes.jsonl / tasks.jsonl and the file paths.

The port's own copy of ``kai0_tpu/data/lerobot_meta.py:29-123`` (the LeRobot
v2.x on-disk contract: read, and written by ``lerobot_writer.py`` and the
Stage Advantage tools), so that the port imports nothing of the JAX package.
The layout:

    meta/info.json        — fps, features schema, path templates, totals
    meta/episodes.jsonl   — one {"episode_index", "tasks", "length"} per episode
    meta/tasks.jsonl      — one {"task_index", "task"} per task
    meta/stats.json       — per-feature aggregate stats (optional)
    data/chunk-XXX/episode_XXXXXX.parquet
    videos/chunk-XXX/<video_key>/episode_XXXXXX.mp4
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

CODEBASE_VERSION = "v2.1"
DEFAULT_CHUNK_SIZE = 1000
DEFAULT_DATA_PATH = "data/chunk-{episode_chunk:03d}/episode_{episode_index:06d}.parquet"
DEFAULT_VIDEO_PATH = "videos/chunk-{episode_chunk:03d}/{video_key}/episode_{episode_index:06d}.mp4"


def read_jsonl(path: pathlib.Path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def write_jsonl(path: pathlib.Path, rows: list[dict]) -> None:
    """One ``json.dumps(row)`` a line, as the JAX package writes them (its files, byte for byte)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


@dataclasses.dataclass
class LeRobotMetadata:
    root: pathlib.Path
    info: dict[str, Any]
    episodes: list[dict]
    tasks: dict[int, str]

    @classmethod
    def load(cls, root: pathlib.Path | str) -> "LeRobotMetadata":
        root = pathlib.Path(root)
        with open(root / "meta" / "info.json") as f:
            info = json.load(f)
        episodes = read_jsonl(root / "meta" / "episodes.jsonl")
        tasks = {row["task_index"]: row["task"] for row in read_jsonl(root / "meta" / "tasks.jsonl")}
        return cls(root=root, info=info, episodes=episodes, tasks=tasks)

    @property
    def fps(self) -> float:
        return self.info["fps"]

    @property
    def features(self) -> dict[str, dict]:
        return self.info["features"]

    @property
    def video_keys(self) -> list[str]:
        return [k for k, v in self.features.items() if v["dtype"] == "video"]

    @property
    def chunks_size(self) -> int:
        return self.info.get("chunks_size", DEFAULT_CHUNK_SIZE)

    def episode_chunk(self, episode_index: int) -> int:
        return episode_index // self.chunks_size

    def data_path(self, episode_index: int) -> pathlib.Path:
        template = self.info.get("data_path", DEFAULT_DATA_PATH)
        return self.root / template.format(
            episode_chunk=self.episode_chunk(episode_index), episode_index=episode_index
        )

    def video_path(self, episode_index: int, video_key: str) -> pathlib.Path:
        template = self.info.get("video_path", DEFAULT_VIDEO_PATH)
        return self.root / template.format(
            episode_chunk=self.episode_chunk(episode_index),
            episode_index=episode_index,
            video_key=video_key,
        )

    def save(self) -> None:
        meta_dir = self.root / "meta"
        meta_dir.mkdir(parents=True, exist_ok=True)
        with open(meta_dir / "info.json", "w") as f:
            json.dump(self.info, f, indent=2)
        write_jsonl(meta_dir / "episodes.jsonl", self.episodes)
        write_jsonl(meta_dir / "tasks.jsonl", [{"task_index": i, "task": t} for i, t in sorted(self.tasks.items())])


def new_info(features: dict[str, dict], fps: float, *, robot_type: str = "unknown",
             chunks_size: int = DEFAULT_CHUNK_SIZE) -> dict:
    """``info.json`` of an empty dataset."""
    return {
        "codebase_version": CODEBASE_VERSION,
        "robot_type": robot_type,
        "total_episodes": 0,
        "total_frames": 0,
        "total_tasks": 0,
        "total_videos": 0,
        "total_chunks": 0,
        "chunks_size": chunks_size,
        "fps": fps,
        "splits": {},
        "data_path": DEFAULT_DATA_PATH,
        "video_path": DEFAULT_VIDEO_PATH,
        "features": features,
    }
