"""LeRobot dataset reader with action-horizon chunking.

Counterpart of ``kai0_tpu/data/lerobot_dataset.py:30-272``: per-episode parquet
tables, per-camera mp4 videos decoded on demand, and action sequences
assembled over ``[t, t + action_horizon)`` with edge padding past the episode
end (LeRobot's own padding), plus the per-task train/val episode split.

Reads happen in the loader's producer thread or in its spawn worker
processes (``kai0_tpu_torch.training.data_loader``), so the parquet tables go
through a thread-safe LRU and the ``cv2.VideoCapture`` objects, which are not
thread-safe, are kept per thread. ``pyarrow`` (parquet) and ``cv2`` (mp4) are
imported by the functions that use them; without either, reading raises
``ImportError`` naming the package. Nothing substitutes for them; the card's
machine has both.

A repo id is a local path, or a directory under ``$LEROBOT_HOME`` when that is
set; the port downloads nothing.
"""

from __future__ import annotations

import collections
import os
import pathlib
import threading

import numpy as np

from kai0_tpu_torch.data import lerobot_meta as _meta

_CAPS_PER_THREAD = 64  # open video readers per thread (LRU)


def _require(module: str, package: str, purpose: str, *, user: str = "the LeRobot reader"):
    """``import module``, or ``ImportError`` naming the package that ``user`` needs."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{user} needs {package} to {purpose}, and it does not import here ({e})") from e


def resolve_dataset_root(repo_id: str) -> pathlib.Path:
    """A repo id as a local dataset root: the path itself, or ``$LEROBOT_HOME/<repo_id>``."""
    path = pathlib.Path(repo_id)
    if path.exists():
        return path
    home = os.environ.get("LEROBOT_HOME")
    if home and (pathlib.Path(home).expanduser() / repo_id).exists():
        return pathlib.Path(home).expanduser() / repo_id
    raise FileNotFoundError(
        f"Dataset {repo_id!r} is not a local directory{'' if home else ' and LEROBOT_HOME is not set'}; "
        "the port reads local datasets only"
    )


class _EpisodeTableCache:
    """Thread-safe LRU of per-episode parquet tables as column->np.ndarray dicts."""

    def __init__(self, metadata: _meta.LeRobotMetadata, max_items: int = 16):
        self._metadata = metadata
        self._max_items = max_items
        self._lock = threading.Lock()
        self._cache: collections.OrderedDict[int, dict[str, np.ndarray]] = collections.OrderedDict()

    def get(self, episode_index: int) -> dict[str, np.ndarray]:
        with self._lock:
            if episode_index in self._cache:
                self._cache.move_to_end(episode_index)
                return self._cache[episode_index]
        table = self._load(episode_index)
        with self._lock:
            self._cache[episode_index] = table
            self._cache.move_to_end(episode_index)
            while len(self._cache) > self._max_items:
                self._cache.popitem(last=False)
        return table

    def _load(self, episode_index: int) -> dict[str, np.ndarray]:
        pq = _require("pyarrow.parquet", "pyarrow", "read the episodes' parquet tables")
        table = pq.read_table(self._metadata.data_path(episode_index))
        out: dict[str, np.ndarray] = {}
        for name in table.column_names:
            col = table.column(name).to_numpy(zero_copy_only=False)
            if col.dtype == object:  # list-valued column → 2-D float array
                col = np.stack([np.asarray(x, dtype=np.float32) for x in col])
            out[name] = col
        return out


class _VideoReader:
    """Thread-local cv2 video readers with a sequential-read fast path."""

    def __init__(self):
        self._local = threading.local()

    def read_frame(self, path: pathlib.Path, frame_index: int) -> np.ndarray:
        cv2 = _require("cv2", "OpenCV (cv2)", "decode the episodes' mp4 videos")
        caps = getattr(self._local, "caps", None)
        if caps is None:
            caps = self._local.caps = collections.OrderedDict()
        key = str(path)
        entry = caps.get(key)
        if entry is None:
            cap = cv2.VideoCapture(key)
            if not cap.isOpened():
                raise FileNotFoundError(f"Cannot open video {path}")
            entry = caps[key] = {"cap": cap, "next": 0}
            # Evicting an open capture costs a reopen and a keyframe seek, so the LRU is sized well above the
            # episodes x cameras that one reader touches.
            while len(caps) > _CAPS_PER_THREAD:
                _, old = caps.popitem(last=False)
                old["cap"].release()
        caps.move_to_end(key)
        cap = entry["cap"]
        if frame_index != entry["next"]:
            cap.set(cv2.CAP_PROP_POS_FRAMES, frame_index)
        ok, frame = cap.read()
        if not ok:
            raise IOError(f"Failed to read frame {frame_index} from {path}")
        entry["next"] = frame_index + 1
        return frame[..., ::-1].copy()  # BGR → RGB


class LeRobotDataset:
    """Random-access view over a LeRobot dataset with action chunking.

    ``__getitem__`` returns the parquet row of the frame (scalars and vectors),
    each video feature decoded to uint8 RGB ``[H, W, 3]``, and every key of
    ``action_sequence_keys`` replaced by its ``[action_horizon, D]`` chunk
    (edge-padded past the episode end).
    """

    def __init__(
        self,
        repo_id: str,
        *,
        action_horizon: int = 1,
        action_sequence_keys: tuple[str, ...] = ("action",),
        episodes: list[int] | None = None,
    ):
        self.root = resolve_dataset_root(repo_id)
        self.metadata = _meta.LeRobotMetadata.load(self.root)
        self._action_horizon = action_horizon
        self._action_sequence_keys = action_sequence_keys
        self._tables = _EpisodeTableCache(self.metadata)
        self._videos = _VideoReader()

        all_episodes = {ep["episode_index"]: ep for ep in self.metadata.episodes}
        selected = sorted(all_episodes) if episodes is None else sorted(episodes)
        self._episode_indices = selected
        self._episode_lengths = {i: all_episodes[i]["length"] for i in selected}
        # Global frame index → (episode, frame) mapping.
        self._offsets = np.cumsum([0] + [self._episode_lengths[i] for i in selected])

    def __getstate__(self) -> dict:
        """Picklable for the loader's worker processes: the table and decoder caches stay behind."""
        state = self.__dict__.copy()
        state["_tables"] = None
        state["_videos"] = None
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._tables = _EpisodeTableCache(self.metadata)
        self._videos = _VideoReader()

    @property
    def tasks(self) -> dict[int, str]:
        return self.metadata.tasks

    @property
    def fps(self) -> float:
        return self.metadata.fps

    @property
    def episode_indices(self) -> list[int]:
        return self._episode_indices

    def episode_length(self, episode_index: int) -> int:
        return self._episode_lengths[episode_index]

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def locate(self, index: int) -> tuple[int, int]:
        if index < 0 or index >= len(self):
            raise IndexError(index)
        pos = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return self._episode_indices[pos], index - int(self._offsets[pos])

    def __getitem__(self, index: int) -> dict:
        episode_index, frame_index = self.locate(index)
        return self.get_frame(episode_index, frame_index)

    def get_frame(
        self,
        episode_index: int,
        frame_index: int,
        *,
        key_prefix: str = "",
        index_map=None,
        logical_length: int | None = None,
    ) -> dict:
        """One frame of an episode: its scalar columns, its action chunks (clamped to the episode) and its decoded
        video frames, every key prefixed by ``key_prefix`` (``kai0_tpu/data/lerobot_dataset.py:203-240``; the
        advantage dataset reads its comparison frame as ``his_-100_*``).

        ``index_map`` / ``logical_length`` let a view re-index the episode (``augment_views.TimeScaledView``):
        ``frame_index`` and the chunk's rows are then logical positions, clamped to ``logical_length`` and mapped
        to table rows by ``index_map`` (called on an int and on an index array)."""
        table = self._tables.get(episode_index)
        length = self._episode_lengths[episode_index] if logical_length is None else logical_length
        phys = (lambda i: i) if index_map is None else index_map
        item: dict = {}
        for name, col in table.items():
            if name in self._action_sequence_keys:
                idx = np.minimum(np.arange(frame_index, frame_index + self._action_horizon), length - 1)
                item[key_prefix + name] = np.asarray(col[phys(idx)])
            else:
                item[key_prefix + name] = col[phys(frame_index)]
        for video_key in self.metadata.video_keys:
            item[key_prefix + video_key] = self._videos.read_frame(
                self.metadata.video_path(episode_index, video_key), int(phys(frame_index))
            )
        return item


def episodes_split_through_task(
    dataset: LeRobotDataset, split: str, *, val_fraction: float = 0.1, seed: int = 42
) -> list[int]:
    """Per-task 90/10 episode split (reference data_loader.py:185-212).

    Episodes are grouped by the task of their first frame and split within each
    group, so every task appears in both splits.
    """
    if split == "all":
        return dataset.episode_indices

    by_task: dict[int, list[int]] = collections.defaultdict(list)
    for ep in dataset.episode_indices:
        table = dataset._tables.get(ep)
        task_index = int(table["task_index"][0]) if "task_index" in table else 0
        by_task[task_index].append(ep)

    rng = np.random.default_rng(seed)
    train, val = [], []
    for task_index in sorted(by_task):
        eps = sorted(by_task[task_index])
        order = rng.permutation(len(eps))
        n_val = max(1, int(round(len(eps) * val_fraction))) if len(eps) > 1 else 0
        val_set = {eps[i] for i in order[:n_val]}
        val.extend(sorted(val_set))
        train.extend(e for e in eps if e not in val_set)

    if split == "train":
        return sorted(train)
    if split == "val":
        return sorted(val)
    raise ValueError(f"Unknown split {split!r} (expected train/val/all)")
