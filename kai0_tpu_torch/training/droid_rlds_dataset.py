"""The RLDS DROID stream, for datasets too large for LeRobot, without TensorFlow.

Counterpart of ``kai0_tpu/training/droid_rlds_dataset.py`` (reference
``src/openpi/training/droid_rlds_dataset.py``), on numpy and ``cv2``:

- Per dataset of the mix: the shards (``data/rlds.py``; their order shuffled
  each epoch by the stream's generator when ``shuffle`` is set, as tfds's
  ``shuffle_files``), each episode decoded and made a trajectory (dlimp's
  ``from_rlds``), kept when ``file_path[0]`` matches ``.*success.*``, then
  ``restructure_trajectory`` (actions of the action space ++ the gripper, one
  exterior camera and one of the three instructions drawn a trajectory, the
  step ids and the idle filter), ``chunk_actions`` (the tail clamped to the
  last action) and the frames that pass the filter; repeated without end.
- The weighted mix: each draw picks a dataset by weight
  (``tf.data.Dataset.sample_from_datasets``).
- The shuffle buffer (``tf.data``'s ``shuffle``): filled to
  ``shuffle_buffer_size`` (250,000 frames), then each step emits a uniformly
  chosen element and refills its slot. It always runs, as in the JAX package.
  It holds frames whose images are still encoded.
- Then the batch: each frame's two images decoded by ``cv2.imdecode``
  (BGR → RGB, uint8 HWC) on a thread pool (cv2 releases the GIL), stacked.

Every draw (shard order, camera, instruction, mix, buffer) comes from one
``np.random.Generator`` seeded by ``seed``, so a stream is reproducible.
Where the JAX module cannot run as written, this follows the reference it
cites (ROADMAP Queue 3): episodes are made trajectories before the filters
read ``traj_metadata``, and the decode comes after the buffer. ``repeat=False``
(one epoch and the buffer drained) is for tests. Ranges of the filter JSON are
clamped at step 0.
"""

from __future__ import annotations

import bisect
from collections.abc import Iterator, Sequence
import concurrent.futures
import dataclasses
import enum
import json
import logging
import os
import pathlib
import re

import numpy as np

from kai0_tpu_torch.data import rlds

logger = logging.getLogger("kai0_tpu_torch")

DEFAULT_SHUFFLE_BUFFER = 250_000
_SUCCESS = re.compile(rb".*success.*")


class DroidActionSpace(enum.Enum):
    """The action space of the stream (``kai0_tpu/training/droid_rlds_dataset.py:29-31``)."""

    JOINT_POSITION = enum.auto()
    JOINT_VELOCITY = enum.auto()


@dataclasses.dataclass(frozen=True)
class RLDSDataset:
    """One RLDS dataset of a weighted mix (``droid_rlds_dataset.py:34-39``)."""

    name: str
    version: str
    weight: float
    filter_dict_path: str | None = None


class FilterTable:
    """Which steps pass the idle filter: those in the ``[start, end)`` ranges of their episode key
    (``<recording_folderpath>--<file_path>``) when a table was read, every step otherwise (reference :82-113)."""

    def __init__(self, ranges: dict[str, list] | None = None):
        self._ranges = None if ranges is None else {key.encode("utf-8"): r for key, r in ranges.items()}

    def passes(self, episode_key: bytes, length: int) -> np.ndarray:
        keep = np.full(length, self._ranges is None)
        for start, end in (self._ranges or {}).get(episode_key, ()):
            keep[max(int(start), 0):max(int(end), 0)] = True
        return keep


def make_filter_table(filter_dict_path: str | None) -> FilterTable:
    """The filter of a ``{"<episode key>": [[start, end], ...]}`` JSON file, or keep-all without one."""
    if filter_dict_path is None:
        return FilterTable()
    with pathlib.Path(filter_dict_path).open() as f:
        filter_dict = json.load(f)
    logger.info(f"Using filter dictionary with {len(filter_dict)} episodes")
    return FilterTable(filter_dict)


def restructure_trajectory(traj: dict, *, action_space: DroidActionSpace, filter_table: FilterTable,
                           rng: np.random.Generator) -> dict:
    """One trajectory reformatted: actions, one exterior camera, one instruction, step ids, the filter (:115-169)."""
    action_key = "joint_position" if action_space == DroidActionSpace.JOINT_POSITION else "joint_velocity"
    actions = np.concatenate((traj["action_dict"][action_key], traj["action_dict"]["gripper_position"]), axis=-1)
    observation = traj["observation"]
    # One of the two exterior (left-stereo) cameras, then one of the three instructions, a trajectory each.
    exterior = observation["exterior_image_1_left" if rng.random() > 0.5 else "exterior_image_2_left"]
    instruction = traj[("language_instruction", "language_instruction_2", "language_instruction_3")[rng.integers(3)]]
    length = len(traj["actions"] if "actions" in traj else actions)
    metadata = traj["traj_metadata"]["episode_metadata"]
    episode_keys = [rec + b"--" + path + b"--" for rec, path in
                    zip(metadata["recording_folderpath"], metadata["file_path"], strict=True)]
    step_id = rlds._bytes_array([key + str(t).encode() for t, key in enumerate(episode_keys)])
    if len(set(episode_keys)) > 1:
        raise ValueError("a trajectory whose episode metadata changes from step to step")
    passes = filter_table.passes(episode_keys[0][:-2] if length else b"", length)
    return {
        "actions": actions,
        "observation": {
            "image": exterior,
            "wrist_image": observation["wrist_image_left"],
            "joint_position": observation["joint_position"],
            "gripper_position": observation["gripper_position"],
        },
        "prompt": instruction,
        "step_id": step_id,
        "passes_filter": passes,
    }


def chunk_actions(traj: dict, action_chunk_size: int) -> dict:
    """[T, D] → [T, chunk, D], the tail chunks clamped to the last action (:173-192)."""
    length = len(traj["actions"])
    idx = np.minimum(np.arange(length)[:, None] + np.arange(action_chunk_size)[None], max(length - 1, 0))
    return {**traj, "actions": traj["actions"][idx]}


def _frame(traj: dict, t: int) -> dict:
    obs = traj["observation"]
    return {
        "actions": traj["actions"][t],
        "observation": {key: obs[key][t] for key in ("image", "wrist_image", "joint_position", "gripper_position")},
        "prompt": traj["prompt"][t],
        "step_id": traj["step_id"][t],
    }


def decode_image(encoded: bytes) -> np.ndarray:
    """An encoded image (JPEG, PNG) as uint8 RGB HWC."""
    import cv2

    image = cv2.imdecode(np.frombuffer(encoded, np.uint8), cv2.IMREAD_COLOR)
    if image is None:
        raise ValueError(f"an image of {len(encoded)} bytes that cv2 cannot decode")
    return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)


def _decoded(frame: dict) -> dict:
    obs = frame["observation"]
    return {**frame, "observation": {**obs, "image": decode_image(obs["image"]),
                                     "wrist_image": decode_image(obs["wrist_image"])}}


def _prepared(traj: dict, *, action_space: DroidActionSpace, action_chunk_size: int, filter_table: FilterTable,
              rng: np.random.Generator) -> dict:
    return chunk_actions(restructure_trajectory(traj, action_space=action_space, filter_table=filter_table, rng=rng),
                         action_chunk_size)


def build_frame_pipeline(trajectories, *, action_space: DroidActionSpace = DroidActionSpace.JOINT_POSITION,
                         action_chunk_size: int = 16, filter_table: FilterTable | None = None,
                         rng: np.random.Generator | None = None) -> Iterator[dict]:
    """Trajectories → the decoded frames that pass the filter, each with its action chunk (``build_frame_pipeline``
    of the JAX module)."""
    filter_table = filter_table or FilterTable()
    rng = rng if rng is not None else np.random.default_rng()
    for traj in trajectories:
        traj = _prepared(traj, action_space=action_space, action_chunk_size=action_chunk_size,
                         filter_table=filter_table, rng=rng)
        for t in np.flatnonzero(traj["passes_filter"]):
            yield _decoded(_frame(traj, t))


class _Source:
    """One dataset of the mix as an endless stream of (trajectory, step) references, with each epoch's counts."""

    def __init__(self, data_dir: str, config: RLDSDataset, *, shuffle: bool, repeat: bool, action_space,
                 action_chunk_size: int, rng: np.random.Generator):
        self.config = config
        self.paths = rlds.shard_paths(data_dir, config.name, config.version)
        self.filter_table = make_filter_table(config.filter_dict_path)
        self.shuffle, self.repeat, self.rng = shuffle, repeat, rng
        self.action_space, self.action_chunk_size = action_space, action_chunk_size
        self.epochs: list[dict] = []  # per finished epoch: episodes, success episodes, their frames, frames kept

    def __iter__(self) -> Iterator[tuple[dict, int]]:
        while True:
            counts = dict.fromkeys(("episodes", "success_episodes", "frames", "kept_frames"), 0)
            paths = [self.paths[i] for i in self.rng.permutation(len(self.paths))] if self.shuffle else self.paths
            for index, episode in enumerate(rlds.read_episodes(paths)):
                counts["episodes"] += 1
                if not _SUCCESS.fullmatch(episode["episode_metadata"]["file_path"][0]):
                    continue
                traj = _prepared(rlds.episode_to_trajectory(episode, index), action_space=self.action_space,
                                 action_chunk_size=self.action_chunk_size, filter_table=self.filter_table,
                                 rng=self.rng)
                kept = np.flatnonzero(traj["passes_filter"])
                counts["success_episodes"] += 1
                counts["frames"] += len(traj["passes_filter"])
                counts["kept_frames"] += len(kept)
                for t in kept:
                    yield traj, int(t)
            self.epochs.append(counts)
            if not self.repeat:
                return
            if counts["kept_frames"] == 0:
                raise ValueError(f"RLDS dataset {self.config.name}: an epoch gave no frame (no success episode, or "
                                 "the filter drops every step)")


class DroidRldsDataset:
    """Weighted multi-dataset DROID stream of batches (reference ``DroidRldsDataset`` :36-248)."""

    def __init__(
        self,
        data_dir: str,
        batch_size: int,
        datasets: Sequence[RLDSDataset],
        *,
        shuffle: bool = True,
        action_chunk_size: int = 16,
        action_space: DroidActionSpace = DroidActionSpace.JOINT_POSITION,
        shuffle_buffer_size: int | None = None,
        num_parallel_calls: int | None = None,
        seed: int = 0,
        repeat: bool = True,
    ):
        try:
            import cv2  # noqa: F401 — the decode after the buffer
        except ImportError as e:
            raise ImportError("The RLDS DROID stream decodes its images with cv2 (opencv-python), which does not "
                              "import here") from e
        if abs(sum(d.weight for d in datasets) - 1.0) > 1e-6:
            raise ValueError("Dataset weights must sum to 1.0")
        self.rng = np.random.default_rng(seed)
        self.sources = [_Source(data_dir, d, shuffle=shuffle, repeat=repeat, action_space=action_space,
                                action_chunk_size=action_chunk_size, rng=self.rng) for d in datasets]
        self.weights = np.asarray([d.weight for d in datasets], np.float64)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.shuffle_buffer_size = shuffle_buffer_size or DEFAULT_SHUFFLE_BUFFER  # read at construction
        self.num_parallel_calls = num_parallel_calls or min(8, os.cpu_count() or 1)

    def _mixed(self) -> Iterator[tuple[dict, int]]:
        """``sample_from_datasets``: each element from a dataset drawn by weight; an ended dataset leaves the draw."""
        streams = [iter(s) for s in self.sources]
        weights = self.weights.copy()
        while weights.sum() > 0:
            cumulative = np.cumsum(weights / weights.sum()).tolist()
            while True:
                i = min(bisect.bisect_right(cumulative, self.rng.random()), len(streams) - 1)
                try:
                    yield next(streams[i])
                except StopIteration:
                    weights[i] = 0.0
                    break

    def _shuffled(self) -> Iterator[tuple[dict, int]]:
        """``tf.data``'s shuffle: fill the buffer, then emit a uniformly chosen element and refill its slot."""
        source = self._mixed()
        buffer = []
        for element in source:
            buffer.append(element)
            if len(buffer) >= self.shuffle_buffer_size:
                break
        for element in source:
            i = int(self.rng.integers(len(buffer)))
            yield buffer[i]
            buffer[i] = element
        while buffer:
            i = int(self.rng.integers(len(buffer)))
            buffer[i], buffer[-1] = buffer[-1], buffer[i]
            yield buffer.pop()

    def __iter__(self) -> Iterator[dict]:
        with concurrent.futures.ThreadPoolExecutor(self.num_parallel_calls, thread_name_prefix="rlds-decode") as pool:
            frames = []
            for traj, t in self._shuffled():
                frames.append(_frame(traj, t))
                if len(frames) == self.batch_size:
                    yield _stack(list(pool.map(_decoded, frames)))
                    frames = []
            if frames:  # the end of a stream that does not repeat: the last, partial batch
                yield _stack(list(pool.map(_decoded, frames)))

    def __len__(self) -> int:
        # The approximate post-filter frame count of DROID (reference :245-248).
        return 20_000_000


def _stack(frames: list[dict]):
    first = frames[0]
    if isinstance(first, dict):
        return {key: _stack([f[key] for f in frames]) for key in first}
    if isinstance(first, bytes):
        return rlds._bytes_array(frames)
    return np.stack(frames)
