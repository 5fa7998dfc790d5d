"""The advantage estimator's dataset: each frame paired with another frame of its episode.

The port's copy of ``kai0_tpu/data/advantage_dataset.py`` (reference
``src/openpi/training/advantage_dataset.py:67-139``): the comparison frame is
drawn with ``np.random.default_rng((seed, index))`` as a random other frame of
the same episode, its keys are prefixed ``his_-100_`` (the history cameras),
the episode length and the frame's task string are attached, and the
regression target is

    progress = stage_progress_gt − his_-100_stage_progress_gt.
"""

from __future__ import annotations

import numpy as np

from kai0_tpu_torch.data.lerobot_dataset import LeRobotDataset

HIS_PREFIX = "his_-100_"
PROGRESS_KEY = "stage_progress_gt"


class AdvantageLerobotDataset:
    """Wraps a ``LeRobotDataset`` that has a per-frame ``stage_progress_gt`` column."""

    def __init__(self, dataset: LeRobotDataset, *, seed: int = 0):
        self._dataset = dataset
        self._seed = seed

    @property
    def tasks(self) -> dict[int, str]:
        return self._dataset.tasks

    def __len__(self) -> int:
        return len(self._dataset)

    def __getitem__(self, index: int) -> dict:
        dataset = self._dataset
        episode_index, frame_index = dataset.locate(index)
        item = dataset.get_frame(episode_index, frame_index)
        length = dataset.episode_length(episode_index)
        item["episode_length"] = np.int64(length)
        item["task"] = dataset.tasks[int(item["task_index"])]

        # A random other frame of the same episode as the comparison point.
        rng = np.random.default_rng((self._seed, index))
        if length < 2:
            raise ValueError(f"Episode {episode_index} too short for advantage sampling")
        offset = int(rng.integers(1, length))
        comparison_frame = (frame_index + offset) % length
        item.update(dataset.get_frame(episode_index, comparison_frame, key_prefix=HIS_PREFIX))

        if PROGRESS_KEY not in item:
            raise KeyError(
                f"Advantage training requires a '{PROGRESS_KEY}' column (the stage-advantage step 0 annotation)."
            )
        item["progress"] = np.float32(item[PROGRESS_KEY] - item[HIS_PREFIX + PROGRESS_KEY])
        return item
