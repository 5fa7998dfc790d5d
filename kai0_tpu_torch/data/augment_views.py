"""Train-time augmentation views over random-access datasets.

The port's copy of ``kai0_tpu/data/augment_views.py``. The offline rewrites
of ``kai0_tpu_torch.augment`` double the disk and re-encode every flipped
video; these views serve the same items at load time, from the decoded
frames (the flip is lossless there):

- ``TimeScaledView(dataset, N)`` serves the frames ``time_scale_dataset``
  keeps (rows 0, N, 2N, … of every episode), with action chunks gathered at
  stride N and clamped at the last kept frame, and ``frame_index`` /
  ``timestamp`` / ``index`` resequenced as the offline rewrite does.
- ``MirroredView(dataset)`` serves every item and then its mirrored twin,
  numbered as ``create_mirror_and_merge`` numbers the merged dataset.

Compose them as ``MirroredView(TimeScaledView(raw, N))``: the time-scale view
needs the raw ``LeRobotDataset`` (it reads through ``get_frame``'s
``index_map``). Both pickle into the loader's worker processes.
"""

from __future__ import annotations

import numpy as np

from kai0_tpu_torch.augment import space_mirroring as _sm

_IMAGE_PREFIX = "observation.images."


def _swap_arm_blocks(value: np.ndarray, left_dim: int, right_dim: int) -> np.ndarray:
    """Arm-block swap along the last axis (a chunk ``[action_horizon, dim]`` is swapped row by row)."""
    arr = np.asarray(value)
    if arr.ndim <= 1:
        return _sm.swap_arms_in_array(arr, left_dim, right_dim)
    total = left_dim + right_dim
    if left_dim != right_dim or arr.shape[-1] < total:
        # Unequal blocks or short rows: the per-row function, so that the result and the error are the offline
        # rewrite's.
        flat = arr.reshape(-1, arr.shape[-1])
        out = np.stack([_sm.swap_arms_in_array(row, left_dim, right_dim) for row in flat])
        return out.reshape(arr.shape)
    # The loader's hot path: the swap is a fixed column permutation, one gather for the whole chunk.
    perm = np.concatenate([np.arange(left_dim, total), np.arange(left_dim), np.arange(total, arr.shape[-1])])
    return arr[..., perm]


class TimeScaledView:
    """Episodes played back ``factor``× faster: the frames and chunks of the offline ``time_scale_dataset``.

    Wraps a raw ``LeRobotDataset``: the strided action rows are gathered
    through ``get_frame``'s ``index_map`` (assembling a chunk from
    ``action_horizon`` whole items would decode as many video frames).
    """

    def __init__(self, dataset, factor: int):
        if factor < 1:
            raise ValueError("factor must be >= 1")
        self._dataset = dataset
        self._factor = int(factor)
        self._kept = [-(-dataset.episode_length(e) // self._factor) for e in dataset.episode_indices]
        self._offsets = np.cumsum([0] + self._kept)

    def __len__(self) -> int:
        return int(self._offsets[-1])

    @property
    def tasks(self):
        return self._dataset.tasks

    @property
    def episode_indices(self):
        """The inner episode set (``MirroredView`` renumbers against it)."""
        return self._dataset.episode_indices

    def __getitem__(self, index: int) -> dict:
        index = int(index)
        if index < 0 or index >= len(self):
            raise IndexError(index)
        ds = self._dataset
        pos = int(np.searchsorted(self._offsets, index, side="right")) - 1
        k = index - int(self._offsets[pos])
        f = self._factor
        # Logical rows 0..kept-1 map to the physical rows 0, f, 2f, …; clamping the chunk at the last kept frame is
        # LeRobot's edge padding on the rewritten episode.
        item = ds.get_frame(ds.episode_indices[pos], k, index_map=lambda i: i * f, logical_length=self._kept[pos])
        if "frame_index" in item:
            item["frame_index"] = np.int64(k)
        if "timestamp" in item:
            item["timestamp"] = np.float64(k / ds.fps)
        if "index" in item:
            item["index"] = np.int64(int(self._offsets[pos]) + k)
        return item


class MirroredView:
    """Every item, then its space-mirrored twin: the layout of the offline ``create_mirror_and_merge``.

    ``index < len(inner)`` gives the item; above, the twin: the arm blocks of
    ``DEFAULT_SWAP_COLUMNS`` swapped (state and chunked actions), every
    ``observation.images.*`` frame flipped horizontally with the wrist cameras
    swapped into each other's slots (``DEFAULT_CAMERA_SWAP``), ``episode_index`` and
    ``index`` moved past the originals as the merge renumbers them, and
    everything else passed through.

    Norm stats should be computed through this view (the norm-stats script
    reads the configured dataset, so a config with ``augment_mirror=True``
    does): stats of the unmirrored data fit only a symmetric setup.
    """

    def __init__(self, dataset, *, left_dim: int = 7, right_dim: int = 7):
        self._dataset = dataset
        self._left_dim = left_dim
        self._right_dim = right_dim
        # The merge numbers the twins' episodes from max + 1 (the count for the usual 0..E-1, and free of
        # collisions for a subset); None when the inner dataset has no episode set.
        eps = getattr(dataset, "episode_indices", None)
        self._episode_offset = (max(eps) + 1) if eps else None

    def __len__(self) -> int:
        return 2 * len(self._dataset)

    @property
    def tasks(self):
        """The inner task table (``PromptFromLeRobotTask`` reads it)."""
        return self._dataset.tasks

    def __getitem__(self, index: int) -> dict:
        index = int(index)
        n = len(self._dataset)
        if index < n:
            return self._dataset[index]
        item = self._dataset[index - n]
        out: dict = {}
        for key, value in item.items():
            if key in _sm.DEFAULT_SWAP_COLUMNS:
                out[key] = _swap_arm_blocks(value, self._left_dim, self._right_dim)
            elif key.startswith(_IMAGE_PREFIX):
                # The flipped right-wrist view lands in the left-wrist slot and the reverse; the copy drops the
                # negative stride.
                out[_sm.DEFAULT_CAMERA_SWAP.get(key, key)] = np.ascontiguousarray(np.asarray(value)[:, ::-1])
            elif key == "episode_index" and self._episode_offset is not None:
                out[key] = np.int64(int(value) + self._episode_offset)
            elif key == "index":
                out[key] = np.int64(int(value) + n)
            else:
                out[key] = value
        return out
