"""Time-scaling augmentation: keep every Nth frame of a LeRobot dataset.

The port's copy of ``kai0_tpu/augment/time_scaling.py:24-157``. Frames 0, N,
2N, … are kept in the parquet rows and the videos while fps stays unchanged,
so the episodes play back N× faster; ``frame_index``, ``timestamp`` and
``index`` are resequenced. The split mode time-scales a fraction of the
episodes (drawn by ``random.Random(seed)``, as in JAX) and merges them with
the untouched rest. Parquet goes through ``pyarrow``, video through OpenCV.
"""

from __future__ import annotations

import pathlib
import random
import tempfile

import numpy as np

from kai0_tpu_torch.data import lerobot_meta as _meta
from kai0_tpu_torch.data import split_merge as _split_merge


def extract_frames_from_video(
    src_video: pathlib.Path, tgt_video: pathlib.Path, extraction_factor: int, fps: float
) -> int:
    """Write every Nth frame of ``src_video`` to ``tgt_video`` at unchanged fps; returns the frames kept."""
    import cv2

    cap = cv2.VideoCapture(str(src_video))
    if not cap.isOpened():
        raise FileNotFoundError(f"Cannot open video {src_video}")
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    tgt_video.parent.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(str(tgt_video), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    kept = 0
    idx = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % extraction_factor == 0:
                writer.write(frame)
                kept += 1
            idx += 1
    finally:
        cap.release()
        writer.release()
    return kept


def _rescale_episode_parquet(table, new_episode_index: int, global_frame_start: int, factor: int, fps: float):
    """Keep every Nth row and resequence the bookkeeping columns (``timestamp`` becomes float64, as in JAX)."""
    out = table.take(np.arange(0, table.num_rows, factor))
    n = out.num_rows
    out = _split_merge.replace_column(out, "episode_index", np.full(n, new_episode_index, dtype=np.int64))
    out = _split_merge.replace_column(out, "frame_index", np.arange(n, dtype=np.int64))
    out = _split_merge.replace_column(out, "timestamp", np.arange(n, dtype=np.float64) / fps)
    return _split_merge.replace_column(
        out, "index", np.arange(global_frame_start, global_frame_start + n, dtype=np.int64))


def time_scale_dataset(
    source: pathlib.Path | str,
    dst: pathlib.Path | str,
    extraction_factor: int,
    *,
    episodes: list[int] | None = None,
) -> _meta.LeRobotMetadata:
    """Write a time-scaled copy (every Nth frame) of the selected episodes as a full dataset."""
    if extraction_factor < 1:
        raise ValueError("extraction_factor must be >= 1")
    src_meta = _meta.LeRobotMetadata.load(source)
    dst = pathlib.Path(dst)
    fps = src_meta.fps
    chunks_size = src_meta.chunks_size
    selected = sorted(episodes) if episodes is not None else [ep["episode_index"] for ep in src_meta.episodes]
    episodes_by_index = {ep["episode_index"]: ep for ep in src_meta.episodes}

    new_episodes = []
    frame_cursor = 0
    for new_index, old_index in enumerate(selected):
        out = _rescale_episode_parquet(_split_merge.read_table(src_meta.data_path(old_index)), new_index,
                                       frame_cursor, extraction_factor, fps)
        _split_merge.write_table(out, dst / _meta.DEFAULT_DATA_PATH.format(
            episode_chunk=new_index // chunks_size, episode_index=new_index))

        for video_key in src_meta.video_keys:
            src_video = src_meta.video_path(old_index, video_key)
            if not src_video.exists():
                continue
            tgt_video = dst / _meta.DEFAULT_VIDEO_PATH.format(
                episode_chunk=new_index // chunks_size, episode_index=new_index, video_key=video_key
            )
            extract_frames_from_video(src_video, tgt_video, extraction_factor, fps)

        row = dict(episodes_by_index[old_index])
        row["episode_index"] = new_index
        row["length"] = out.num_rows
        new_episodes.append(row)
        frame_cursor += out.num_rows

    info = _split_merge.info_with_totals(src_meta.info, episodes=len(selected), frames=frame_cursor,
                                         n_video_keys=len(src_meta.video_keys), chunks_size=chunks_size)
    info.update(_split_merge.DEFAULT_LAYOUT)
    out_meta = _meta.LeRobotMetadata(root=dst, info=info, episodes=new_episodes, tasks=dict(src_meta.tasks))
    out_meta.save()
    return out_meta


def time_scaling_with_split(
    source: pathlib.Path | str,
    dst: pathlib.Path | str,
    extraction_factor: int,
    *,
    extract_fraction: float = 0.5,
    seed: int = 42,
) -> _meta.LeRobotMetadata:
    """Time-scale a random fraction of the episodes, keep the rest, merge both into one dataset."""
    src_meta = _meta.LeRobotMetadata.load(source)
    all_eps = [ep["episode_index"] for ep in src_meta.episodes]
    random.Random(seed).shuffle(all_eps)
    n_extract = int(round(len(all_eps) * extract_fraction))
    extract_eps, keep_eps = sorted(all_eps[:n_extract]), sorted(all_eps[n_extract:])

    with tempfile.TemporaryDirectory(prefix="timescale_") as tmp:
        tmp = pathlib.Path(tmp)
        parts = []
        if extract_eps:
            time_scale_dataset(source, tmp / "scaled", extraction_factor, episodes=extract_eps)
            parts.append(tmp / "scaled")
        if keep_eps:
            _split_merge._write_subset(src_meta, tmp / "kept", keep_eps)
            parts.append(tmp / "kept")
        return _split_merge.merge_datasets(parts, dst)
