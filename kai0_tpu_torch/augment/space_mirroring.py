"""Space-mirroring augmentation for dual-arm LeRobot datasets.

The port's copy of ``kai0_tpu/augment/space_mirroring.py:22-181``: the
horizontally mirrored twin of every episode. State and action vectors laid
out ``[L arm (7)][R arm (7)]`` get their arm blocks swapped, videos are
flipped horizontally with the two wrist cameras swapped (the flipped right
wrist becomes the left wrist's view and the reverse; the top camera flips in
place), ``meta/stats.json`` and ``meta/episodes_stats.jsonl`` are mirrored the
same way, and the twin can be merged with the original. Parquet goes through
``pyarrow``, video through OpenCV (``mp4v``, as the JAX package writes it).
"""

from __future__ import annotations

import json
import pathlib
import tempfile

import numpy as np

from kai0_tpu_torch.data import lerobot_meta as _meta
from kai0_tpu_torch.data import split_merge as _split_merge

DEFAULT_SWAP_COLUMNS = ("observation.state", "action")
# hand_right footage becomes the mirrored hand_left view and vice versa.
DEFAULT_CAMERA_SWAP = {
    "observation.images.hand_left": "observation.images.hand_right",
    "observation.images.hand_right": "observation.images.hand_left",
}


def swap_arms_in_array(arr: np.ndarray, left_dim: int = 7, right_dim: int = 7) -> np.ndarray:
    """Swap the leading left-arm block with the following right-arm block.

    Dims beyond ``left_dim + right_dim`` (padding) are preserved in place.
    """
    arr = np.asarray(arr)
    if arr.ndim == 0:
        return arr
    flat = arr.reshape(-1).copy()
    total = left_dim + right_dim
    if len(flat) < total:
        raise ValueError(f"Expected at least {total} dims, got {len(flat)}")
    left = flat[:left_dim].copy()
    flat[:left_dim] = flat[left_dim:total][:left_dim]
    flat[left_dim:total] = left
    return flat.reshape(arr.shape)


def mirror_parquet(
    input_path: pathlib.Path,
    output_path: pathlib.Path,
    *,
    left_dim: int = 7,
    right_dim: int = 7,
) -> None:
    """Copy an episode's parquet with the arm blocks of ``DEFAULT_SWAP_COLUMNS`` swapped row by row."""
    table = _split_merge.read_table(input_path)
    for col in DEFAULT_SWAP_COLUMNS:
        if col in table.column_names:
            rows = table.column(col).to_numpy(zero_copy_only=False)
            table = _split_merge.replace_column(
                table, col, [swap_arms_in_array(np.asarray(v), left_dim, right_dim) for v in rows])
    _split_merge.write_table(table, output_path)


def flip_video(input_path: pathlib.Path, output_path: pathlib.Path) -> None:
    """Horizontal mirror of a video file."""
    import cv2

    cap = cv2.VideoCapture(str(input_path))
    if not cap.isOpened():
        raise FileNotFoundError(f"Cannot open video {input_path}")
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    output_path.parent.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(str(output_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            writer.write(cv2.flip(frame, 1))
    finally:
        cap.release()
        writer.release()


def mirror_norm_stats(stats: dict, *, left_dim: int = 7, right_dim: int = 7) -> dict:
    """Swap arm blocks inside a ``norm_stats.json``-style dict (mean/std/q01/q99)."""
    out = {}
    for key, entry in stats.items():
        out[key] = {
            field: swap_arms_in_array(np.asarray(vals), left_dim, right_dim).tolist()
            if isinstance(vals, (list, np.ndarray)) and len(np.atleast_1d(vals)) >= left_dim + right_dim
            else vals
            for field, vals in entry.items()
        }
    return out


def create_mirror_dataset(
    source: pathlib.Path | str,
    dst: pathlib.Path | str,
    *,
    left_dim: int = 7,
    right_dim: int = 7,
) -> _meta.LeRobotMetadata:
    """Write the mirrored twin of a dataset (the same episode numbering)."""
    src_meta = _meta.LeRobotMetadata.load(source)
    dst = pathlib.Path(dst)

    for ep in src_meta.episodes:
        i = ep["episode_index"]
        mirror_parquet(src_meta.data_path(i), dst / src_meta.data_path(i).relative_to(src_meta.root),
                       left_dim=left_dim, right_dim=right_dim)
        for video_key in src_meta.video_keys:
            src_video = src_meta.video_path(i, video_key)
            if not src_video.exists():
                continue
            # The flipped right-wrist view lands in the left-wrist slot (and vice versa).
            tgt_key = DEFAULT_CAMERA_SWAP.get(video_key, video_key)
            flip_video(src_video, dst / src_meta.video_path(i, tgt_key).relative_to(src_meta.root))

    out_meta = _meta.LeRobotMetadata(root=dst, info=dict(src_meta.info),
                                     episodes=[dict(ep) for ep in src_meta.episodes], tasks=dict(src_meta.tasks))
    out_meta.save()

    # The auxiliary stats files, where the source has them, mirrored too.
    stats_json = src_meta.root / "meta" / "stats.json"
    if stats_json.exists():
        with open(stats_json) as f:
            stats = json.load(f)
        with open(dst / "meta" / "stats.json", "w") as f:
            json.dump(mirror_norm_stats(stats, left_dim=left_dim, right_dim=right_dim), f, indent=2)
    eps_stats = src_meta.root / "meta" / "episodes_stats.jsonl"
    if eps_stats.exists():
        rows = _meta.read_jsonl(eps_stats)
        for row in rows:
            for col in DEFAULT_SWAP_COLUMNS:
                entry = row.get("stats", {}).get(col)
                if not entry:
                    continue
                for field, vals in entry.items():
                    vals_arr = np.asarray(vals)
                    if vals_arr.size >= left_dim + right_dim:
                        entry[field] = swap_arms_in_array(vals_arr, left_dim, right_dim).tolist()
        _meta.write_jsonl(dst / "meta" / "episodes_stats.jsonl", rows)
    return out_meta


def create_mirror_and_merge(
    source: pathlib.Path | str,
    dst: pathlib.Path | str,
    *,
    left_dim: int = 7,
    right_dim: int = 7,
) -> _meta.LeRobotMetadata:
    """The whole pipeline: mirror the dataset, then merge the original and the twin into ``dst``."""
    with tempfile.TemporaryDirectory(prefix="mirror_") as tmp:
        mirror_root = pathlib.Path(tmp) / "mirrored"
        create_mirror_dataset(source, mirror_root, left_dim=left_dim, right_dim=right_dim)
        return _split_merge.merge_datasets([source, mirror_root], dst)
