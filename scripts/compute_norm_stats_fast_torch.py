"""Compute normalization statistics straight from a LeRobot dataset's parquet files.

The counterpart of ``scripts/compute_norm_stats_fast.py``, without JAX or pandas:

    python3 scripts/compute_norm_stats_fast_torch.py <config_name> [--base_dir DIR] [--max_frames N]

Reads every ``*.parquet`` under the dataset root (in sorted order; a file that does not read is skipped with a
printed line) with ``pyarrow``: no video decode and no transforms. State and action values outside [-π, π] become 0,
the vectors are padded (or cut) to the model's ``action_dim``, and ``RunningStats`` takes them in batches of 32 (the
accumulation order of the JAX script, so the statistics are its bit for bit). Keys with fewer than 2 vectors are
left out. Writes ``norm_stats.json`` under ``<assets_dirs>/<asset_id or repo_id>``.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

STATE_COL = "observation.state"
ACTION_COL = "action"
ACCUM_BATCH = 32  # the JAX script's accumulation batch: the same batches give the same bits


def _clamp_and_pad(data: np.ndarray, target_dim: int) -> np.ndarray:
    """Zero out values outside [-pi, pi], then pad or cut the last dim to ``target_dim``."""
    data = np.asarray(data, dtype=np.float64)
    data = np.where(np.abs(data) > np.pi, 0.0, data)
    if data.shape[-1] >= target_dim:
        return data[..., :target_dim]
    pad = np.zeros((*data.shape[:-1], target_dim - data.shape[-1]))
    return np.concatenate([data, pad], axis=-1)


def _rows(table, column: str, take: int) -> np.ndarray:
    return np.stack([np.asarray(x) for x in table.column(column).slice(0, take).to_numpy(zero_copy_only=False)])


def compute_stats_from_parquet(base_dir: str | pathlib.Path, action_dim: int, max_frames: int | None = None) -> dict:
    """``{"state", "actions"}`` → ``NormStats`` of the parquet files under ``base_dir``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from kai0_tpu_torch.shared import normalize

    base_path = pathlib.Path(base_dir)
    if not base_path.exists():
        raise ValueError(f"Base directory does not exist: {base_dir}")
    parquet_files = sorted(str(p) for p in base_path.rglob("*.parquet"))
    print(f"Found {len(parquet_files)} parquet files under {base_dir}")

    collected: dict[str, list[np.ndarray]] = {"state": [], "actions": []}
    total_frames = 0
    for file_path in parquet_files:
        try:
            table = pq.read_table(file_path)
        except (OSError, pa.ArrowException) as e:  # an unreadable shard is skipped, as the JAX script does
            print(f"Failed to read {file_path}: {e}")
            continue
        if STATE_COL not in table.column_names or ACTION_COL not in table.column_names:
            continue
        take = table.num_rows
        if max_frames is not None:
            take = min(take, max_frames - total_frames)
            if take <= 0:
                break
        collected["state"].append(_clamp_and_pad(_rows(table, STATE_COL, take), action_dim))
        collected["actions"].append(_clamp_and_pad(_rows(table, ACTION_COL, take), action_dim))
        total_frames += take

    print(f"Collected {total_frames} frames")
    stats = {key: normalize.RunningStats() for key in collected}
    for key, chunks in collected.items():
        if not chunks:
            print(f"Warning: no data for key {key!r}")
            continue
        data = np.concatenate(chunks, axis=0)
        for i in range(0, len(data), ACCUM_BATCH):
            stats[key].update(data[i : i + ACCUM_BATCH])
        print(f"Accumulated {key}: {len(data)} vectors in batches of {ACCUM_BATCH}")
    return {key: s.get_statistics() for key, s in stats.items() if s.count > 1}


def compute(config, base_dir: str | None = None, max_frames: int | None = None) -> pathlib.Path:
    """Write the norm stats of a ``TrainConfig``'s dataset (or of ``base_dir``); returns the directory written to."""
    from kai0_tpu_torch.data import lerobot_dataset
    from kai0_tpu_torch.shared import normalize

    data_config = config.data.create(config.assets_dirs, config.model)
    if base_dir is None:
        if data_config.repo_id is None:
            raise ValueError("Either base_dir must be provided or config must have repo_id")
        base_dir = str(lerobot_dataset.resolve_dataset_root(data_config.repo_id))
        print(f"Auto-detected base directory from config: {base_dir}")

    norm_stats = compute_stats_from_parquet(base_dir, config.model.action_dim, max_frames)

    output_path = config.assets_dirs / (data_config.asset_id or data_config.repo_id)
    print(f"Writing stats to: {output_path}")
    normalize.save(output_path, norm_stats)
    return output_path


def main(config_name: str, base_dir: str | None = None, max_frames: int | None = None) -> pathlib.Path:
    from kai0_tpu_torch.training import config as _config

    return compute(_config.get_config(config_name), base_dir, max_frames)


def cli() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("config_name")
    parser.add_argument("--base_dir", default=None)
    parser.add_argument("--max_frames", type=int, default=None)
    args = parser.parse_args()
    main(args.config_name, args.base_dir, args.max_frames)


if __name__ == "__main__":
    cli()
