"""Compute a config's normalization statistics through the port's data pipeline.

The counterpart of ``scripts/compute_norm_stats.py``, without JAX:

    python3 scripts/compute_norm_stats_torch.py <config_name> [--max_frames N] [--batch_size B]

Reads the config's dataset through ``kai0_tpu_torch.training.data_loader.create_dataset`` (so the train-time
mirror and time-scale views apply when the config sets ``augment_mirror`` / ``augment_time_scale``), runs the repack
and robot data transforms (everything before Normalize), feeds ``state`` and ``actions`` in order, a batch at a
time, into ``RunningStats`` and writes ``norm_stats.json`` under ``<assets_dirs>/<asset_id or repo_id>``: the file
the training entry point reads. Frames past the last whole batch are left out, as in the JAX script.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

KEYS = ("state", "actions")


class RemoveStrings:
    """Strings are not needed for stats and cannot be stacked uniformly."""

    def __call__(self, x: dict) -> dict:
        return {k: v for k, v in x.items() if not np.issubdtype(np.asarray(v).dtype, np.str_)}


def compute(config, max_frames: int | None = None, batch_size: int | None = None) -> pathlib.Path:
    """Write the norm stats of a ``TrainConfig``'s dataset; returns the directory written to."""
    from kai0_tpu_torch.shared import normalize
    from kai0_tpu_torch.training import data_loader as _data_loader

    data_config = config.data.create(config.assets_dirs, config.model)
    if data_config.repo_id is None:
        raise ValueError("Data config must have a repo_id")
    dataset = _data_loader.TransformedDataset(
        _data_loader.create_dataset(data_config, config.model),
        [*data_config.repack_transforms.inputs, *data_config.data_transforms.inputs, RemoveStrings()],
    )

    bs = batch_size or config.batch_size
    num_frames = len(dataset) if max_frames is None else min(max_frames, len(dataset))
    starts = range(0, num_frames - num_frames % bs, bs)
    stats = {key: normalize.RunningStats() for key in KEYS}
    print(f"Computing stats over {len(starts) * bs} of {len(dataset)} frames in batches of {bs}")
    for n, start in enumerate(starts, 1):
        batch = [dataset[i] for i in range(start, start + bs)]
        for key in KEYS:
            stats[key].update(np.stack([np.asarray(item[key]) for item in batch]))
        if n == len(starts) or n % max(1, len(starts) // 10) == 0:
            print(f"  batch {n}/{len(starts)}")

    output_path = config.assets_dirs / (data_config.asset_id or data_config.repo_id)
    print(f"Writing stats to: {output_path}")
    normalize.save(output_path, {key: s.get_statistics() for key, s in stats.items()})
    return output_path


def main(config_name: str, max_frames: int | None = None, batch_size: int | None = None) -> pathlib.Path:
    from kai0_tpu_torch.training import config as _config

    return compute(_config.get_config(config_name), max_frames, batch_size)


def cli() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("config_name")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    args = parser.parse_args()
    main(args.config_name, args.max_frames, args.batch_size)


if __name__ == "__main__":
    cli()
