"""Discretize predicted advantages into task_index labels, with the PyTorch port's tools (no card needed).

The command line of ``stage_advantage/annotation/discretize_advantage.py``:
percentile-threshold labels (binary or n slices, optionally per progress
stage) for every frame, and a rewritten ``meta/tasks.jsonl`` with
advantage-suffixed prompts, which ``pi05_*_awbc`` then trains on.

    python3 scripts/discretize_advantage_torch.py <dataset_path> --threshold 30 \\
        --discretion-type binary --advantage-source absolute_advantage \\
        --stage-nums 2 --dry-run
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("data_path")
    parser.add_argument("--threshold", type=float, default=70.0,
                        help="Top threshold%% of frames get task_index=1 (binary mode)")
    parser.add_argument("--discretion-type", choices=["binary", "n_slices"], default="binary")
    parser.add_argument("--n-slices", type=int, default=10)
    parser.add_argument("--advantage-source", choices=["absolute_advantage", "relative_advantage"],
                        default="absolute_advantage")
    parser.add_argument("--stage-nums", type=int, default=1,
                        help="Per-stage percentiles using each frame's stage_progress_gt")
    parser.add_argument("--base-prompt", default="fold the cloth")
    parser.add_argument("--data-glob", default="data/chunk-*/*.parquet",
                        help="Glob for the parquet shards to label (e.g. data_KAI0_30000/...)")
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)

    from kai0_tpu_torch.advantage.discretize import discretize_dataset

    stats = discretize_dataset(
        args.data_path,
        threshold=args.threshold,
        discretion_type=args.discretion_type,
        n_slices=args.n_slices,
        advantage_source=args.advantage_source,
        stage_nums=args.stage_nums,
        base_prompt=args.base_prompt,
        data_glob=args.data_glob,
        dry_run=args.dry_run,
    )
    for stage, s in stats.items():
        print(f"stage {stage}: mean={s['mean']:.6f} std={s['std']:.6f} min={s['min']:.6f} max={s['max']:.6f}")
        for p, v in s["percentiles"].items():
            print(f"  {p:3d}%: {v:.6f}")
    if args.dry_run:
        print("Dry run - no files modified")
    else:
        print("task_index and tasks.jsonl updated")


if __name__ == "__main__":
    main()
