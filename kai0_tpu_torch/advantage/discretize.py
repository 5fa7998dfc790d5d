"""Discretize predicted advantages into ``task_index`` labels and a prompt table.

The port's counterpart of ``kai0_tpu/advantage/discretize.py`` (reference
``stage_advantage/annotation/discretize_advantage.py``), on ``pyarrow``:

- binary mode: frames in the top ``threshold``% of advantage get
  ``task_index`` 1 ("Advantage: positive"), the rest 0 ("Advantage: negative")
  (:211-253);
- ``n_slices`` mode: ``task_index`` 0..n−1 by advantage percentile bins
  (higher advantage, higher index);
- staged mode (``stage_nums`` > 1): a frame's stage is the bin of its
  ``stage_progress_gt`` in [i/stages, (i+1)/stages), and the percentiles are
  taken per stage (:254-318, :60-81);
- ``meta/tasks.jsonl`` is rewritten with the advantage-suffixed prompts
  (:178-209), byte for byte as the JAX package writes it.

``task_index`` is written as int32, the type the JAX package's
``df["task_index"] = _assign(...)`` leaves in its parquets.
"""

from __future__ import annotations

import pathlib

import numpy as np

from kai0_tpu_torch.data import lerobot_meta as _meta

STAGE_COL = "stage_progress_gt"


def _stage_indices(stage_progress: np.ndarray, stage_nums: int) -> np.ndarray:
    if stage_nums == 1:
        return np.zeros(len(stage_progress), dtype=np.int32)
    return np.minimum((np.asarray(stage_progress) * stage_nums).astype(np.int32), stage_nums - 1)


def _column(table, name: str) -> np.ndarray:
    return table.column(name).to_numpy()


def collect_rewards_by_stage(
    parquet_files: list[pathlib.Path], advantage_source: str, stage_nums: int
) -> dict[int, np.ndarray]:
    import pyarrow.parquet as pq

    rewards: dict[int, list[np.ndarray]] = {i: [] for i in range(stage_nums)}
    for path in parquet_files:
        table = pq.read_table(path)
        if advantage_source not in table.column_names:
            raise ValueError(
                f"{path} has no {advantage_source!r} column: run the annotation step "
                "(scripts/annotate_advantage_torch.py) first and point --data-glob at its data_<tag>/ output."
            )
        vals = _column(table, advantage_source).astype(np.float32)
        if stage_nums == 1:
            rewards[0].append(vals)
        else:
            if STAGE_COL not in table.column_names:
                raise ValueError(f"Column {STAGE_COL!r} required when stage_nums > 1 ({path})")
            stages = _stage_indices(_column(table, STAGE_COL), stage_nums)
            for s in range(stage_nums):
                rewards[s].append(vals[stages == s])
    return {
        s: (np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.float32)) for s, chunks in rewards.items()
    }


def reward_statistics(rewards: np.ndarray) -> dict:
    if len(rewards) == 0:
        return {"mean": 0.0, "std": 0.0, "min": 0.0, "max": 0.0, "percentiles": {}}
    pct = list(range(0, 101, 10))
    return {
        "mean": float(np.mean(rewards)),
        "std": float(np.std(rewards)),
        "min": float(np.min(rewards)),
        "max": float(np.max(rewards)),
        "percentiles": dict(zip(pct, np.percentile(rewards, pct).tolist())),
    }


def _assign(
    rewards: np.ndarray,
    stages: np.ndarray,
    *,
    discretion_type: str,
    thresholds: dict[int, float],
    boundaries: dict[int, np.ndarray],
    n_slices: int,
) -> np.ndarray:
    task_index = np.zeros(len(rewards), dtype=np.int32)
    for s in np.unique(stages):
        mask = stages == s
        if discretion_type == "binary":
            task_index[mask] = (rewards[mask] >= thresholds[int(s)]).astype(np.int32)
        elif discretion_type == "n_slices":
            # searchsorted over the lower boundaries: bin i covers [b_i, b_{i+1}).
            b = np.asarray(boundaries[int(s)])
            task_index[mask] = np.clip(np.searchsorted(b, rewards[mask], side="right") - 1, 0, n_slices - 1)
        else:
            raise ValueError(f"Unknown discretion_type: {discretion_type}")
    return task_index


def advantage_task_table(discretion_type: str, n_slices: int, base_prompt: str) -> list[dict]:
    if discretion_type == "binary":
        return [
            {"task_index": 0, "task": f"{base_prompt}, Advantage: negative"},
            {"task_index": 1, "task": f"{base_prompt}, Advantage: positive"},
        ]
    return [{"task_index": i, "task": f"{base_prompt}, Advantage: {i}"} for i in range(n_slices)]


def discretize_dataset(
    data_path: pathlib.Path | str,
    *,
    threshold: float = 70.0,
    discretion_type: str = "binary",
    n_slices: int = 10,
    advantage_source: str = "absolute_advantage",
    stage_nums: int = 1,
    base_prompt: str = "fold the cloth",
    data_glob: str = "data/chunk-*/*.parquet",
    dry_run: bool = False,
) -> dict[int, dict]:
    """Per-stage advantage statistics; unless ``dry_run``, ``task_index`` and ``tasks.jsonl`` rewritten.

    Returns the per-stage statistics.
    """
    import pyarrow as pa
    import pyarrow.parquet as pq

    base = pathlib.Path(data_path)
    parquet_files = sorted(base.glob(data_glob))
    if not parquet_files:
        raise ValueError(f"No parquet files found under {base / data_glob}")

    rewards_by_stage = collect_rewards_by_stage(parquet_files, advantage_source, stage_nums)
    stats = {s: reward_statistics(r) for s, r in rewards_by_stage.items()}

    thresholds: dict[int, float] = {}
    boundaries: dict[int, np.ndarray] = {}
    for s, rewards in rewards_by_stage.items():
        if len(rewards) == 0:
            thresholds[s] = 0.0
            boundaries[s] = np.zeros(n_slices)
            continue
        # Top `threshold`% ⇒ cut at the (100 − threshold) percentile.
        thresholds[s] = float(np.percentile(rewards, 100 - threshold))
        boundaries[s] = np.percentile(rewards, [100 / n_slices * i for i in range(n_slices)])

    if dry_run:
        return stats

    for path in parquet_files:
        table = pq.read_table(path)
        vals = _column(table, advantage_source).astype(np.float32)
        stages = (
            _stage_indices(_column(table, STAGE_COL), stage_nums) if stage_nums > 1 else np.zeros(len(vals), np.int32)
        )
        labels = pa.array(_assign(vals, stages, discretion_type=discretion_type, thresholds=thresholds,
                                  boundaries=boundaries, n_slices=n_slices))
        if "task_index" in table.column_names:
            table = table.set_column(table.column_names.index("task_index"), "task_index", labels)
        else:
            table = table.append_column("task_index", labels)
        pq.write_table(table, path)

    _meta.write_jsonl(base / "meta" / "tasks.jsonl", advantage_task_table(discretion_type, n_slices, base_prompt))
    return stats
