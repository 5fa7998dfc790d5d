"""Annotate a LeRobot dataset with predicted per-frame advantages.

The port's counterpart of ``kai0_tpu/advantage/annotate.py`` (reference
``stage_advantage/annotation/eval.py``, :107-124 and :161-224): the episode
loop over the dataset, the estimator's batched values over the three camera
videos, and a copy of each episode's parquet with the ``relative_advantage``,
``absolute_value`` and ``absolute_advantage`` columns appended (f64, those the
mode produces), written to ``data_<tag>/`` beside ``data/``. Parquet is read
and written with ``pyarrow``.
"""

from __future__ import annotations

import logging
import pathlib

import numpy as np

from kai0_tpu_torch.advantage.evaluator import SimpleValueEvaluator
from kai0_tpu_torch.data import lerobot_meta as _meta

logger = logging.getLogger("kai0_tpu_torch")

ADVANTAGE_COLS = ("relative_advantage", "absolute_value", "absolute_advantage")


def edit_parquet_file(src_parquet: pathlib.Path, output_path: pathlib.Path, results: list[dict]) -> None:
    """A copy of the source parquet with the predicted advantage columns appended."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = pq.read_table(src_parquet)
    if len(results) != table.num_rows:
        raise ValueError(f"{src_parquet}: {len(results)} results for {table.num_rows} frames")
    for col in ADVANTAGE_COLS:
        if col not in table.column_names and results and col in results[0]:
            table = table.append_column(col, pa.array(np.asarray([r[col] for r in results], dtype=np.float64)))
    output_path.parent.mkdir(parents=True, exist_ok=True)
    pq.write_table(table, output_path)


def annotate_dataset(
    evaluator: SimpleValueEvaluator,
    repo_root: pathlib.Path | str,
    *,
    prompt: str,
    output_tag: str,
    cameras: tuple[str, str, str] = ("top_head", "hand_left", "hand_right"),
    mode: str = "2timesteps",
    relative_interval: int = 50,
    batch_size: int | None = None,
    overwrite: bool = False,
) -> list[pathlib.Path]:
    """Run the evaluator over every episode; returns the parquet paths written."""
    meta = _meta.LeRobotMetadata.load(repo_root)
    repo_root = pathlib.Path(repo_root)
    written = []
    for ep in meta.episodes:
        i = ep["episode_index"]
        parquet_file = meta.data_path(i)
        if not parquet_file.exists():
            logger.warning(f"Parquet {parquet_file} not found, skipping")
            continue
        video_paths = [meta.video_path(i, f"observation.images.{cam}") for cam in cameras]
        if not all(p.exists() for p in video_paths):
            # Some datasets key their videos without the observation.images prefix.
            video_paths = [meta.video_path(i, cam) for cam in cameras]
        if not all(p.exists() for p in video_paths):
            logger.warning(f"Missing video file(s) for episode {i}, skipping")
            continue

        output_path = repo_root / f"data_{output_tag}" / parquet_file.relative_to(repo_root / "data")
        if output_path.exists() and not overwrite:
            logger.info(f"Output {output_path} exists, skipping")
            continue

        if mode == "1timestep":
            results = evaluator.evaluate_video_1timestep_advantage(video_paths, prompt, batch_size=batch_size)
        else:
            results = evaluator.evaluate_video_2timesteps_advantages(
                video_paths, prompt, batch_size=batch_size, relative_interval=relative_interval
            )
        edit_parquet_file(parquet_file, output_path, results)
        written.append(output_path)
    return written
