"""Episode-level split and merge of LeRobot datasets, on ``pyarrow``.

The port's copy of ``kai0_tpu/data/split_merge.py:26-252``: ``split_dataset``
shuffles the episodes with ``random.Random(seed)`` and writes each of
``split_num`` parts as a full dataset (episodes renumbered 0..n-1, the global
``index`` rebased, info totals and ``episodes_stats.jsonl`` fixed up);
``merge_datasets`` concatenates datasets after a feature-compatibility check,
renumbering episodes and frames and remapping task indices into the union of
the task tables. Parquet rows are rewritten, videos copied as they are.

The JAX package goes through ``pandas``; the port reads and writes the tables
with ``pyarrow`` (which the card's machine has; ``pandas`` it is not promised)
and writes the same columns, types and values. The tables it writes carry no
``pandas`` schema metadata. The parquet helpers here are shared by
``kai0_tpu_torch.augment``.
"""

from __future__ import annotations

import json
import pathlib
import random
import shutil

import numpy as np

from kai0_tpu_torch.data import lerobot_meta as _meta


def read_table(path: pathlib.Path):
    """An episode's parquet table, without the schema metadata of whatever wrote it."""
    import pyarrow.parquet as pq

    return pq.read_table(path).replace_schema_metadata(None)


def write_table(table, path: pathlib.Path) -> None:
    import pyarrow.parquet as pq

    path.parent.mkdir(parents=True, exist_ok=True)
    pq.write_table(table, path)


def replace_column(table, name: str, values):
    """``table`` with column ``name`` holding ``values`` (a numpy array or a list of row arrays), if it has one."""
    import pyarrow as pa

    if name not in table.column_names:
        return table
    return table.set_column(table.column_names.index(name), name, pa.array(values))


def _rebased(table, *, episode_index: int, frame_start: int):
    """The episode's rows under a new episode index, their global ``index`` counted from ``frame_start``."""
    n = table.num_rows
    table = replace_column(table, "index", np.arange(frame_start, frame_start + n, dtype=np.int64))
    return replace_column(table, "episode_index", np.full(n, episode_index, dtype=np.int64))


# The layout every rewritten episode is written to (merge and time scaling record it in ``info.json``).
DEFAULT_LAYOUT = {"data_path": _meta.DEFAULT_DATA_PATH, "video_path": _meta.DEFAULT_VIDEO_PATH}


def info_with_totals(info: dict, *, episodes: int, frames: int, n_video_keys: int, chunks_size: int) -> dict:
    """A copy of ``info`` with the totals and the one ``train`` split of ``episodes`` episodes of ``frames`` frames."""
    out = dict(info)
    out["total_episodes"] = episodes
    out["total_frames"] = frames
    out["total_videos"] = episodes * n_video_keys
    out["total_chunks"] = (episodes + chunks_size - 1) // chunks_size if episodes else 0
    out["splits"] = {"train": f"0:{episodes}"}
    return out


def _copy_videos(src_meta: _meta.LeRobotMetadata, old_index: int, dst_root: pathlib.Path, new_index: int,
                 chunks_size: int) -> None:
    for video_key in src_meta.video_keys:
        src_video = src_meta.video_path(old_index, video_key)
        if not src_video.exists():
            continue
        dst_video = dst_root / _meta.DEFAULT_VIDEO_PATH.format(
            episode_chunk=new_index // chunks_size, episode_index=new_index, video_key=video_key
        )
        dst_video.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src_video, dst_video)


def _copy_episode_files(
    src_meta: _meta.LeRobotMetadata,
    old_index: int,
    dst_meta_root: pathlib.Path,
    new_index: int,
    new_frame_start: int,
    chunks_size: int,
) -> int:
    """Copy one episode's parquet (re-indexed) and videos; returns its frame count."""
    table = _rebased(read_table(src_meta.data_path(old_index)), episode_index=new_index, frame_start=new_frame_start)
    write_table(table, dst_meta_root / _meta.DEFAULT_DATA_PATH.format(
        episode_chunk=new_index // chunks_size, episode_index=new_index))
    _copy_videos(src_meta, old_index, dst_meta_root, new_index, chunks_size)
    return table.num_rows


def _write_subset(
    src_meta: _meta.LeRobotMetadata, dst_root: pathlib.Path, episode_indices: list[int]
) -> _meta.LeRobotMetadata:
    """Write the selected episodes (renumbered 0..n-1 in sorted order) as a full dataset."""
    old_order = sorted(episode_indices)
    chunks_size = src_meta.chunks_size
    dst_root.mkdir(parents=True, exist_ok=True)

    episodes_by_index = {ep["episode_index"]: ep for ep in src_meta.episodes}
    new_episodes = []
    frame_cursor = 0
    for new_index, old_index in enumerate(old_order):
        n = _copy_episode_files(src_meta, old_index, dst_root, new_index, frame_cursor, chunks_size)
        row = dict(episodes_by_index[old_index])
        row["episode_index"] = new_index
        new_episodes.append(row)
        frame_cursor += n

    info = info_with_totals(src_meta.info, episodes=len(old_order), frames=frame_cursor,
                            n_video_keys=len(src_meta.video_keys), chunks_size=chunks_size)

    dst_meta = _meta.LeRobotMetadata(root=dst_root, info=info, episodes=new_episodes, tasks=dict(src_meta.tasks))
    dst_meta.save()

    # episodes_stats.jsonl: the per-episode stats kept, the running frame index rebased (reference
    # split_lerobot.py:62-84).
    stats_path = src_meta.root / "meta" / "episodes_stats.jsonl"
    if stats_path.exists():
        stats = {s["episode_index"]: s for s in _meta.read_jsonl(stats_path)}
        new_stats = []
        cursor = 0
        for new_index, old_index in enumerate(old_order):
            if old_index not in stats:
                continue
            row = json.loads(json.dumps(stats[old_index]))  # deep copy
            row["episode_index"] = new_index
            idx = row.get("stats", {}).get("index")
            if idx is not None:
                count = int(idx["count"][0])
                idx["min"] = [cursor]
                idx["max"] = [cursor + count - 1]
                idx["mean"] = [(2 * cursor + count - 1) / 2]
                idx["std"] = [float(np.std(np.arange(cursor, cursor + count)))]
                cursor += count
            new_stats.append(row)
        _meta.write_jsonl(dst_root / "meta" / "episodes_stats.jsonl", new_stats)

    return dst_meta


def split_dataset(
    source: pathlib.Path | str,
    dst: pathlib.Path | str,
    split_num: int = 4,
    seed: int = 42,
) -> list[pathlib.Path]:
    """Shuffle the episodes and split them into ``split_num`` disjoint full datasets ``dst/split_<i>``."""
    src_meta = _meta.LeRobotMetadata.load(source)
    dst = pathlib.Path(dst)
    episode_indices = [ep["episode_index"] for ep in src_meta.episodes]
    random.Random(seed).shuffle(episode_indices)
    outputs = []
    for i, part in enumerate(np.array_split(np.asarray(episode_indices), split_num)):
        out = dst / f"split_{i}"
        _write_subset(src_meta, out, [int(x) for x in part])
        outputs.append(out)
    return outputs


def ensure_features_compatible(
    tgt_info: dict, src_info: dict, src_name: str, *, force: bool = False
) -> list[str]:
    """Check that fps and the feature schemas match; returns the mismatches as warnings (raises unless ``force``)."""
    warnings = []
    if tgt_info["fps"] != src_info["fps"]:
        msg = f"{src_name}: fps mismatch ({src_info['fps']} vs {tgt_info['fps']})"
        if not force:
            raise ValueError(msg)
        warnings.append(msg)
    tgt_feats, src_feats = tgt_info["features"], src_info["features"]
    for key in sorted(set(tgt_feats) | set(src_feats)):
        if key not in src_feats or key not in tgt_feats:
            msg = f"{src_name}: feature {key!r} present in only one dataset"
            if not force:
                raise ValueError(msg)
            warnings.append(msg)
            continue
        for field in ("dtype", "shape"):
            if list(np.atleast_1d(tgt_feats[key].get(field, []))) != list(
                np.atleast_1d(src_feats[key].get(field, []))
            ):
                msg = f"{src_name}: feature {key!r} {field} mismatch"
                if not force:
                    raise ValueError(msg)
                warnings.append(msg)
    return warnings


def merge_datasets(
    sources: list[pathlib.Path | str],
    dst: pathlib.Path | str,
    *,
    force: bool = False,
) -> _meta.LeRobotMetadata:
    """Concatenate LeRobot datasets into one, renumbering episodes, frames and tasks."""
    if not sources:
        raise ValueError("Need at least one source dataset")
    metas = [_meta.LeRobotMetadata.load(s) for s in sources]
    warnings: list[str] = []
    for m in metas[1:]:
        warnings += ensure_features_compatible(metas[0].info, m.info, str(m.root), force=force)
    for w in warnings:
        print(f"WARNING: {w}")

    dst = pathlib.Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    chunks_size = metas[0].chunks_size

    # The merged task table: the union of the task strings in first-seen order.
    merged_tasks: dict[str, int] = {}
    for m in metas:
        for _, task in sorted(m.tasks.items()):
            if task not in merged_tasks:
                merged_tasks[task] = len(merged_tasks)

    new_episodes = []
    new_index = 0
    frame_cursor = 0
    for m in metas:
        task_remap = {old: merged_tasks[task] for old, task in m.tasks.items()}
        for ep in m.episodes:
            old_index = ep["episode_index"]
            table = _rebased(read_table(m.data_path(old_index)), episode_index=new_index, frame_start=frame_cursor)
            if "task_index" in table.column_names:
                old_tasks = table.column("task_index").to_pylist()
                table = replace_column(
                    table, "task_index", np.asarray([task_remap.get(int(t), int(t)) for t in old_tasks], np.int64))
            write_table(table, dst / _meta.DEFAULT_DATA_PATH.format(
                episode_chunk=new_index // chunks_size, episode_index=new_index))
            _copy_videos(m, old_index, dst, new_index, chunks_size)

            row = dict(ep)
            row["episode_index"] = new_index
            new_episodes.append(row)
            new_index += 1
            frame_cursor += table.num_rows

    info = info_with_totals(metas[0].info, episodes=new_index, frames=frame_cursor,
                            n_video_keys=len(metas[0].video_keys), chunks_size=chunks_size)
    info.update(total_tasks=len(merged_tasks), **DEFAULT_LAYOUT)

    merged = _meta.LeRobotMetadata(root=dst, info=info, episodes=new_episodes,
                                   tasks={i: t for t, i in merged_tasks.items()})
    merged.save()
    return merged
