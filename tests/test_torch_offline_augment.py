"""The port's offline dataset tools against the JAX package's, output for output.

A synthetic dual-arm LeRobot dataset (2 episodes × 10 frames, three 32×32
mp4 cameras, 14-dim state and action, two tasks, with ``meta/stats.json`` and
``meta/episodes_stats.jsonl``), written by ``kai0_tpu.data.lerobot_writer``
from a numpy seed, goes through each tool of both packages: the mirror, the
mirror-and-merge, time scaling (full, and split with one seed), split,
merge (with a third dataset whose task table differs), the feature-mismatch
check with and without ``force``, and the HDF5 conversion. The two outputs
must agree: parquet columns read back through ``pyarrow`` bit-equal (names,
types and values), the meta files equal as parsed JSON, and each video with
the same frame count and a mean abs difference under 30 (the mp4 bound of
``tests/test_augment.py``). Each package's ``LeRobotDataset`` also reads the
other's output, item for item.
"""

import json
import pathlib

import numpy as np
import pyarrow.parquet as pq
import pytest

from kai0_tpu.augment import convert_h5 as jax_convert_h5
from kai0_tpu.augment import space_mirroring as jax_mirroring
from kai0_tpu.augment import time_scaling as jax_time_scaling
from kai0_tpu.data import lerobot_dataset as jax_lerobot
from kai0_tpu.data import split_merge as jax_split_merge
from kai0_tpu.data.lerobot_writer import LeRobotDatasetWriter, feature_spec
from kai0_tpu_torch.augment import convert_h5, space_mirroring, time_scaling
from kai0_tpu_torch.data import lerobot_dataset, split_merge

from _torch_parity import assert_same, worker_share_of_torch_threads  # noqa: F401

CAMERAS = ("top_head", "hand_left", "hand_right")
FRAMES = 10
META_FILES = ("info.json", "episodes.jsonl", "tasks.jsonl", "stats.json", "episodes_stats.jsonl")
VIDEO_TOL = 30.0


def _write_dataset(root: pathlib.Path, rng: np.random.Generator, tasks: list[str], state_dim: int = 14,
                   fps: int = 10) -> pathlib.Path:
    feats = feature_spec(state_dim=state_dim, action_dim=state_dim, cameras={c: (32, 32) for c in CAMERAS}, fps=fps)
    writer = LeRobotDatasetWriter(root, feats, fps=fps)
    episode_stats = []
    for ep, task in enumerate(tasks):
        state = rng.uniform(-1, 1, (FRAMES, state_dim)).astype(np.float32)
        writer.add_episode(
            {"observation.state": state, "action": rng.uniform(-1, 1, (FRAMES, state_dim)).astype(np.float32)},
            task=task,
            videos={f"observation.images.{c}": rng.integers(0, 255, (FRAMES, 32, 32, 3)).astype(np.uint8)
                    for c in CAMERAS},
        )
        first = ep * FRAMES
        episode_stats.append({"episode_index": ep, "stats": {
            "observation.state": {"min": state.min(0).tolist(), "max": state.max(0).tolist(),
                                  "mean": state.mean(0).tolist(), "count": [FRAMES]},
            "index": {"min": [first], "max": [first + FRAMES - 1], "mean": [first + (FRAMES - 1) / 2],
                      "std": [float(np.std(np.arange(FRAMES)))], "count": [FRAMES]}}})
    writer.finalize()
    stats = {key: {"mean": rng.normal(size=state_dim).tolist(), "std": rng.uniform(0.1, 1, state_dim).tolist(),
                   "count": [len(tasks) * FRAMES]} for key in ("observation.state", "action")}
    (root / "meta" / "stats.json").write_text(json.dumps(stats, indent=2))
    (root / "meta" / "episodes_stats.jsonl").write_text("".join(json.dumps(r) + "\n" for r in episode_stats))
    return root


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    return _write_dataset(tmp_path_factory.mktemp("offline") / "src", np.random.default_rng(0), ["fold", "hang"])


@pytest.fixture(scope="module")
def other(tmp_path_factory):
    """A second dataset: one episode whose task table is {0: "hang"} (index 1 in the merged table)."""
    return _write_dataset(tmp_path_factory.mktemp("offline") / "other", np.random.default_rng(1), ["hang"])


def _frames(path: pathlib.Path) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames).astype(np.float32)


def _assert_same_dataset(ours: pathlib.Path, theirs: pathlib.Path) -> None:
    """Parquet columns bit-equal, meta files equal as parsed JSON, videos within the mp4 bound."""
    files = {kind: [sorted(p.relative_to(root) for p in root.rglob(f"*.{kind}")) for root in (ours, theirs)]
             for kind in ("parquet", "mp4")}
    for kind, (a, b) in files.items():
        assert a == b and a, (kind, a, b)
    for rel in files["parquet"][0]:
        a, b = pq.read_table(ours / rel), pq.read_table(theirs / rel)
        assert a.column_names == b.column_names, rel
        for name in a.column_names:
            assert a.column(name).type == b.column(name).type, (rel, name, a.column(name).type, b.column(name).type)
            assert a.column(name).to_pylist() == b.column(name).to_pylist(), (rel, name)
    for meta in {p.parent for p in ours.rglob("meta/info.json")}:
        rel = meta.relative_to(ours)
        for name in META_FILES:
            a, b = meta / name, theirs / rel / name
            assert a.exists() == b.exists(), (rel, name)
            if a.exists():
                parse = json.loads if name.endswith(".json") else lambda t: [json.loads(x) for x in t.splitlines()]
                assert parse(a.read_text()) == parse(b.read_text()), (rel, name)
    for rel in files["mp4"][0]:
        a, b = _frames(ours / rel), _frames(theirs / rel)
        assert a.shape == b.shape, (rel, a.shape, b.shape)
        assert np.abs(a - b).mean() < VIDEO_TOL, rel


def _assert_readers_agree(root: pathlib.Path) -> None:
    """Both packages' readers give the same items of a dataset."""
    kwargs = dict(action_horizon=4, action_sequence_keys=("action",))
    ours, theirs = lerobot_dataset.LeRobotDataset(str(root), **kwargs), jax_lerobot.LeRobotDataset(str(root), **kwargs)
    assert len(ours) == len(theirs)
    for i in sorted({0, len(ours) // 2, len(ours) - 1}):
        assert_same(theirs[i], ours[i])


def test_mirror_dataset_matches_jax(source, tmp_path):
    ours = space_mirroring.create_mirror_dataset(source, tmp_path / "ours")
    jax_mirroring.create_mirror_dataset(source, tmp_path / "jax")
    _assert_same_dataset(tmp_path / "ours", tmp_path / "jax")
    state = np.stack(pq.read_table(ours.data_path(0)).column("observation.state").to_numpy(zero_copy_only=False))
    original = np.stack(pq.read_table(lerobot_dataset._meta.LeRobotMetadata.load(source).data_path(0))
                        .column("observation.state").to_numpy(zero_copy_only=False))
    np.testing.assert_array_equal(state[:, :7], original[:, 7:])
    stats = json.loads((tmp_path / "ours" / "meta" / "stats.json").read_text())
    source_stats = json.loads((source / "meta" / "stats.json").read_text())
    assert stats["action"]["mean"] == source_stats["action"]["mean"][7:] + source_stats["action"]["mean"][:7]


def test_mirror_and_merge_matches_jax_and_reads_both_ways(source, tmp_path):
    merged = space_mirroring.create_mirror_and_merge(source, tmp_path / "ours")
    jax_mirroring.create_mirror_and_merge(source, tmp_path / "jax")
    assert merged.info["total_episodes"] == 4 and merged.info["total_frames"] == 4 * FRAMES
    _assert_same_dataset(tmp_path / "ours", tmp_path / "jax")
    # The interchange: each package's reader on the other's output.
    _assert_readers_agree(tmp_path / "jax")
    _assert_readers_agree(tmp_path / "ours")


@pytest.mark.parametrize("split", [False, True], ids=["full", "split"])
def test_time_scaling_matches_jax(source, tmp_path, split):
    if split:
        ours = time_scaling.time_scaling_with_split(source, tmp_path / "ours", 2, extract_fraction=0.5, seed=0)
        jax_time_scaling.time_scaling_with_split(source, tmp_path / "jax", 2, extract_fraction=0.5, seed=0)
        assert ours.info["total_frames"] == FRAMES + FRAMES // 2
    else:
        ours = time_scaling.time_scale_dataset(source, tmp_path / "ours", 2)
        jax_time_scaling.time_scale_dataset(source, tmp_path / "jax", 2)
        assert ours.info["total_frames"] == FRAMES
        assert pq.read_table(ours.data_path(1)).column("timestamp").type == "double"
    _assert_same_dataset(tmp_path / "ours", tmp_path / "jax")


def test_split_then_merge_matches_jax(source, other, tmp_path):
    for pkg, name in ((split_merge, "ours"), (jax_split_merge, "jax")):
        parts = pkg.split_dataset(source, tmp_path / name / "split", split_num=2, seed=3)
        assert [p.name for p in parts] == ["split_0", "split_1"]
        pkg.merge_datasets([parts[1], other, parts[0]], tmp_path / name / "merged")
    _assert_same_dataset(tmp_path / "ours", tmp_path / "jax")
    merged = lerobot_dataset._meta.LeRobotMetadata.load(tmp_path / "ours" / "merged")
    assert merged.tasks == {0: "fold", 1: "hang"} and merged.info["total_episodes"] == 3
    tasks = pq.read_table(merged.data_path(1)).column("task_index").to_pylist()
    assert tasks == [1] * FRAMES  # the other dataset's task 0 ("hang") remapped


def test_feature_mismatch_raises_and_force_merges_alike(source, tmp_path, capsys):
    wide = _write_dataset(tmp_path / "wide", np.random.default_rng(2), ["fold"], state_dim=16, fps=15)
    for pkg in (split_merge, jax_split_merge):
        with pytest.raises(ValueError, match="fps mismatch"):
            pkg.merge_datasets([source, wide], tmp_path / "refused")
    ours = split_merge.ensure_features_compatible(
        json.loads((source / "meta" / "info.json").read_text()), json.loads((wide / "meta" / "info.json").read_text()),
        "wide", force=True)
    assert ours == jax_split_merge.ensure_features_compatible(
        json.loads((source / "meta" / "info.json").read_text()), json.loads((wide / "meta" / "info.json").read_text()),
        "wide", force=True)
    assert len(ours) == 3  # fps, and the shapes of state and action
    for pkg, name in ((split_merge, "ours"), (jax_split_merge, "jax")):
        pkg.merge_datasets([source, wide], tmp_path / name, force=True)
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 6 and printed[:3] == printed[3:]
    _assert_same_dataset(tmp_path / "ours", tmp_path / "jax")


def test_convert_h5_matches_jax(tmp_path):
    from kai0_tpu.deploy.dagger import DAggerCollector

    collector = DAggerCollector(["top", "wrist"], tmp_path / "h5", fps=10)
    rng = np.random.default_rng(4)
    for length in (6, 7):
        collector.start_collection()
        for i in range(length):
            collector.add_frame(
                {"qpos": rng.uniform(-1, 1, 14).astype(np.float32),
                 "images": {c: rng.integers(0, 255, (32, 32, 3)).astype(np.uint8) for c in ("top", "wrist")}},
                action=np.full(14, i, dtype=np.float32),
            )
        collector.save_episode()
    kwargs = dict(task="fold", cameras=["top", "wrist"], fps=10)
    ours = convert_h5.convert_h5_to_lerobot(tmp_path / "h5", tmp_path / "ours", **kwargs)
    jax_convert_h5.convert_h5_to_lerobot(tmp_path / "h5", tmp_path / "jax", **kwargs)
    assert ours.info["total_episodes"] == 2 and ours.info["total_frames"] == 13
    _assert_same_dataset(tmp_path / "ours", tmp_path / "jax")
    _assert_readers_agree(tmp_path / "jax")


def test_convert_h5_without_h5py_names_the_package(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="convert_h5_to_lerobot needs h5py"):
        convert_h5.convert_h5_to_lerobot(tmp_path, tmp_path / "out", task="fold", cameras=["top"])
