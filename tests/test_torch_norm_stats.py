"""The port's norm-stats scripts against the JAX package's: the same ``norm_stats.json``, byte for byte.

A synthetic dual-arm LeRobot dataset (2 episodes × 10 frames, three 32×32
mp4 cameras, 14-dim state and action), written by
``kai0_tpu.data.lerobot_writer`` from a numpy seed, is the dataset of
``pi05_flatten_fold_normal`` in both packages (``repo_id`` the dataset,
``asset_id`` "synthetic", each package its own assets directory). JAX's
scripts run through their ``main`` with ``kai0_tpu.training.config.get_config``
monkeypatched to that config; the port's through theirs with the port's
``get_config`` patched alike.

- ``scripts/compute_norm_stats_torch.py`` against ``scripts/compute_norm_stats.py``,
  without and with the train-time views (``augment_mirror``; ``augment_mirror``
  and ``augment_time_scale=2``).
- ``scripts/compute_norm_stats_fast_torch.py`` against
  ``scripts/compute_norm_stats_fast.py``, on the dataset and on one whose
  values reach beyond ±π (the clamp to 0) with a shard that does not read
  (skipped with a printed line); the clamp and the pad to ``action_dim``
  checked on their own.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

from kai0_tpu.data.lerobot_writer import LeRobotDatasetWriter, feature_spec
from kai0_tpu.training import config as jax_config
from kai0_tpu_torch.training import config as torch_config

from _torch_parity import worker_share_of_torch_threads  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
CAMERAS = ("top_head", "hand_left", "hand_right")
FRAMES = 10
CONFIG = "pi05_flatten_fold_normal"


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"norm_stats_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_dataset(root: pathlib.Path, seed: int, scale: float) -> pathlib.Path:
    writer = LeRobotDatasetWriter(
        root, feature_spec(state_dim=14, action_dim=14, cameras={c: (32, 32) for c in CAMERAS}, fps=10), fps=10)
    rng = np.random.default_rng(seed)
    for task in ("fold the cloth", "hang the shirt"):
        writer.add_episode(
            {"observation.state": rng.uniform(-scale, scale, (FRAMES, 14)).astype(np.float32),
             "action": rng.uniform(-scale, scale, (FRAMES, 14)).astype(np.float32)},
            task=task,
            videos={f"observation.images.{c}": rng.integers(0, 255, (FRAMES, 32, 32, 3)).astype(np.uint8)
                    for c in CAMERAS},
        )
    writer.finalize()
    return root


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    return _write_dataset(tmp_path_factory.mktemp("norm_stats") / "agilex", seed=0, scale=1.0)


@pytest.fixture(scope="module")
def wide_root(tmp_path_factory):
    """Values in [-5, 5] (about 37% beyond ±π) and a shard that is not parquet."""
    root = _write_dataset(tmp_path_factory.mktemp("norm_stats") / "wide", seed=1, scale=5.0)
    (root / "data" / "chunk-000" / "episode_000099.parquet").write_bytes(b"not a parquet file")
    return root


def _configs(root: pathlib.Path, tmp_path: pathlib.Path, **flags) -> dict:
    """Each package's ``CONFIG`` on ``root`` with its own assets directory."""
    out = {}
    for name, pkg in (("torch", torch_config), ("jax", jax_config)):
        cfg = pkg.get_config(CONFIG)
        data = dataclasses.replace(cfg.data, repo_id=str(root), assets=pkg.AssetsConfig(asset_id="synthetic"),
                                   base_config=pkg.DataConfig(**flags))
        out[name] = dataclasses.replace(cfg, data=data, assets_base_dir=str(tmp_path / name))
    return out


def _run(monkeypatch, configs: dict, torch_script: str, jax_script: str, *args) -> tuple[bytes, bytes]:
    """Both scripts' ``main(CONFIG, *args)``; the bytes of the two ``norm_stats.json`` files."""
    monkeypatch.setattr(torch_config, "get_config", lambda name: configs["torch"])
    monkeypatch.setattr(jax_config, "get_config", lambda name: configs["jax"])
    ours = _script(torch_script).main(CONFIG, *args)
    theirs = _script(jax_script).main(CONFIG, *args)
    assert ours == configs["torch"].assets_dirs / "synthetic" and theirs == configs["jax"].assets_dirs / "synthetic"
    return (ours / "norm_stats.json").read_bytes(), (theirs / "norm_stats.json").read_bytes()


@pytest.mark.parametrize("flags", [{}, {"augment_mirror": True}, {"augment_mirror": True, "augment_time_scale": 2}],
                         ids=["plain", "mirror", "mirror_time_scale"])
def test_norm_stats_byte_equal_to_jax(dataset_root, tmp_path, monkeypatch, flags):
    configs = _configs(dataset_root, tmp_path, **flags)
    ours, theirs = _run(monkeypatch, configs, "compute_norm_stats_torch", "compute_norm_stats", None, 4)
    assert ours == theirs
    plain = _script("compute_norm_stats_torch").compute(_configs(dataset_root, tmp_path / "plain")["torch"], None, 4)
    assert ((plain / "norm_stats.json").read_bytes() == ours) == (not flags)  # the views move the statistics


@pytest.mark.parametrize("wide", [False, True], ids=["dataset", "beyond_pi"])
def test_fast_norm_stats_byte_equal_to_jax(dataset_root, wide_root, tmp_path, monkeypatch, capsys, wide):
    configs = _configs(wide_root if wide else dataset_root, tmp_path, augment_mirror=True)
    ours, theirs = _run(monkeypatch, configs, "compute_norm_stats_fast_torch", "compute_norm_stats_fast")
    assert ours == theirs
    # "Failed to read <path>: <error>": the same shard from both (pandas words the error its own way)
    failed = [line.split(": ")[0] for line in capsys.readouterr().out.splitlines() if line.startswith("Failed to read")]
    assert len(failed) == (2 if wide else 0) and failed[:1] == failed[1:]


def test_fast_clamp_and_pad():
    fast = _script("compute_norm_stats_fast_torch")
    # float32(π) rounds up, past π: it is clamped too; -3.1415 stays
    data = np.array([[0.5, -3.2, 3.1, np.pi, -3.1415, -4.0]], dtype=np.float32)
    out = fast._clamp_and_pad(data, 8)
    np.testing.assert_array_equal(out, [[0.5, 0.0, np.float32(3.1), 0.0, np.float32(-3.1415), 0.0, 0.0, 0.0]])
    assert out.dtype == np.float64
    np.testing.assert_array_equal(fast._clamp_and_pad(data, 3), out[:, :3])
    np.testing.assert_array_equal(out, _script("compute_norm_stats_fast")._clamp_and_pad(data, 8))
