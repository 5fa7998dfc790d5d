"""The port's Stage Advantage pipeline against the JAX package's, on a synthetic Agilex dataset.

The dataset (two episodes of 5 and 4 frames and two tasks, three
48×64 cameras, 14-dim state and action, a ``stage_progress_gt`` column rising
from 0 to 1) is written by ``kai0_tpu.data.lerobot_writer``; the estimator is
the debug-size π₀.₅ (``dummy`` Gemma, ``mu/14`` SigLIP, f32) with
numpy-seeded weights, written once as the port's ``model.safetensors``. The
tokenizer is the synthetic sentencepiece model of ``tests/_sp_model.py``.

- The port's writer: its parquet tables equal the JAX writer's column for
  column (names, types, values), its meta files byte for byte, and its videos
  decode to the same frames.
- ``AdvantageLerobotDataset`` items bit-equal to JAX's, and
  ``create_data_loader`` batches of ``ADVANTAGE_TORCH_KAI0_FLATTEN_FOLD`` (the
  model cut to debug size, synthetic quantile norm stats, batch 4, the train
  split) bit-equal to JAX's, the history cameras and the progress target
  included.
- ``annotate_dataset`` (2-timestep mode, batch 4: one full and one padded
  batch per episode, relative interval 3, so the tail's rescaling runs) on
  the same weights and ``jax.random.key(0)`` draws: the three columns within
  1e-5 of JAX's (f64), every other column equal. ``SimpleValueEvaluator``,
  both modes, against JAX's on episode 0 within 1e-5 (2-timestep against
  JAX's annotated columns, which are its evaluator's output: JAX's forward
  takes 1.2 s a batch on the CPU).
- ``discretize_dataset`` in binary, ``n_slices`` and staged modes on the same
  annotated parquets: equal ``task_index`` (int32) and a byte-equal
  ``tasks.jsonl``.
- ``scripts/annotate_advantage_torch.py`` and
  ``scripts/discretize_advantage_torch.py``: their options are those of the
  JAX package's scripts (the port's adds ``--device``), and one CPU run each.
"""

import concurrent.futures
import dataclasses
import functools
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import _sp_model
from kai0_tpu.advantage import annotate as jax_annotate
from kai0_tpu.advantage import discretize as jax_discretize
from kai0_tpu.advantage.evaluator import SimpleValueEvaluator as JaxEvaluator
from kai0_tpu.data import advantage_dataset as jax_advantage_dataset
from kai0_tpu.data import lerobot_dataset as jax_lerobot
from kai0_tpu.data import lerobot_writer as jax_writer
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import advantage as jax_advantage
from kai0_tpu.models import tokenizer as jax_tokenizer
from kai0_tpu.shared import normalize as jax_normalize
from kai0_tpu.training import config as jax_config
from kai0_tpu.training import data_loader as jax_data_loader
from kai0_tpu.transforms import flatten_dict, unflatten_dict
from kai0_tpu_torch import interop
from kai0_tpu_torch.advantage import annotate, discretize
from kai0_tpu_torch.advantage.evaluator import SimpleValueEvaluator
from kai0_tpu_torch.data import advantage_dataset, lerobot_dataset, lerobot_writer
from kai0_tpu_torch.models import advantage
from kai0_tpu_torch.training import config as torch_config
from kai0_tpu_torch.training import data_loader

from _torch_parity import DEBUG

REPO = pathlib.Path(__file__).resolve().parent.parent
CAMERAS = ("top_head", "hand_left", "hand_right")
LENGTHS = (5, 4)
TASKS = ("Flatten and fold the cloth.", "fold the cloth")
MODEL = dict(DEBUG, max_token_len=48, discrete_state_input=False, loss_action_weight=0.0, loss_value_weight=1.0)
BATCH, INTERVAL = 4, 3
PROMPT = "Flatten and fold the cloth."


def _episodes():
    rng = np.random.default_rng(0)
    for length, task in zip(LENGTHS, TASKS, strict=True):
        data = {
            "observation.state": rng.uniform(-1, 1, (length, 14)).astype(np.float32),
            "action": rng.uniform(-1, 1, (length, 14)).astype(np.float32),
            "stage_progress_gt": np.linspace(0, 1, length, dtype=np.float32),
        }
        videos = {f"observation.images.{c}": rng.integers(0, 255, (length, 48, 64, 3)).astype(np.uint8)
                  for c in CAMERAS}
        yield data, task, videos


def _write(module, root):
    feats = module.feature_spec(state_dim=14, action_dim=14, cameras={c: (48, 64) for c in CAMERAS}, fps=10)
    feats["stage_progress_gt"] = {"dtype": "float32", "shape": [1]}
    writer = module.LeRobotDatasetWriter(root, feats, fps=10)
    for data, task, videos in _episodes():
        writer.add_episode(data, task=task, videos=videos)
    writer.finalize()
    return root


def _numpy_params(config, seed: int) -> dict:
    """Every leaf of ``config.init_params``'s tree from ``np.random.default_rng(seed)`` (as test_torch_advantage.py)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in flatten_dict(jax.eval_shape(config.init_params, jax.random.key(0))).items():
        if path.endswith("scale"):
            value = (1.0 if path.startswith("PaliGemma/img") else 0.0) + 0.1 * rng.standard_normal(leaf.shape)
        else:
            value = (0.02 if path.endswith("bias") else 0.05) * rng.standard_normal(leaf.shape)
        flat[path] = value.astype(leaf.dtype)
    return unflatten_dict(flat)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The tokenizer's model in the environment for the whole module."""
    path = tmp_path_factory.mktemp("sp") / "tokenizer.model"
    path.write_bytes(_sp_model.build_paligemma_like_bpe(jax_tokenizer.PALIGEMMA_VOCAB_SIZE)[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KAI0_PALIGEMMA_TOKENIZER", str(path))
        yield


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    return _write(jax_writer, tmp_path_factory.mktemp("lerobot") / "jax")


@pytest.fixture(scope="module")
def estimator(env, tmp_path_factory):
    """(JAX evaluator, port evaluator, their configs): the same weights and, for both, jax.random.key(0)'s draws."""
    jax_model_config = jax_advantage.AdvantageEstimatorConfig(**MODEL)
    params = _numpy_params(jax_model_config, seed=0)
    ckpt = tmp_path_factory.mktemp("estimator")
    tsf.save_torch_checkpoint(params, jax_model_config, ckpt)

    ev = JaxEvaluator.__new__(JaxEvaluator)  # the JAX test's manual init: no registry, no Orbax
    ev.config, ev.model_config, ev.batch_size, ev.num_workers = None, jax_model_config, BATCH, 2
    ev._executor = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    ev._params = params
    ev.tokenizer = jax_tokenizer.PaligemmaTokenizer(jax_model_config.max_token_len)
    ev._rng = jax.random.key(0)
    ev._values_fn = jax.jit(functools.partial(lambda m, p, r, o: m.sample_values(p, r, o), jax_model_config))

    noise_rng, time_rng = jax.random.split(jax.random.key(0))
    draws = (np.asarray(jax.random.normal(noise_rng, (BATCH, 50, 32))),
             np.asarray(jax.random.beta(time_rng, 1.5, 1, (BATCH,)) * 0.999 + 0.001))
    config = dataclasses.replace(torch_config.get_config("ADVANTAGE_TORCH_KAI0_FLATTEN_FOLD"),
                                 model=advantage.AdvantageEstimatorConfig(**MODEL))
    port = SimpleValueEvaluator(config, ckpt, num_workers=2, batch_size=BATCH, device="cpu",
                                param_dtype=torch.float32, draws=draws)
    yield ev, port, config, ckpt
    ev.shutdown()
    port.shutdown()


def _video_paths(root, episode: int):
    return [root / f"videos/chunk-000/observation.images.{c}/episode_{episode:06d}.mp4" for c in CAMERAS]


def test_the_port_writer_writes_what_the_jax_writer_writes(dataset_root, tmp_path):
    root = _write(lerobot_writer, tmp_path / "port")
    for name in ("info.json", "episodes.jsonl", "tasks.jsonl"):
        assert (root / "meta" / name).read_bytes() == (dataset_root / "meta" / name).read_bytes(), name
    for episode in range(len(LENGTHS)):
        rel = f"data/chunk-000/episode_{episode:06d}.parquet"
        ours, theirs = pq.read_table(root / rel), pq.read_table(dataset_root / rel)
        assert ours.column_names == theirs.column_names
        for name in theirs.column_names:
            assert ours.schema.field(name).type == theirs.schema.field(name).type, name
            assert ours.column(name).to_pylist() == theirs.column(name).to_pylist(), name
        from kai0_tpu_torch.advantage.evaluator import load_video_frames

        for ours_video, theirs_video in zip(_video_paths(root, episode), _video_paths(dataset_root, episode)):
            a, b = load_video_frames(ours_video), load_video_frames(theirs_video)
            assert len(a) == len(b) == LENGTHS[episode]
            np.testing.assert_array_equal(np.stack(a), np.stack(b))


def test_advantage_items_bit_equal_to_jax(dataset_root):
    kwargs = dict(action_horizon=10, action_sequence_keys=("action",))
    ours = advantage_dataset.AdvantageLerobotDataset(lerobot_dataset.LeRobotDataset(str(dataset_root), **kwargs))
    theirs = jax_advantage_dataset.AdvantageLerobotDataset(jax_lerobot.LeRobotDataset(str(dataset_root), **kwargs))
    assert len(ours) == len(theirs) == sum(LENGTHS)
    for i in (0, 4, 5, 8, 2):
        a, b = ours[i], theirs[i]
        assert list(a) == list(b)
        for k in b:
            if isinstance(b[k], str):
                assert a[k] == b[k], k
            else:
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["his_-100_frame_index"] != a["frame_index"] and a["task"] in TASKS
        np.testing.assert_array_equal(a["progress"], np.float32(a["stage_progress_gt"] - a["his_-100_stage_progress_gt"]))


def test_advantage_loader_batches_bit_equal_to_jax(env, dataset_root, tmp_path):
    rng = np.random.default_rng(3)
    lo = rng.uniform(-1.5, -0.5, 32)
    stats = {k: jax_normalize.NormStats(mean=np.zeros(32), std=np.ones(32), q01=lo, q99=lo + rng.uniform(1, 3, 32))
             for k in ("state", "actions")}
    configs = []
    for pkg, model in ((jax_config, jax_advantage.AdvantageEstimatorConfig(**MODEL)),
                       (torch_config, advantage.AdvantageEstimatorConfig(**MODEL))):
        cfg = pkg.get_config("ADVANTAGE_TORCH_KAI0_FLATTEN_FOLD")
        data = dataclasses.replace(cfg.data, repo_id=str(dataset_root), assets=pkg.AssetsConfig(asset_id="synthetic"))
        configs.append(dataclasses.replace(cfg, model=model, data=data, assets_base_dir=str(tmp_path / "assets"),
                                           batch_size=4, num_workers=0))
    assert configs[1].advantage_estimator and configs[1].split == "train"
    jax_normalize.save(configs[0].assets_dirs / "synthetic", stats)

    jax_loader = jax_data_loader.create_data_loader(
        configs[0], sharding=jax.sharding.SingleDeviceSharding(jax.devices()[0]), shuffle=True, num_batches=3)
    jax_batches = [(jax.tree.map(np.asarray, obs.to_dict()), np.asarray(actions)) for obs, actions in jax_loader]
    fields = ("image", "image_mask", "state", "tokenized_prompt", "tokenized_prompt_mask", "episode_index",
              "frame_index", "progress", "episode_length")
    n = 0
    for (obs, actions), (jax_obs, jax_actions) in zip(
            data_loader.create_data_loader(configs[1], device="cpu", shuffle=True, num_batches=3), jax_batches,
            strict=True):
        got = {"image": obs.images, "image_mask": obs.image_masks, "state": obs.state,
               "tokenized_prompt": obs.tokenized_prompt, "tokenized_prompt_mask": obs.tokenized_prompt_mask,
               "episode_index": obs.episode_index, "frame_index": obs.frame_index, "progress": obs.progress,
               "episode_length": obs.episode_length}
        want = {k: jax_obs[k] for k in fields}
        assert set(got["image"]) == set(want["image"]) and len(want["image"]) == 6
        for (path, a), (_, b) in zip(sorted(flatten_dict(jax.tree.map(lambda t: t.numpy(), got)).items()),
                                     sorted(flatten_dict(want).items()), strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=path)
        np.testing.assert_array_equal(actions.numpy(), jax_actions)
        n += 1
    assert n == 3


def test_both_evaluator_modes_match_jax(estimator, annotated, dataset_root):
    """2-timestep: the port's evaluator against JAX's results as JAX's ``annotate`` wrote them (the same episode,
    batch, weights and draws); 1-timestep: both evaluators."""
    ev, port, _, _ = estimator
    paths = _video_paths(dataset_root, 0)
    got = port.evaluate_video_2timesteps_advantages(paths, PROMPT, relative_interval=INTERVAL)
    assert len(got) == LENGTHS[0] and len(port.timing["device_ms"]) == 4 and port.timing["decode_s"] > 0
    assert [r["future_frame_idx"] for r in got] == [min(j + INTERVAL, LENGTHS[0] - 1) for j in range(LENGTHS[0])]
    jax_table = pq.read_table(annotated[0] / "data_test/chunk-000/episode_000000.parquet")
    for col in annotate.ADVANTAGE_COLS:
        np.testing.assert_allclose([r[col] for r in got], jax_table.column(col).to_pylist(), rtol=0, atol=1e-5,
                                   err_msg=col)
    assert any(abs(r["relative_advantage"]) > 1e-3 for r in got)
    want = ev.evaluate_video_1timestep_advantage(paths, PROMPT)
    got = port.evaluate_video_1timestep_advantage(paths, PROMPT)
    assert len(got) == len(want) == LENGTHS[0]
    for g, w in zip(got, want, strict=True):
        assert list(g) == list(w) and g["frame_idx"] == w["frame_idx"]
        assert abs(g["absolute_value"] - w["absolute_value"]) <= 1e-5, (g, w)
    assert all(-1 <= r["absolute_value"] <= 1 for r in got) and got[0]["absolute_value"] == 0.0


def _copy(src: pathlib.Path, dst: pathlib.Path, subdirs=("meta", "data", "videos")) -> pathlib.Path:
    for sub in subdirs:
        shutil.copytree(src / sub, dst / sub)
    return dst


@pytest.fixture(scope="module")
def annotated(estimator, dataset_root, tmp_path_factory):
    """(JAX's annotated copy, the port's) of the dataset, ``data_test/`` beside ``data/``."""
    ev, port, _, _ = estimator
    roots = []
    for name, fn, evaluator in (("jax", jax_annotate.annotate_dataset, ev), ("port", annotate.annotate_dataset, port)):
        root = _copy(dataset_root, tmp_path_factory.mktemp("annotate") / name)
        written = fn(evaluator, root, prompt=PROMPT, output_tag="test", relative_interval=INTERVAL)
        assert len(written) == len(LENGTHS)
        roots.append(root)
    return roots


def test_annotate_columns_match_jax(annotated):
    jax_root, port_root = annotated
    for episode in range(len(LENGTHS)):
        rel = f"data_test/chunk-000/episode_{episode:06d}.parquet"
        ours, theirs = pq.read_table(port_root / rel), pq.read_table(jax_root / rel)
        assert ours.column_names == theirs.column_names
        assert ours.column_names[-3:] == list(annotate.ADVANTAGE_COLS)
        for name in theirs.column_names:
            a, b = ours.column(name).to_pylist(), theirs.column(name).to_pylist()
            if name in annotate.ADVANTAGE_COLS:
                assert ours.schema.field(name).type == theirs.schema.field(name).type
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)
            else:
                assert a == b, name


@pytest.mark.parametrize("mode", [dict(), dict(discretion_type="n_slices", n_slices=4), dict(stage_nums=2)],
                         ids=["binary", "n_slices", "staged"])
def test_discretize_matches_jax(annotated, tmp_path, mode):
    jax_root, _ = annotated
    roots = [_copy(jax_root, tmp_path / name, subdirs=("meta", "data_test")) for name in ("jax", "port")]
    kwargs = dict(threshold=70.0, data_glob="data_test/chunk-*/*.parquet", base_prompt=PROMPT, **mode)
    want = jax_discretize.discretize_dataset(roots[0], **kwargs)
    got = discretize.discretize_dataset(roots[1], **kwargs)
    assert got == want
    assert (roots[1] / "meta/tasks.jsonl").read_bytes() == (roots[0] / "meta/tasks.jsonl").read_bytes()
    labels = []
    for episode in range(len(LENGTHS)):
        rel = f"data_test/chunk-000/episode_{episode:06d}.parquet"
        ours, theirs = pq.read_table(roots[1] / rel), pq.read_table(roots[0] / rel)
        assert str(ours.schema.field("task_index").type) == str(theirs.schema.field("task_index").type) == "int32"
        assert ours.column("task_index").to_pylist() == theirs.column("task_index").to_pylist()
        labels += ours.column("task_index").to_pylist()
    assert len(set(labels)) > 1


def _options(script: pathlib.Path) -> set[str]:
    """The options of a script's usage line (``--help`` up to its first blank line)."""
    out = subprocess.run([sys.executable, str(script), "--help"], capture_output=True, text=True, check=True,
                         cwd=REPO).stdout
    usage = out.split("\n\n")[0]
    return {word.strip("[]") for word in usage.split() if word.startswith(("--", "[--"))}


def test_scripts_usage_and_one_cpu_run_each(estimator, annotated, tmp_path, monkeypatch):
    from scripts import annotate_advantage_torch, discretize_advantage_torch

    _, _, config, ckpt = estimator
    pairs = (("annotate_advantage_torch.py", "stage_advantage/annotation/eval.py"),
             ("discretize_advantage_torch.py", "stage_advantage/annotation/discretize_advantage.py"))
    for ours, theirs in pairs:
        assert _options(REPO / "scripts" / ours) - {"--device"} == _options(REPO / theirs), ours
    assert annotate_advantage_torch.MODELS_CONFIG_MAP == _jax_models_config_map()

    # Annotate through the script: the registry's KAI0 entry, the estimator's config cut to debug size.
    root = _copy(annotated[1], tmp_path / "script", subdirs=("meta", "data", "videos"))
    monkeypatch.setattr(torch_config, "get_config", lambda name: config)
    annotate_advantage_torch.main(["Flatten-Fold", "KAI0", str(root), f"--ckpt_dir={ckpt}", f"--batch_size={BATCH}",
                                   f"--relative_interval={INTERVAL}", "--device=cpu"])
    written = sorted((root / "data_KAI0_30000").rglob("*.parquet"))
    assert len(written) == len(LENGTHS)
    values = np.concatenate([pq.read_table(p).column("absolute_advantage").to_numpy() for p in written])
    assert np.isfinite(values).all() and np.abs(values).max() <= 1
    discretize_advantage_torch.main([str(root), "--threshold=30", "--data-glob=data_KAI0_30000/chunk-*/*.parquet",
                                     f"--base-prompt={PROMPT}"])
    labels = np.concatenate([pq.read_table(p).column("task_index").to_numpy() for p in written])
    assert labels.dtype == np.int32 and set(labels.tolist()) == {0, 1}
    assert (root / "meta/tasks.jsonl").read_text().splitlines()[1].endswith(", Advantage: positive\"}")


def _jax_models_config_map() -> dict:
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_eval", REPO / "stage_advantage/annotation/eval.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.MODELS_CONFIG_MAP
