"""The port's training data against the JAX package's: fake items, LeRobot items, loader batches, the index order.

- ``FakeDataset`` of ``debug_pi05``: items bit-equal to JAX's (the same
  ``default_rng(index)`` draws in the same leaf order).
- A synthetic LeRobot dataset in the Agilex layout (14-dim state and action,
  three 48×64 cameras, five episodes of 12-16 frames over two tasks), written
  by ``kai0_tpu.data.lerobot_writer`` as ``tests/test_data.py`` writes its
  fixture: the port's ``LeRobotDataset`` items (parquet columns, cv2-decoded
  frames, action chunks edge-padded past the episode end) and
  ``episodes_split_through_task`` bit-equal to JAX's.
- ``create_data_loader`` with ``num_workers=0`` and the same seed: batches
  bit-equal to JAX's, as numpy, for ``debug_pi05`` and for the kai0 task
  config ``pi05_flatten_fold_normal`` (its ``awbc`` twin too, whose prompt is
  the task) with the model cut to debug size, ``repo_id`` set to the
  dataset, synthetic quantile norm stats and the synthetic sentencepiece
  model of ``tests/_sp_model.py``. Both loaders collate 6 batches of 4 over
  the 70 frames. Two spawn workers give the batches of the producer thread.
- The index stream: equal to JAX's across an epoch boundary, with and
  without ``drop_last``.
- The augmentation flags build the train-time views (and raise on the RLDS
  stream, which streams a local RLDS directory); ``advantage=True`` builds the
  advantage estimator's dataset.
"""

import dataclasses
import itertools

import jax
import numpy as np
import pytest

import _rlds_data
import _sp_model
from kai0_tpu.data import lerobot_dataset as jax_lerobot
from kai0_tpu.data.lerobot_writer import LeRobotDatasetWriter, feature_spec
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.models import tokenizer as jax_tokenizer
from kai0_tpu.shared import normalize as jax_normalize
from kai0_tpu.training import config as jax_config
from kai0_tpu.training import data_loader as jax_data_loader
from kai0_tpu_torch.data import lerobot_dataset, rlds
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.training import config as torch_config
from kai0_tpu_torch.training import data_loader, droid_rlds_dataset

from _torch_parity import DEBUG

CAMERAS = ("top_head", "hand_left", "hand_right")
LENGTHS = (12, 13, 14, 15, 16)
HORIZON = 10


def _assert_same_tree(a, b, path=""):
    """The same keys (in any order) and, leaf by leaf, the same dtype, shape and bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _drop_none(item: dict) -> dict:
    return {k: _drop_none(v) if isinstance(v, dict) else v for k, v in item.items() if v is not None}


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("lerobot") / "agilex"
    feats = feature_spec(state_dim=14, action_dim=14, cameras={c: (48, 64) for c in CAMERAS}, fps=10)
    writer = LeRobotDatasetWriter(root, feats, fps=10)
    rng = np.random.default_rng(0)
    for ep, length in enumerate(LENGTHS):
        writer.add_episode(
            {
                "observation.state": rng.uniform(-1, 1, (length, 14)).astype(np.float32),
                "action": rng.uniform(-1, 1, (length, 14)).astype(np.float32),
            },
            task="fold the cloth" if ep % 2 else "hang the shirt",
            videos={f"observation.images.{c}": rng.integers(0, 255, (length, 48, 64, 3)).astype(np.uint8)
                    for c in CAMERAS},
        )
    writer.finalize()
    return root


def test_fake_dataset_items_bit_equal_to_jax():
    jax_ds = jax_data_loader.FakeDataset(jax_config.get_config("debug_pi05").model, num_samples=16)
    torch_ds = data_loader.FakeDataset(torch_config.get_config("debug_pi05").model, num_samples=16)
    assert len(jax_ds) == len(torch_ds) == 16
    for i in (0, 1, 7, 15):
        _assert_same_tree(_drop_none(jax_ds[i]), torch_ds[i])


def test_lerobot_items_bit_equal_to_jax(dataset_root):
    kwargs = dict(action_horizon=HORIZON, action_sequence_keys=("action",))
    jax_ds = jax_lerobot.LeRobotDataset(str(dataset_root), **kwargs)
    torch_ds = lerobot_dataset.LeRobotDataset(str(dataset_root), **kwargs)
    assert len(jax_ds) == len(torch_ds) == sum(LENGTHS)
    assert torch_ds.tasks == jax_ds.tasks and torch_ds.fps == jax_ds.fps
    # Each episode's first and last frames (the chunk padded past the end), a middle frame, read out of order.
    ends = np.cumsum(LENGTHS)
    for i in [*ends - 1, *(ends - np.asarray(LENGTHS)), 5, 40, 3]:
        item = torch_ds[int(i)]
        _assert_same_tree(jax_ds[int(i)], item)
        episode, frame = torch_ds.locate(int(i))
        last = LENGTHS[episode] - 1
        rows = np.minimum(np.arange(frame, frame + HORIZON), last)
        assert item["action"].shape == (HORIZON, 14)
        np.testing.assert_array_equal(item["action"][-1], item["action"][rows.tolist().index(rows[-1])])
        assert item["observation.images.top_head"].shape == (48, 64, 3)
    # An episode subset, and the per-task split.
    subset = dict(kwargs, episodes=[1, 3])
    _assert_same_tree(jax_lerobot.LeRobotDataset(str(dataset_root), **subset)[14],
                      lerobot_dataset.LeRobotDataset(str(dataset_root), **subset)[14])
    for split in ("all", "train", "val"):
        assert (lerobot_dataset.episodes_split_through_task(torch_ds, split)
                == jax_lerobot.episodes_split_through_task(jax_ds, split))


def _jax_batches(config, n):
    loader = jax_data_loader.create_data_loader(
        config, sharding=jax.sharding.SingleDeviceSharding(jax.devices()[0]), shuffle=True, num_batches=n
    )
    return [(jax.tree.map(np.asarray, obs.to_dict()), np.asarray(actions)) for obs, actions in loader]


def _torch_batches(config, n):
    loader = data_loader.create_data_loader(config, device="cpu", shuffle=True, num_batches=n)
    out = []
    for obs, actions in loader:
        tree = {"image": obs.images, "image_mask": obs.image_masks, "state": obs.state,
                "tokenized_prompt": obs.tokenized_prompt, "tokenized_prompt_mask": obs.tokenized_prompt_mask}
        out.append((jax.tree.map(lambda t: t.numpy(), tree), actions.numpy()))
    return out


def _assert_same_batches(jax_batches, torch_batches):
    assert len(jax_batches) == len(torch_batches)
    for (jax_obs, jax_actions), (torch_obs, torch_actions) in zip(jax_batches, torch_batches, strict=True):
        _assert_same_tree(_drop_none(jax_obs), torch_obs)
        _assert_same_tree(jax_actions, torch_actions)


def test_fake_data_loader_batches_bit_equal_to_jax():
    configs = [dataclasses.replace(pkg.get_config("debug_pi05"), batch_size=4) for pkg in (jax_config, torch_config)]
    _assert_same_batches(_jax_batches(configs[0], 3), _torch_batches(configs[1], 3))


@pytest.mark.parametrize("name", ["pi05_flatten_fold_normal", "pi05_flatten_fold_awbc"])
def test_lerobot_data_loader_batches_bit_equal_to_jax(dataset_root, tmp_path, monkeypatch, name):
    model_path = tmp_path / "tokenizer.model"
    model_path.write_bytes(_sp_model.build_paligemma_like_bpe(jax_tokenizer.PALIGEMMA_VOCAB_SIZE)[0])
    monkeypatch.setenv("KAI0_PALIGEMMA_TOKENIZER", str(model_path))
    rng = np.random.default_rng(3)
    lo = rng.uniform(-1.5, -0.5, 32)
    stats = {k: jax_normalize.NormStats(mean=np.zeros(32), std=np.ones(32), q01=lo, q99=lo + rng.uniform(1, 3, 32))
             for k in ("state", "actions")}
    repo_id = str(dataset_root)
    configs = []
    for pkg, model in ((jax_config, jax_pi0.Pi0Config(**DEBUG)), (torch_config, torch_pi0.Pi0Config(**DEBUG))):
        cfg = pkg.get_config(name)
        data = dataclasses.replace(cfg.data, repo_id=repo_id, assets=pkg.AssetsConfig(asset_id="synthetic"))
        configs.append(dataclasses.replace(cfg, model=model, data=data, assets_base_dir=str(tmp_path / "assets"),
                                           batch_size=4, num_workers=0))
    jax_normalize.save(configs[0].assets_dirs / "synthetic", stats)
    assert configs[1].data.create(configs[1].assets_dirs, configs[1].model).norm_stats is not None
    _assert_same_batches(_jax_batches(configs[0], 6), _torch_batches(configs[1], 6))


def test_worker_processes_give_the_batches_of_the_thread():
    config = dataclasses.replace(torch_config.get_config("debug_pi05"), batch_size=4)
    threaded = _torch_batches(config, 2)
    spawned = _torch_batches(dataclasses.replace(config, num_workers=2), 2)
    for (obs, actions), (obs_w, actions_w) in zip(threaded, spawned, strict=True):
        _assert_same_tree(obs, obs_w)
        _assert_same_tree(actions, actions_w)


@pytest.mark.parametrize("drop_last", [True, False])
def test_index_stream_matches_jax_across_epochs(drop_last):
    dataset = data_loader.FakeDataset(torch_config.get_config("debug_pi05").model, num_samples=10)
    kwargs = dict(shuffle=True, num_workers=0, seed=7, drop_last=drop_last)
    ours = data_loader.DataLoader(dataset, batch_size=4, device="cpu", **kwargs)
    theirs = jax_data_loader.NumpyDataLoader(dataset, local_batch_size=4, sharding=None, **kwargs)
    # 10 items in batches of 4: the epoch boundary falls inside the third (drop_last: after the second) batch.
    for a, b in itertools.islice(zip(ours._index_stream(), theirs._index_stream()), 9):
        np.testing.assert_array_equal(a, b)


def test_unported_data_paths_raise(dataset_root, tmp_path, monkeypatch):
    cfg = torch_config.get_config("debug_pi05")
    data = cfg.data.create(cfg.assets_dirs, cfg.model)
    with pytest.raises(ValueError, match="real LeRobot dataset"):
        data_loader.create_dataset(dataclasses.replace(data, augment_mirror=True), cfg.model)
    lerobot = dataclasses.replace(data, repo_id=str(dataset_root))
    # The augmentation flags are ported: they wrap the dataset in the train-time views
    # (tests/test_torch_augment_views.py holds the views to JAX's).
    from kai0_tpu_torch.data import augment_views

    mirrored = data_loader.create_dataset(dataclasses.replace(lerobot, augment_mirror=True), cfg.model)
    assert isinstance(mirrored, augment_views.MirroredView) and len(mirrored) == 2 * sum(LENGTHS)
    scaled = data_loader.create_dataset(dataclasses.replace(lerobot, augment_time_scale=2), cfg.model)
    assert isinstance(scaled, augment_views.TimeScaledView) and len(scaled) == sum(-(-n // 2) for n in LENGTHS)
    from kai0_tpu_torch.data import advantage_dataset

    paired = data_loader.create_dataset(lerobot, cfg.model, advantage=True)
    assert isinstance(paired, advantage_dataset.AdvantageLerobotDataset) and len(paired) == sum(LENGTHS)
    # The RLDS stream (tests/test_torch_rlds*.py hold it to JAX's): a named config on the RLDS factory streams a local
    # RLDS directory; the augmentation flags raise on it, with JAX's message.
    rng = np.random.default_rng(4)
    for name, version in (("droid", "1.0.1"), ("polaris_droid_cotrain_dataset", "1.0.0")):
        rlds.write_dataset(tmp_path / "rlds", name, version, [_rlds_data.droid_episode(
            rng, length=4, file_path=f"/{name}/{i}/success/t.h5", recording=f"/{name}/{i}") for i in range(2)])
    monkeypatch.setattr(droid_rlds_dataset, "DEFAULT_SHUFFLE_BUFFER", 8)
    polaris = torch_config.get_config("pi0_droid_jointpos_polaris")
    polaris = dataclasses.replace(polaris, batch_size=2, data=dataclasses.replace(
        polaris.data, rlds_data_dir=str(tmp_path / "rlds")))
    (obs, actions), = list(data_loader.create_data_loader(polaris, device="cpu", num_batches=1))
    assert obs.images["base_0_rgb"].shape == (2, 224, 224, 3) and actions.shape == (2, 15, 8)
    augmented = dataclasses.replace(polaris, data=dataclasses.replace(
        polaris.data, base_config=torch_config.DataConfig(augment_mirror=True)))
    with pytest.raises(ValueError, match="augment_mirror/augment_time_scale are not supported on the RLDS path"):
        data_loader.create_data_loader(augmented, device="cpu")
