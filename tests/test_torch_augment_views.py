"""The port's train-time augmentation views against the JAX package's, item for item.

One synthetic dual-arm LeRobot dataset (2 episodes × 10 frames, three 32×32
mp4 cameras, 14-dim state and action), written by
``kai0_tpu.data.lerobot_writer`` from a numpy seed, read by both packages
(each decodes with cv2):

- ``MirroredView``, ``TimeScaledView`` and ``MirroredView(TimeScaledView)``
  over each package's ``LeRobotDataset``: every item bit-equal (keys in
  order, dtypes, ``episode_index`` / ``index`` renumbering, flipped and
  slot-swapped images), also over an episode subset and after a pickle
  round trip (the loader's workers); unequal or too-wide arm blocks fail
  alike;
- ``create_data_loader`` of ``pi05_flatten_fold_normal`` (model cut to debug
  size, the synthetic SentencePiece model, quantile stats) with
  ``augment_mirror`` and ``augment_time_scale=2``, set through the command
  line's dotted overrides: batches bit-equal to JAX's loader on the same
  config;
- the three refusals (fake data, an advantage dataset, a time scale of 0) in
  both packages.
"""

import dataclasses
import pickle

import jax
import numpy as np
import pytest

import _sp_model
from kai0_tpu.data import augment_views as jax_views
from kai0_tpu.data import lerobot_dataset as jax_lerobot
from kai0_tpu.data.lerobot_writer import LeRobotDatasetWriter, feature_spec
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.models import tokenizer as jax_tokenizer
from kai0_tpu.shared import normalize as jax_normalize
from kai0_tpu.training import config as jax_config
from kai0_tpu.training import data_loader as jax_data_loader
from kai0_tpu_torch.data import augment_views, lerobot_dataset
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.training import config as torch_config
from kai0_tpu_torch.training import data_loader

from _torch_parity import DEBUG, assert_same, worker_share_of_torch_threads  # noqa: F401

CAMERAS = ("top_head", "hand_left", "hand_right")
FRAMES = 10
HORIZON = 4


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("views") / "agilex"
    writer = LeRobotDatasetWriter(
        root, feature_spec(state_dim=14, action_dim=14, cameras={c: (32, 32) for c in CAMERAS}, fps=10), fps=10)
    rng = np.random.default_rng(0)
    for task in ("fold the cloth", "hang the shirt"):
        writer.add_episode(
            {"observation.state": rng.uniform(-1, 1, (FRAMES, 14)).astype(np.float32),
             "action": rng.uniform(-1, 1, (FRAMES, 14)).astype(np.float32)},
            task=task,
            videos={f"observation.images.{c}": rng.integers(0, 255, (FRAMES, 32, 32, 3)).astype(np.uint8)
                    for c in CAMERAS},
        )
    writer.finalize()
    return root


def _raw(pkg, root, episodes=None):
    return pkg.LeRobotDataset(str(root), action_horizon=HORIZON, action_sequence_keys=("action",), episodes=episodes)


def _views(views, raw, kind, dims):
    left, right = dims
    if kind == "mirror":
        return views.MirroredView(raw, left_dim=left, right_dim=right)
    if kind == "time_scale":
        return views.TimeScaledView(raw, 2)
    return views.MirroredView(views.TimeScaledView(raw, 2), left_dim=left, right_dim=right)


@pytest.mark.parametrize("kind,episodes,dims", [
    ("mirror", None, (7, 7)),
    ("time_scale", None, (7, 7)),
    ("both", None, (7, 7)),
    ("both", [1], (7, 7)),
])
def test_views_items_bit_equal_to_jax(dataset_root, kind, episodes, dims):
    ours = _views(augment_views, _raw(lerobot_dataset, dataset_root, episodes), kind, dims)
    theirs = _views(jax_views, _raw(jax_lerobot, dataset_root, episodes), kind, dims)
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        assert_same(theirs[i], ours[i])
    if kind != "time_scale":
        n = len(ours) // 2
        orig, twin = ours[1], ours[n + 1]
        np.testing.assert_array_equal(twin["observation.images.hand_left"], orig["observation.images.hand_right"][:, ::-1])
        assert int(twin["index"]) == int(orig["index"]) + n


@pytest.mark.parametrize("dims,match", [((6, 8), "could not broadcast"), ((8, 8), "Expected at least 16 dims")])
def test_mirrored_view_refuses_other_arm_blocks_as_jax_does(dataset_root, dims, match):
    """Unequal or too-wide blocks go through the per-row swap and fail with the offline rewrite's error."""
    for views, pkg in ((augment_views, lerobot_dataset), (jax_views, jax_lerobot)):
        view = _views(views, _raw(pkg, dataset_root), "mirror", dims)
        view[0]  # the original half is served as it is
        with pytest.raises(ValueError, match=match):
            view[len(view) // 2]


def test_views_pickle_into_workers(dataset_root):
    view = _views(augment_views, _raw(lerobot_dataset, dataset_root), "both", (7, 7))
    view[3]  # opens a decoder and a table, which stay behind
    clone = pickle.loads(pickle.dumps(view))
    for i in (0, 3, len(view) - 1):
        assert_same(view[i], clone[i])


def _config(pkg, model, dataset_root, tmp_path, argv):
    """``pi05_flatten_fold_normal`` on the synthetic data, debug model, the augmentation flags from the command line."""
    cfg = pkg.cli(["pi05_flatten_fold_normal", *argv])
    data = dataclasses.replace(cfg.data, repo_id=str(dataset_root), assets=pkg.AssetsConfig(asset_id="synthetic"))
    return dataclasses.replace(cfg, model=model, data=data, assets_base_dir=str(tmp_path / "assets"), batch_size=4,
                               num_workers=0)


def test_loader_batches_with_both_views_bit_equal_to_jax(dataset_root, tmp_path, monkeypatch):
    model_path = tmp_path / "tokenizer.model"
    model_path.write_bytes(_sp_model.build_paligemma_like_bpe(jax_tokenizer.PALIGEMMA_VOCAB_SIZE)[0])
    monkeypatch.setenv("KAI0_PALIGEMMA_TOKENIZER", str(model_path))
    argv = ["--data.base_config.augment_mirror=True", "--data.base_config.augment_time_scale=2"]
    ours = _config(torch_config, torch_pi0.Pi0Config(**DEBUG), dataset_root, tmp_path, argv)
    theirs = _config(jax_config, jax_pi0.Pi0Config(**DEBUG), dataset_root, tmp_path, argv)
    assert ours.data.base_config.augment_mirror and ours.data.base_config.augment_time_scale == 2
    rng = np.random.default_rng(3)
    lo = rng.uniform(-1.5, -0.5, 32)
    jax_normalize.save(theirs.assets_dirs / "synthetic", {
        k: jax_normalize.NormStats(mean=np.zeros(32), std=np.ones(32), q01=lo, q99=lo + 2) for k in ("state", "actions")})

    loader = data_loader.create_data_loader(ours, device="cpu", shuffle=True, num_batches=3)
    assert len(loader._loader._dataset) == 2 * 2 * (FRAMES // 2)
    jax_loader = jax_data_loader.create_data_loader(
        theirs, sharding=jax.sharding.SingleDeviceSharding(jax.devices()[0]), shuffle=True, num_batches=3)
    for (obs, actions), (jax_obs, jax_actions) in zip(loader, jax_loader, strict=True):
        tree = {"image": obs.images, "image_mask": obs.image_masks, "state": obs.state,
                "tokenized_prompt": obs.tokenized_prompt, "tokenized_prompt_mask": obs.tokenized_prompt_mask}
        jax_tree = jax.tree.map(np.asarray, jax_obs.to_dict())
        for key, value in tree.items():
            assert_same(jax_tree[key], jax.tree.map(lambda t: t.numpy(), value))
        assert_same(np.asarray(jax_actions), actions.numpy())


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_augmentation_refusals(dataset_root, pkg):
    config, loader = (torch_config, data_loader) if pkg == "torch" else (jax_config, jax_data_loader)
    model = (torch_pi0 if pkg == "torch" else jax_pi0).Pi0Config(**DEBUG)
    data = dataclasses.replace(config.DataConfig(), repo_id=str(dataset_root), action_sequence_keys=("action",))
    with pytest.raises(ValueError, match="fake data"):
        loader.create_dataset(dataclasses.replace(data, repo_id="fake", augment_mirror=True), model)
    with pytest.raises(ValueError, match="advantage"):
        loader.create_dataset(dataclasses.replace(data, augment_time_scale=2), model, advantage=True)
    with pytest.raises(ValueError, match="augment_time_scale must be >= 1, got 0"):
        loader.create_dataset(dataclasses.replace(data, augment_time_scale=0), model)
