"""The RLDS stream through the port's loader, configs and training loop, against the JAX package.

A synthetic ``droid`` 1.0.1 (six episodes, one without "success" in its path)
and ``polaris_droid_cotrain_dataset`` 1.0.0 (three episodes), 24x32 JPEG
cameras, written by the port's writer (``data/rlds.py``); norm stats of their
states and delta actions by the port's ``RunningStats``; the synthetic
sentencepiece model of ``tests/_sp_model.py``.

- The loader: each batch of ``create_data_loader`` for ``pi05_full_droid_finetune``
  and ``pi05_droid_jointpos_polaris`` equals JAX's ``transform_stack`` applied
  frame by frame to the stream's batch and stacked (the reference's
  ``is_batched=True``), bit for bit, as an ``Observation``.
- JAX's ``RLDSLoader`` applies the stack to the whole batch and raises in
  ``DroidInputs`` (ROADMAP Queue 3); the port loads the same batch.
- Training: a debug-size π₀.₅ (``pi05_droid_jointpos_polaris``'s horizon 15)
  takes 2 CPU steps of ``train_lib.main`` through the stream. Its step-0 loss is
  the port's ``compute_loss`` on the first batch with the step's draws (bit for
  bit), and on that batch and those weights the port's loss (no augmentation:
  ``tests/test_torch_loss.py`` holds it) matches JAX's ``compute_loss`` under
  JAX's noise and time within 1e-5 x max(1, max |loss|) (that file's tolerance).
- The configs: both configs' data config fields, ``action_space`` and
  ``rlds_datasets`` among them, and their training fields equal JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _rlds_data
import _sp_model
from _torch_parity import DEBUG, jax_loss_draws, numpy_params
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import model as jax_model
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.models import tokenizer as jax_tokenizer
from kai0_tpu.training import config as jax_config
from kai0_tpu.training import data_loader as jax_data_loader
from kai0_tpu_torch import interop as torch_interop
from kai0_tpu_torch.data import rlds
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.shared import normalize
from kai0_tpu_torch.training import config as torch_config
from kai0_tpu_torch.training import data_loader, optimizer, train_lib
from kai0_tpu_torch.training import droid_rlds_dataset as torch_rlds

CONFIGS = ("pi05_full_droid_finetune", "pi05_droid_jointpos_polaris")
BUFFER = 48  # the shuffle buffer here (250,000 by default: the fill would cost the test seconds)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("rlds_loader")
    rng = np.random.default_rng(0)
    episodes = {}
    for name, version, lengths in (("droid", "1.0.1", (7, 5, 9, 4, 6, 8)),
                                   ("polaris_droid_cotrain_dataset", "1.0.0", (6, 7, 5))):
        episodes[name] = [_rlds_data.droid_episode(
            rng, length=n, recording=f"/{name}/{i}", prefix=f"{name} ",
            file_path=f"/{name}/{i}/{'failure' if i == 3 else 'success'}/trajectory.h5") for i, n in enumerate(lengths)]
        rlds.write_dataset(root, name, version, episodes[name], num_shards=2)
    # Norm stats of the state (joints ++ gripper) and the delta actions (joints; the gripper absolute), 8 wide.
    stats = {"state": normalize.RunningStats(), "actions": normalize.RunningStats()}
    for episode in (e for es in episodes.values() for e in es):
        steps = episode["steps"]
        state = np.concatenate([steps["observation"]["joint_position"], steps["observation"]["gripper_position"]], -1)
        actions = np.concatenate([steps["action_dict"]["joint_position"], steps["action_dict"]["gripper_position"]], -1)
        stats["state"].update(state.astype(np.float64))
        stats["actions"].update(np.concatenate([actions[:, :7] - state[:, :7], actions[:, 7:]], -1).astype(np.float64))
    normalize.save(root / "assets" / "droid", {k: s.get_statistics() for k, s in stats.items()})
    (root / "tokenizer.model").write_bytes(_sp_model.build_paligemma_like_bpe(jax_tokenizer.PALIGEMMA_VOCAB_SIZE)[0])
    return root


@pytest.fixture
def env(root, monkeypatch):
    monkeypatch.setattr(torch_rlds, "DEFAULT_SHUFFLE_BUFFER", BUFFER)
    return root


@pytest.fixture
def tokenizer(env, monkeypatch):
    """The synthetic sentencepiece model (loading it costs each package ~1.5 s; the other tests keep both packages'
    stand-in codec)."""
    monkeypatch.setenv("KAI0_PALIGEMMA_TOKENIZER", str(env / "tokenizer.model"))
    return env


def _configs(name: str, root, **fields):
    out = []
    for pkg in (jax_config, torch_config):
        cfg = pkg.get_config(name)
        data = dataclasses.replace(cfg.data, rlds_data_dir=str(root),
                                   assets=pkg.AssetsConfig(assets_dir=str(root / "assets"), asset_id="droid"))
        out.append(dataclasses.replace(cfg, data=data, **fields))
    return out


def _unbatched(batch, i):
    return {k: _unbatched(v, i) for k, v in batch.items()} if isinstance(batch, dict) else batch[i]


def _stacked(items):
    if isinstance(items[0], dict):
        return {k: _stacked([item[k] for item in items]) for k in items[0]}
    return np.stack(items)


def _narrowed(x):
    """As JAX's device_put (x64 off) and the port's loader narrow them."""
    narrow = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}
    return x.astype(narrow[x.dtype]) if x.dtype in narrow else x


def _jax_batch(stack, raw: dict):
    """JAX's transform stack applied frame by frame to a stream batch, stacked: (observation dict, actions)."""
    frames = [_unbatched(raw, i) for i in range(len(raw["actions"]))]
    for transform in stack:
        frames = [transform(frame) for frame in frames]
    batch = jax.tree.map(lambda x: _narrowed(np.asarray(x)), _stacked(frames))
    actions = batch.pop("actions")
    obs = jax_model.Observation.from_dict(jax.tree.map(jnp.asarray, batch)).to_dict()
    return {k: v for k, v in jax.tree.map(np.asarray, obs).items() if v is not None}, actions


def _port_batch(obs, actions):
    tree = {"image": obs.images, "image_mask": obs.image_masks, "state": obs.state,
            "tokenized_prompt": obs.tokenized_prompt, "tokenized_prompt_mask": obs.tokenized_prompt_mask}
    return jax.tree.map(lambda t: t.numpy(), tree), actions.numpy()


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("name", CONFIGS)
def test_loader_batches_are_jaxs_stack_frame_by_frame(tokenizer, name):
    jax_cfg, cfg = _configs(name, tokenizer, batch_size=4)
    loader = data_loader.create_data_loader(cfg, device="cpu", num_batches=3)
    got = [_port_batch(obs, actions) for obs, actions in loader]
    data_config = loader.data_config()
    assert data_config.norm_stats is not None and len(data_config.rlds_datasets) == (2 if "polaris" in name else 1)
    # The same stream again (its draws come from the config's seed) gives the raw batches the loader transformed.
    stream = iter(data_loader.create_rlds_dataset(data_config, cfg.model.action_horizon, 4, seed=cfg.seed))
    raw = [next(stream) for _ in range(3)]
    assert raw[0]["observation"]["image"].shape == (4, 24, 32, 3) and raw[0]["actions"].shape[1:] == (
        cfg.model.action_horizon, 8)
    jax_data = jax_cfg.data.create(jax_cfg.assets_dirs, jax_cfg.model)
    stack = jax_data_loader.transform_stack(jax_data, jax_cfg.model)
    for (obs, actions), batch in zip(got, raw, strict=True):
        want_obs, want_actions = _jax_batch(stack, batch)
        _assert_same_tree(want_obs, obs)
        _assert_same_tree(want_actions, actions)
        assert actions.shape == (4, cfg.model.action_horizon, 32)


def test_jax_rlds_loader_cannot_take_a_batch_the_port_loads(env):
    """ROADMAP Queue 3: JAX's ``RLDSLoader`` hands the whole batch to ``DroidInputs``, which concatenates the joint
    and gripper positions along axis 0."""
    jax_cfg, cfg = _configs("pi05_full_droid_finetune", env, batch_size=4)
    data_config = cfg.data.create(cfg.assets_dirs, cfg.model)
    batch = next(iter(data_loader.create_rlds_dataset(data_config, cfg.model.action_horizon, 4, seed=0)))
    jax_data = jax_cfg.data.create(jax_cfg.assets_dirs, jax_cfg.model)
    loader = jax_data_loader.RLDSLoader([batch], jax_data_loader.transform_stack(jax_data, jax_cfg.model),
                                        jax.sharding.SingleDeviceSharding(jax.devices()[0]))
    with pytest.raises(ValueError, match="dimension 1"):
        next(iter(loader))
    class OneBatch:
        batch_size = 4

        def __len__(self):
            return 4

        def __iter__(self):
            yield batch

    (obs, actions), = list(data_loader.RLDSLoader(OneBatch(), data_loader.transform_stack(data_config, cfg.model),
                                                  device="cpu"))
    assert obs.state.shape == (4, 32) and actions.shape == (4, 16, 32)


def test_two_cpu_steps_through_the_stream_and_the_first_loss_against_jax(env, tmp_path, monkeypatch):
    model_fields = dict(DEBUG, action_horizon=15)
    jax_model_config = jax_pi0.Pi0Config(**model_fields)
    params = numpy_params(jax_model_config, seed=0)
    state = tsf.jax_to_torch_state(params, jax_model_config)

    def seeded_model(config, *, device="cpu"):
        model = torch_pi0.Pi0(config.model, device=device)
        torch_interop.load_jax_state(model, state)
        return model

    batches = []
    create = data_loader.create_data_loader

    def recording_loader(*args, **kwargs):
        impl = create(*args, **kwargs)
        inner = impl._loader

        class Recording:
            def __iter__(self):
                for batch in inner:
                    batches.append(batch)
                    yield batch

            def close(self):
                inner.close()

        impl._loader = Recording()
        return impl

    monkeypatch.setattr(train_lib, "create_model", seeded_model)
    monkeypatch.setattr(data_loader, "create_data_loader", recording_loader)
    _, cfg = _configs("pi05_droid_jointpos_polaris", env, batch_size=2, num_train_steps=2, exp_name="rlds",
                      checkpoint_base_dir=str(tmp_path), wandb_enabled=False, save_interval=100)
    cfg = dataclasses.replace(cfg, model=torch_pi0.Pi0Config(**model_fields),
                              weight_loader=torch_config.weight_loaders.NoOpWeightLoader())
    losses = []
    _, trained = train_lib.main(cfg, device="cpu", on_step=lambda step, record: losses.append(float(record["loss"])))
    assert trained.step == 2 and len(losses) == 2 and all(np.isfinite(losses))
    obs, actions = batches[0]
    assert obs.state.shape == (2, 32) and actions.shape == (2, 15, 32)

    model = seeded_model(cfg)
    step0 = model.compute_loss(obs, actions, train=True, generator=optimizer.step_generator(cfg.seed, 0)).mean()
    assert float(step0.detach()) == losses[0]

    # JAX's loss without augmentation (tests/test_torch_loss.py holds the augmented one), under its noise and time.
    inputs, actions_np = _port_batch(obs, actions)
    rng = jax.random.key(7)
    want = np.asarray(jax.jit(lambda p: jax_pi0.compute_loss(p, jax_model_config, rng, jax_model.Observation.from_dict(
        inputs), jnp.asarray(actions_np), train=False))(params))
    draws = jax_loss_draws(rng, 2, actions_np.shape)
    got = model.compute_loss(obs, actions, train=False, noise=draws["noise"], time=draws["time"]).detach().numpy()
    assert got.shape == want.shape == (2, 15)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def _fields(obj) -> dict:
    """A dataclass (or enum, or sequence of them) as plain values, transforms by their type and fields."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"type": type(obj).__name__, **{f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}}
    if isinstance(obj, (list, tuple)):
        return [_fields(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    if hasattr(obj, "name") and hasattr(obj, "value") and type(obj).__module__.endswith("droid_rlds_dataset"):
        return f"{type(obj).__name__}.{obj.name}"
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if callable(obj) and not isinstance(obj, type):
        return type(obj).__name__
    return obj


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_equal_jaxs(env, name):
    jax_cfg, cfg = _configs(name, env)
    want = jax_cfg.data.create(jax_cfg.assets_dirs, jax_cfg.model)
    got = cfg.data.create(cfg.assets_dirs, cfg.model)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for field in dataclasses.fields(want):
        a, b = getattr(want, field.name), getattr(got, field.name)
        if field.name == "norm_stats":
            assert set(a) == set(b) and all(
                np.array_equal(getattr(a[k], s), getattr(b[k], s)) for k in a for s in ("mean", "std", "q01", "q99"))
        elif field.name.endswith("_transforms"):
            for side in ("inputs", "outputs"):
                assert [type(t).__name__ for t in getattr(a, side)] == [type(t).__name__ for t in getattr(b, side)]
        else:
            assert _fields(a) == _fields(b), field.name
    assert got.action_space == torch_rlds.DroidActionSpace.JOINT_POSITION
    assert _fields(got.rlds_datasets) == _fields(want.rlds_datasets)
    for field in ("name", "batch_size", "num_train_steps", "log_interval", "save_interval", "keep_period",
                  "num_workers", "lr_schedule"):
        assert _fields(getattr(cfg, field)) == _fields(getattr(jax_cfg, field)), field
    assert (cfg.model.action_horizon, cfg.model.action_dim, cfg.model.pi05) == (
        jax_cfg.model.action_horizon, jax_cfg.model.action_dim, jax_cfg.model.pi05)
    assert cfg.weight_loader.params_path == jax_cfg.weight_loader.params_path
