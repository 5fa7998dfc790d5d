"""``create_trained_policy`` and the checkpoint reader of the port against the JAX package's.

One dummy-size π₀.₅ (f32 compute; JAX's init with zero leaves perturbed) is
written to ``model.safetensors`` by ``kai0_tpu.interop.save_torch_checkpoint``,
beside quantile norm stats under ``assets/<asset_id>``. Then:

- the port's reader gives the tensors of JAX's ``load_torch_checkpoint`` →
  ``jax_to_torch_state`` bit for bit, in f32 and in bf16, and the port's
  writer gives a file that JAX reads back to the same tree;
- ``create_trained_policy`` of both packages, from the kai0 task config
  ``pi05_flatten_fold_normal`` with its model replaced by the dummy one
  (both load the weights into bf16, as serving does), serve the same raw
  Agilex observation (3 × 480×640 CHW uint8 cameras, 14-dim state, prompt)
  with the same noise: actions within 1e-3 (BASELINE.md:27), and within 5e-3
  with ``quantize=True`` (activation codes flip on f32 rounding, the bound of
  ``test_torch_policy.py::test_int8_infer_matches_jax_quantized_policy``);
- π₀ (``pi05=False``, numpy-seeded weights): ``create_trained_policy`` of
  both packages, ``pi0_libero`` with its model replaced by the dummy π₀, on a
  raw LIBERO observation with z-score stats: actions within 1e-3; the port's
  writer round-trips through JAX's reader bit for bit;
- the named configs: every config of the JAX registry is served by the port,
  with JAX's model type and transform chain, or raises with the ROADMAP item
  that ports it (the two π₀.₅ RLDS configs).
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DEBUG, debug_models, numpy_params
from kai0_tpu import interop as jax_interop
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.policies import agilex_policy as jax_agilex
from kai0_tpu.policies import libero_policy as jax_libero
from kai0_tpu.policies import policy_config as jax_policy_config
from kai0_tpu.shared import normalize as jax_normalize
from kai0_tpu.training import config as jax_config_module
from kai0_tpu.transforms import flatten_dict
from kai0_tpu_torch import interop
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.policies import policy_config
from kai0_tpu_torch.training import config as torch_config_module

CONFIG = "pi05_flatten_fold_normal"
ASSET_ID = "data/FlattenFold/base"  # the config's repo id


def _stats(seed: int) -> dict:
    """Quantile stats over the 32-wide state and actions (the robot transform pads before normalizing)."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1.5, -0.5, 32)
    stat = lambda: jax_normalize.NormStats(mean=np.zeros(32), std=np.ones(32), q01=lo, q99=lo + rng.uniform(1, 3, 32))  # noqa: E731
    return {"state": stat(), "actions": stat()}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(checkpoint dir, JAX params, JAX model config) of the dummy π₀.₅, written by the JAX package."""
    jax_model_config, params, _, _ = debug_models(seed=2)
    ckpt = tmp_path_factory.mktemp("ckpt")
    jax_interop.save_torch_checkpoint(params, jax_model_config, ckpt)
    jax_normalize.save(ckpt / "assets" / ASSET_ID, _stats(3))
    return ckpt, params, jax_model_config


def _configs():
    jax_cfg = jax_config_module.get_config(CONFIG)
    torch_cfg = torch_config_module.get_config(CONFIG)
    return (dataclasses.replace(jax_cfg, model=jax_pi0.Pi0Config(**DEBUG)),
            dataclasses.replace(torch_cfg, model=torch_pi0.Pi0Config(**DEBUG)))


def _observation() -> dict:
    np.random.seed(11)
    obs = jax_agilex.make_agilex_example()
    obs["state"] = (obs["state"] * 1.3).astype(np.float32)
    return obs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reader_gives_the_tensors_of_jax_reader(checkpoint, tmp_path, dtype):
    ckpt, params, model_config = checkpoint
    if dtype == "bfloat16":
        import jax

        params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
        jax_interop.save_torch_checkpoint(params, model_config, tmp_path)
        ckpt = tmp_path
    ref = jax_interop.jax_to_torch_state(jax_interop.load_torch_checkpoint(ckpt, model_config), model_config)
    got = interop.read_safetensors(ckpt / "model.safetensors")
    assert set(got) == set(ref)
    for key, value in ref.items():
        value = np.asarray(value)
        t = got[key]
        assert tuple(t.shape) == value.shape and str(t.dtype).removeprefix("torch.") == value.dtype.name, key
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), value.view(np.int16), err_msg=key)
        else:
            np.testing.assert_array_equal(t.numpy(), value, err_msg=key)


def test_writer_round_trips_through_jax_reader(checkpoint, tmp_path):
    ckpt, params, model_config = checkpoint
    model = torch_pi0.Pi0(torch_pi0.Pi0Config(**DEBUG), device="cpu")
    interop.load_torch_checkpoint(model, ckpt)
    path = interop.save_torch_checkpoint(model, tmp_path)
    assert path.name == "model.safetensors" and interop.is_torch_checkpoint(tmp_path)
    back = jax_interop.load_torch_checkpoint(tmp_path, model_config)
    flat, ref = flatten_dict(back), flatten_dict(params)
    assert set(flat) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(flat[key]), np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("quantize, tol", [(False, 1e-3), (True, 5e-3)])
def test_create_trained_policy_matches_jax(checkpoint, quantize, tol):
    ckpt, _, _ = checkpoint
    jax_cfg, torch_cfg = _configs()
    noise = np.random.default_rng(4).standard_normal((50, 32)).astype(np.float32)
    ref = jax_policy_config.create_trained_policy(jax_cfg, ckpt, quantize=quantize).infer(_observation(), noise=noise)
    policy = policy_config.create_trained_policy(torch_cfg, ckpt, quantize=quantize, device="cpu",
                                                 prompt_buckets=[64, 128])
    assert all(p.dtype == torch.bfloat16 for p in policy._model.parameters())
    out = policy.infer(_observation(), noise=noise)
    assert out["actions"].shape == ref["actions"].shape == (50, 14)
    err = float(np.abs(out["actions"] - np.asarray(ref["actions"])).max())
    print(f"quantize={quantize}: max abs difference of the actions {err:.3e} (|actions| max {np.abs(ref['actions']).max():.3f})")
    assert np.isfinite(out["actions"]).all() and err <= tol, err
    assert {"infer_ms", "transform_ms", "stage_ms"} <= set(out["policy_timing"])


def test_buckets_leave_the_actions_and_warmup_captures_nothing_on_the_cpu(checkpoint):
    ckpt, _, _ = checkpoint
    _, torch_cfg = _configs()
    noise = np.random.default_rng(5).standard_normal((50, 32)).astype(np.float32)
    full = policy_config.create_trained_policy(torch_cfg, ckpt, device="cpu")
    bucketed = policy_config.create_trained_policy(torch_cfg, ckpt, device="cpu", prompt_buckets=[64, 128],
                                                   warmup=True)
    assert bucketed.graphs == {}
    staged = bucketed.stage_inputs(_observation())
    assert staged["tokenized_prompt"].shape == (1, 64) and staged["state"].dtype == np.float32
    a, b = full.infer(_observation(), noise=noise)["actions"], bucketed.infer(_observation(), noise=noise)["actions"]
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


PI0 = dict(DEBUG, pi05=False)
PI0_HEADS = ("state_proj", "action_time_mlp_in", "action_time_mlp_out")


def test_create_trained_policy_on_libero_matches_jax_and_the_writer_round_trips(tmp_path):
    jax_config = jax_pi0.Pi0Config(**PI0)
    params = numpy_params(jax_config, seed=0)
    jax_interop.save_torch_checkpoint(params, jax_config, tmp_path)
    rng = np.random.default_rng(3)
    stat = lambda: jax_normalize.NormStats(mean=rng.uniform(-0.5, 0.5, 32), std=rng.uniform(0.5, 2, 32))  # noqa: E731
    jax_normalize.save(tmp_path / "assets" / "physical-intelligence" / "libero", {"state": stat(), "actions": stat()})
    jax_cfg = dataclasses.replace(jax_config_module.get_config("pi0_libero"), model=jax_config)
    torch_cfg = dataclasses.replace(torch_config_module.get_config("pi0_libero"), model=torch_pi0.Pi0Config(**PI0))
    np.random.seed(11)
    obs = jax_libero.make_libero_example()
    noise = np.random.default_rng(4).standard_normal((50, 32)).astype(np.float32)
    ref = jax_policy_config.create_trained_policy(jax_cfg, tmp_path).infer(obs, noise=noise)["actions"]
    out = policy_config.create_trained_policy(torch_cfg, tmp_path, device="cpu").infer(obs, noise=noise)["actions"]
    err = float(np.abs(out - np.asarray(ref)).max())
    print(f"pi0_libero through create_trained_policy: max abs difference {err:.3e}")
    assert out.shape == np.asarray(ref).shape == (50, 7) and err <= 1e-3, err

    model = torch_pi0.Pi0(torch_pi0.Pi0Config(**PI0), device="cpu")
    interop.load_jax_state(model, interop.state_from_jax({k: np.asarray(v) for k, v in flatten_dict(params).items()},
                                                         model))
    interop.save_torch_checkpoint(model, tmp_path / "port")
    back = flatten_dict(jax_interop.load_torch_checkpoint(tmp_path / "port", jax_config))
    flat = flatten_dict(params)
    assert set(back) == set(flat) and {f"{h}/kernel" for h in PI0_HEADS} <= set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(np.asarray(back[key]), np.asarray(value), err_msg=key)


def test_every_named_config_is_served_or_names_its_roadmap_item(monkeypatch):
    # The FAST configs build a FASTTokenizer in both packages: without transformers neither asks the hub for its
    # processor (the JAX package's from_pretrained(local_files_only=True) still queries it for optional files).
    monkeypatch.setitem(sys.modules, "transformers", None)
    for name in jax_config_module.registry():
        try:
            cfg = torch_config_module.get_config(name)
        except NotImplementedError as e:
            assert "ROADMAP Queue 1 item" in str(e), (name, e)
            continue
        jax_model_type = jax_config_module.get_config(name).model.model_type
        assert cfg.name == name and cfg.model.model_type.value == jax_model_type.value, name
        data = cfg.data.create(cfg.assets_dirs, cfg.model)
        jax_cfg = jax_config_module.get_config(name)
        if jax_cfg.data.assets.assets_dir is None:  # a local assets path: JAX builds its chain offline too
            ref = jax_cfg.data.create(jax_cfg.assets_dirs, jax_cfg.model)
            for group in ("repack_transforms", "data_transforms", "model_transforms"):
                for side in ("inputs", "outputs"):
                    names = [type(t).__name__ for t in getattr(getattr(data, group), side)]
                    assert names == [type(t).__name__ for t in getattr(getattr(ref, group), side)], (name, group)
            assert (data.asset_id, data.use_quantile_norm) == (ref.asset_id, ref.use_quantile_norm)
    assert {f"pi05_{t}_{k}" for t in ("flatten_fold", "tee_shirt_sort", "hang_cloth") for k in ("normal", "awbc")} <= set(
        torch_config_module.registry())
    assert {"debug", "debug_serve", "pi0_aloha", "pi0_fast_droid", "paligemma_vq_droid"} <= set(torch_config_module.registry())
    # The two configs of the RLDS stream load, their data configs carry its mix.
    for name, mix in (("pi05_full_droid_finetune", 1), ("pi05_droid_jointpos_polaris", 2)):
        cfg = torch_config_module.get_config(name)
        data = dataclasses.replace(cfg.data, rlds_data_dir="/rlds").create(cfg.assets_dirs, cfg.model)
        assert cfg.name == name and data.rlds_data_dir == "/rlds" and len(data.rlds_datasets) == mix
    with pytest.raises(ValueError, match="Did you mean"):
        torch_config_module.get_config("pi05_flaten_fold_normal")


def test_checkpoint_errors(tmp_path):
    _, torch_cfg = _configs()
    (tmp_path / "params").mkdir()
    with pytest.raises(NotImplementedError, match="Orbax"):
        policy_config.create_trained_policy(torch_cfg, tmp_path, device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        policy_config.create_trained_policy(torch_cfg, tmp_path, device="cpu", fsdp_devices=2)
    with pytest.raises(FileNotFoundError):
        policy_config.create_trained_policy(torch_cfg, tmp_path / "none", device="cpu")
