"""The port's π₀ (``pi05=False``: the state token and the action-time MLP) against ``kai0_tpu.models.pi0``.

Debug size (``dummy``/``dummy`` Gemma, ``mu/14`` SigLIP, f32, 48 prompt
tokens), numpy-seeded weights (``_torch_parity.numpy_params``) carried across
by ``interop.state_from_jax``, which gives the tensors of JAX's
``jax_to_torch_state`` bit for bit. Tolerances:

- ``compute_loss`` [B, H] within 1e-5 x max(1, |loss|), every gradient within
  1e-4 x max(its max abs, 1e-5), JAX's value_and_grad jitted, on the same
  noise and time;
- ``sample_actions`` (10 Euler steps, the same noise) within 1e-3
  (BASELINE.md:27);
- a π₀ RTC request (``Pi0RTC`` with ``pi05=False``, guided by a previous
  chunk) within 1e-5;
- every π₀ config of the JAX registry, the ``debug*`` ones included, builds in
  the port (``train_lib.create_model``) at dummy size.

One π₀ ``train_step`` of both packages is in ``test_torch_train_step.py`` and
``create_trained_policy`` of both on a raw LIBERO observation in
``test_torch_policy_config.py``, beside their π₀.₅ counterparts.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DEBUG, model_inputs, numpy_params, to_torch
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu import interop as jax_interop
from kai0_tpu.models import model as jax_model
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.models import pi0_rtc as jax_rtc
from kai0_tpu.training import config as jax_config_module
from kai0_tpu.transforms import flatten_dict
from kai0_tpu_torch import interop
from kai0_tpu_torch.models import model as torch_model
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.models import pi0_rtc as torch_rtc
from kai0_tpu_torch.training import config as torch_config_module
from kai0_tpu_torch.training import train_lib

BATCH = 2
PI0 = dict(DEBUG, pi05=False)
HEADS = ("state_proj", "action_time_mlp_in", "action_time_mlp_out")


def _port_model(params, cls=torch_pi0.Pi0, config_cls=torch_pi0.Pi0Config):
    model = cls(config_cls(**PI0), device="cpu")
    return interop.load_jax_state(model, interop.state_from_jax({k: np.asarray(v) for k, v in flatten_dict(params).items()}, model))


@pytest.fixture(scope="module")
def models():
    jax_config = jax_pi0.Pi0Config(**PI0)
    params = numpy_params(jax_config, seed=0)
    return jax_config, params, _port_model(params)


def _draws(rng, batch: int) -> dict:
    _, noise_rng, time_rng = jax.random.split(rng, 3)
    noise = jax.random.normal(noise_rng, (batch, 50, 32))
    time = jax.random.beta(time_rng, 1.5, 1, (batch,)) * 0.999 + 0.001
    return {"noise": to_torch(noise), "time": to_torch(time)}


def test_the_model_has_the_pi0_leaves_and_the_weight_function_is_jax_interops(models):
    jax_config, params, model = models
    names = {k for k, _ in model.named_parameters()}
    assert {f"{h}.{p}" for h in HEADS for p in ("weight", "bias")} <= names
    assert not any(n.startswith("time_mlp") for n in names)
    assert not any("dense" in n for n in names)  # plain RMSNorm in both experts: use_adarms (False, False)
    assert model.action_time_mlp_in.weight.shape == (64, 128)
    want = jax_interop.jax_to_torch_state(params, jax_config)
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)


@pytest.fixture(scope="module")
def loss_setup(models):
    jax_config, params, model = models
    inputs = model_inputs(1, batch=BATCH)
    actions = np.random.default_rng(2).standard_normal((BATCH, 50, 32)).astype(np.float32)
    rng = jax.random.key(5)
    obs = jax_model.Observation.from_dict(inputs)

    def loss_fn(p):
        loss = jax_pi0.compute_loss(p, jax_config, rng, obs, jnp.asarray(actions))
        return jnp.mean(loss), loss

    (_, loss), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model.zero_grad(set_to_none=True)
    got = model.compute_loss(torch_model.Observation.from_dict(to_torch(inputs)), torch.from_numpy(actions),
                             **_draws(rng, BATCH))
    got.mean().backward()
    got_grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
                 for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return (np.asarray(loss), jax_interop.jax_to_torch_state(grads, jax_config)), (got.detach().numpy(), got_grads)


def test_loss_matches(loss_setup):
    (want, _), (got, _) = loss_setup
    assert got.shape == want.shape == (BATCH, 50) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_every_gradient_matches_including_the_pi0_heads(loss_setup):
    (_, want), (_, got) = loss_setup
    assert set(got) == set(want)
    for key, g in got.items():
        ref = np.asarray(want[key], dtype=np.float32)
        assert g.shape == ref.shape, key
        assert np.abs(g - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1e-5), (key, np.abs(g - ref).max())
    for head in HEADS:
        assert np.abs(got[f"{head}.weight"]).max() > 1e-6, head


def test_sample_actions_match(models):
    jax_config, params, model = models
    inputs = model_inputs(7, batch=BATCH)
    noise = np.random.default_rng(8).standard_normal((BATCH, 50, 32)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(jax_pi0.sample_actions, config=jax_config))(
        params, rng=jax.random.key(0), observation=jax_model.Observation.from_dict(inputs), noise=jnp.asarray(noise)))
    got = model.sample_actions(torch_model.Observation.from_dict(to_torch(inputs)), noise=torch.from_numpy(noise))
    err = float(np.abs(got.numpy() - want).max())
    print(f"π₀ actions: max abs difference {err:.3e} (|actions| max {np.abs(want).max():.3f})")
    assert got.shape == want.shape == (BATCH, 50, 32) and err <= 1e-3, err


def test_rtc_request_of_pi0_matches_jax(models):
    _, params, _ = models
    jax_config = jax_rtc.Pi0RTCConfig(**PI0)
    assert jax_config.model_type == jax_model.ModelType.PI0_RTC
    model = _port_model(params, torch_rtc.Pi0RTC, torch_rtc.Pi0RTCConfig)
    assert model.config.model_type.value == "pi0_rtc"
    inputs = model_inputs(3)
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((1, 50, 32)).astype(np.float32)
    kwargs = dict(prev_action_chunk=rng.standard_normal((50, 14)).astype(np.float32), inference_delay=3,
                  execute_horizon=25)
    sample = jax.jit(functools.partial(jax_rtc.sample_actions, config=jax_config, num_steps=2, max_guidance_weight=5.0))
    ref = sample(params, rng=jax.random.key(0), observation=jax_model.Observation.from_dict(inputs),
                 noise=jnp.asarray(noise), **kwargs)
    kwargs["max_guidance_weight"] = 5.0
    got = model.sample_actions(torch_model.Observation.from_dict(to_torch(inputs)), num_steps=2,
                               noise=torch.from_numpy(noise), **kwargs)
    err = float(np.abs(got.numpy() - np.asarray(ref)).max())
    print(f"π₀ RTC: max abs difference {err:.3e}")
    assert err <= 1e-5, err


def test_every_pi0_config_builds_at_dummy_size():
    names = [n for n, c in jax_config_module.registry().items() if type(c.model).__name__ != "Pi0FASTConfig"
             and not c.model.pi05]
    assert {"debug", "debug_restore", "debug_serve", "pi0_base", "pi0_libero_low_mem_finetune"} <= set(names)
    assert len(names) == 15
    built = {}  # configs that replace to the same dummy model share one build
    for name in names:
        cfg = torch_config_module.get_config(name)
        assert not cfg.model.pi05 and cfg.model.model_type.value == "pi0", name
        lora = "lora" in cfg.model.paligemma_variant
        model_config = dataclasses.replace(
            cfg.model, paligemma_variant="dummy_lora" if lora else "dummy",
            action_expert_variant="dummy_lora" if lora else "dummy", vision_variant="mu/14")
        if model_config not in built:
            built[model_config] = train_lib.create_model(dataclasses.replace(cfg, model=model_config), device="cpu")
        model = built[model_config]
        assert isinstance(model, torch_pi0.Pi0) and model.state_proj.in_features == cfg.model.action_dim
        mask = train_lib.trainable_mask(model)
        assert (not all(mask.values())) == lora, name
