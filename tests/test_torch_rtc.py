"""The port's RTC sampler (``kai0_tpu_torch/models/pi0_rtc.py``) and RTC serving against the JAX package's.

- ``get_prefix_weights`` equals JAX's for all four schedules (within 1e-6:
  ``expm1`` of XLA and of torch may differ by one f32 ulp);
- the sampler at dummy size, f32, 4 Euler steps, the same weights and noise,
  against ``kai0_tpu.models.pi0_rtc.sample_actions``: guidance weight 0.5 and
  5.0, with and without ``mask_prefix_delay``, a 14-dim and a 32-dim previous
  chunk, a NaN in the chunk, and no chunk (the scrubbed base step). Measured
  max abs difference 6.0e-07-1.9e-06 with |actions| ≤ 5.8; held to 1e-5;
- a raw Agilex observation carrying ``prev_action_chunk`` ([50, 14] f32),
  ``inference_delay`` and ``execute_horizon`` through both packages'
  ``create_trained_policy``: a π₀.₅ that is not RTC raises ``TypeError`` in
  both; the RTC config's actions agree within 1e-3 (BASELINE.md:27), bf16
  weights as served;
- the guided rows lie nearer the previous chunk than the unguided ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DEBUG, debug_models, model_inputs, to_torch
from kai0_tpu import interop as jax_interop
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import model as jax_model
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.models import pi0_rtc as jax_rtc
from kai0_tpu.policies import agilex_policy as jax_agilex
from kai0_tpu.policies import policy_config as jax_policy_config
from kai0_tpu.shared import normalize as jax_normalize
from kai0_tpu.training import config as jax_config_module
from kai0_tpu_torch import interop as torch_interop
from kai0_tpu_torch.models import model as torch_model
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.models import pi0_rtc as torch_rtc
from kai0_tpu_torch.policies import policy_config
from kai0_tpu_torch.training import config as torch_config_module

STEPS = 4
SAMPLER_TOL = 1e-5
ASSET_ID = "data/FlattenFold/base"


@pytest.fixture(scope="module")
def models():
    """(JAX RTC config, JAX params, the port's RTC model) at dummy size, f32, the same weights."""
    _, params, _, _ = debug_models(seed=0)
    jax_config = jax_rtc.Pi0RTCConfig(**DEBUG)
    model = torch_rtc.Pi0RTC(torch_rtc.Pi0RTCConfig(**DEBUG), device="cpu")
    torch_interop.load_jax_state(model, tsf.jax_to_torch_state(params, jax_config))
    return jax_config, params, model


@pytest.mark.parametrize("schedule", ["ones", "zeros", "linear", "exp"])
def test_prefix_weights_match_jax(schedule):
    for start, end in ((2, 6), (0, 25), (5, 3), (3, 50), (0, 1)):
        ref = np.asarray(jax_rtc.get_prefix_weights(jnp.asarray(start), jnp.asarray(end), 50, schedule))
        got = torch_rtc.get_prefix_weights(torch.tensor(float(start)), torch.tensor(float(end)), 50, schedule)
        # expm1 of XLA and of torch may differ by one f32 ulp: 1e-6 is ~8 ulps of 1.
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6, err_msg=f"{schedule} {start} {end}")
    with pytest.raises(ValueError, match="Invalid schedule"):
        torch_rtc.get_prefix_weights(torch.tensor(0.0), torch.tensor(1.0), 8, "cosine")


@pytest.mark.parametrize(
    "chunk_dim, max_guidance_weight, mask_prefix_delay, nan",
    [(14, 0.5, False, False), (14, 5.0, True, False), (32, 0.5, True, False), (32, 5.0, False, False),
     (14, 5.0, False, True), (None, 0.5, False, False)],
)
def test_sampler_matches_jax(models, chunk_dim, max_guidance_weight, mask_prefix_delay, nan):
    jax_config, params, model = models
    inputs = model_inputs(3)
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((1, 50, 32)).astype(np.float32)
    kwargs = dict(max_guidance_weight=max_guidance_weight, mask_prefix_delay=mask_prefix_delay)
    if chunk_dim is not None:
        chunk = rng.standard_normal((50, chunk_dim)).astype(np.float32)
        if nan:
            chunk[4, 2] = np.nan
            chunk[9, 0] = np.inf
        kwargs.update(prev_action_chunk=chunk, inference_delay=3, execute_horizon=25)
    ref = jax_rtc.sample_actions(params, jax_config, jax.random.key(0),
                                 jax_model.Observation.from_dict(jax.tree.map(jnp.asarray, inputs)),
                                 num_steps=STEPS, noise=jnp.asarray(noise), **kwargs)
    got = model.sample_actions(torch_model.Observation.from_dict(to_torch(inputs)), num_steps=STEPS,
                               noise=torch.from_numpy(noise), **kwargs)
    err = float(np.abs(got.numpy() - np.asarray(ref)).max())
    print(f"chunk dims {chunk_dim}, guidance {max_guidance_weight}, mask {mask_prefix_delay}, NaN {nan}: max abs {err:.3e} (tolerance {SAMPLER_TOL}; |actions| max {np.abs(ref).max():.3f})")
    assert np.isfinite(got.numpy()).all() and err <= SAMPLER_TOL, err


def test_guided_rows_move_toward_the_previous_chunk(models):
    _, _, model = models
    obs = torch_model.Observation.from_dict(to_torch(model_inputs(5)))
    noise = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 50, 32)).astype(np.float32))
    free = model.sample_actions(obs, num_steps=STEPS, noise=noise).numpy()
    prev = free + 0.5
    guided = model.sample_actions(obs, num_steps=STEPS, noise=noise, prev_action_chunk=prev, inference_delay=1,
                                  execute_horizon=6, max_guidance_weight=5.0).numpy()
    rows = slice(1, 6)
    assert np.abs(guided[0, rows, :14] - prev[0, rows, :14]).mean() < np.abs(free[0, rows, :14] - prev[0, rows, :14]).mean()
    assert np.isfinite(guided).all()


# ---------------------------------------------------------------------------
# Through create_trained_policy on a raw Agilex observation
# ---------------------------------------------------------------------------


def _stats(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1.5, -0.5, 32)
    stat = lambda: jax_normalize.NormStats(mean=np.zeros(32), std=np.ones(32), q01=lo, q99=lo + rng.uniform(1, 3, 32))  # noqa: E731
    return {"state": stat(), "actions": stat()}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    jax_model_config, params, _, _ = debug_models(seed=2)
    ckpt = tmp_path_factory.mktemp("ckpt")
    jax_interop.save_torch_checkpoint(params, jax_model_config, ckpt)
    jax_normalize.save(ckpt / "assets" / ASSET_ID, _stats(3))
    return ckpt


def _configs(name: str, jax_model_cls, torch_model_cls):
    return (dataclasses.replace(jax_config_module.get_config(name), model=jax_model_cls(**DEBUG)),
            dataclasses.replace(torch_config_module.get_config(name), model=torch_model_cls(**DEBUG)))


def _rtc_observation() -> dict:
    np.random.seed(11)
    obs = jax_agilex.make_agilex_example()
    obs["prev_action_chunk"] = np.random.default_rng(12).uniform(-1, 1, (50, 14)).astype(np.float32)
    obs["inference_delay"] = 2
    obs["execute_horizon"] = 25
    return obs


def test_rtc_keys_to_a_model_that_is_not_rtc_raise_in_both(checkpoint):
    jax_cfg, torch_cfg = _configs("pi05_flatten_fold_normal", jax_pi0.Pi0Config, torch_pi0.Pi0Config)
    with pytest.raises(TypeError):
        jax_policy_config.create_trained_policy(jax_cfg, checkpoint).infer(_rtc_observation())
    policy = policy_config.create_trained_policy(torch_cfg, checkpoint, device="cpu")
    with pytest.raises(TypeError, match="only an RTC model"):
        policy.infer(_rtc_observation())
    for key in ("inference_delay", "execute_horizon"):
        with pytest.raises(TypeError):
            policy.infer({k: v for k, v in _rtc_observation().items() if k in (key, "images", "state", "prompt")})


def test_rtc_request_matches_jax(checkpoint):
    jax_cfg, torch_cfg = _configs("pi05_rtc_flatten_fold_inference", jax_rtc.Pi0RTCConfig, torch_rtc.Pi0RTCConfig)
    noise = np.random.default_rng(4).standard_normal((50, 32)).astype(np.float32)
    ref = jax_policy_config.create_trained_policy(jax_cfg, checkpoint).infer(_rtc_observation(), noise=noise)
    policy = policy_config.create_trained_policy(torch_cfg, checkpoint, device="cpu", prompt_buckets=[64, 128])
    assert isinstance(policy.model, torch_rtc.Pi0RTC) and not any(p.requires_grad for p in policy.model.parameters())
    out = policy.infer(_rtc_observation(), noise=noise)
    unguided = policy.infer({k: v for k, v in _rtc_observation().items() if k != "prev_action_chunk"}, noise=noise)
    assert out["actions"].shape == ref["actions"].shape == (50, 14)
    err = float(np.abs(out["actions"] - np.asarray(ref["actions"])).max())
    print(f"RTC request: max abs difference of the actions {err:.3e} (|actions| max {np.abs(ref['actions']).max():.3f})")
    assert np.isfinite(out["actions"]).all() and err <= 1e-3, err
    assert not np.allclose(out["actions"], unguided["actions"], atol=1e-3)  # the chunk guided the sample
