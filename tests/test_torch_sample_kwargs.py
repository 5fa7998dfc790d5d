"""The sampler's static keyword arguments (``num_steps``, ``prefix_attention_schedule``, ``max_guidance_weight``).

JAX's ``Policy`` keys its jitted sampler on them (``kai0_tpu/policies/policy.py:38,79``) and passes
them on every call; the port's ``Policy`` passes them to the eager sampler on the CPU and keys its
CUDA graphs on them (``policies/graphs.signature``). Debug size, f32, numpy-seeded weights
(``_torch_parity.numpy_params``) in both packages, the same inputs and noise:

- π₀.₅ at ``num_steps=5``: actions within 1e-3 (BASELINE.md:27), and other than at 10 steps;
- RTC at ``num_steps=5, max_guidance_weight=5.0, prefix_attention_schedule="linear"`` with a
  previous chunk: within 1e-5 (the RTC sampler's bound, ``tests/test_torch_rtc.py``);
- a key the sampler does not take raises ``TypeError`` naming it in both packages, and the graphed
  policy refuses it when it is built (RTC's two statics on a model that is not RTC too);
- two step counts key two graphs; the default key (no kwargs) and a guided graph's last entry
  are as before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import DEBUG, model_inputs, numpy_params
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.models import pi0_rtc as jax_rtc
from kai0_tpu.policies import policy as jax_policy
from kai0_tpu_torch import interop as torch_interop
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.models import pi0_rtc as torch_rtc
from kai0_tpu_torch.policies import graphs
from kai0_tpu_torch.policies import policy as torch_policy

RTC_STATICS = {"num_steps": 5, "max_guidance_weight": 5.0, "prefix_attention_schedule": "linear"}


def _models(rtc: bool):
    jax_cls, torch_cls = (jax_rtc.Pi0RTCConfig, torch_rtc.Pi0RTC) if rtc else (jax_pi0.Pi0Config, torch_pi0.Pi0)
    jax_config = jax_cls(**DEBUG)
    params = jax.tree.map(jnp.asarray, numpy_params(jax_config, seed=3))
    model = torch_cls((torch_rtc.Pi0RTCConfig if rtc else torch_pi0.Pi0Config)(**DEBUG), device="cpu").eval()
    torch_interop.load_jax_state(model, tsf.jax_to_torch_state(params, jax_config))
    return jax_config, params, model


@pytest.fixture(scope="module")
def pi05():
    return _models(rtc=False)


@pytest.fixture(scope="module")
def rtc():
    return _models(rtc=True)


def _observation(seed: int, chunk: bool = False) -> dict:
    obs = {k: ({n: x[0] for n, x in v.items()} if isinstance(v, dict) else v[0]) for k, v in model_inputs(seed).items()}
    if chunk:
        rng = np.random.default_rng(seed + 100)
        obs.update(prev_action_chunk=rng.uniform(-1, 1, (50, 14)).astype(np.float32), inference_delay=3,
                   execute_horizon=20)
    return obs


def _both(models, sample_kwargs: dict, obs: dict, noise: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    jax_config, params, model = models
    ref = jax_policy.Policy(jax_config, params, sample_kwargs=sample_kwargs).infer(obs, noise=noise)["actions"]
    got = torch_policy.Policy(model, model.config, device="cpu", sample_kwargs=sample_kwargs).infer(obs, noise=noise)
    return got["actions"], np.asarray(ref)


def test_five_euler_steps_match_jax(pi05):
    noise = np.random.default_rng(1).standard_normal((50, 32)).astype(np.float32)
    obs = _observation(1)
    got, ref = _both(pi05, {"num_steps": 5}, obs, noise)
    err = float(np.abs(got - ref).max())
    print(f"pi05 at 5 steps: max abs difference {err:.3e} (|actions| max {np.abs(ref).max():.3f})")
    assert got.shape == ref.shape == (50, 32) and np.isfinite(got).all() and err <= 1e-3, err
    ten, _ = _both(pi05, {}, obs, noise)
    assert np.abs(ten - got).max() > 1e-2  # five steps are another sample


def test_rtc_statics_match_jax(rtc):
    noise = np.random.default_rng(2).standard_normal((50, 32)).astype(np.float32)
    obs = _observation(2, chunk=True)
    got, ref = _both(rtc, RTC_STATICS, obs, noise)
    err = float(np.abs(got - ref).max())
    print(f"RTC at {RTC_STATICS}: max abs difference {err:.3e} (|actions| max {np.abs(ref).max():.3f})")
    assert np.isfinite(got).all() and err <= 1e-5, err
    default, _ = _both(rtc, {"num_steps": 5}, obs, noise)
    assert np.abs(default - got).max() > 1e-3  # the schedule and the cap moved the guided sample


@pytest.mark.parametrize("kwargs", [{"num_step": 5}, {"max_guidance_weight": 5.0}, {"enable_rtc": False}])
def test_a_key_the_sampler_does_not_take_raises_in_both(pi05, kwargs):
    obs, noise = _observation(4), np.zeros((50, 32), np.float32)
    key = next(iter(kwargs))
    with pytest.raises(TypeError, match=key):
        _both(pi05, kwargs, obs, noise)
    jax_config, params, model = pi05
    with pytest.raises(TypeError, match=key):
        jax_policy.Policy(jax_config, params, sample_kwargs=kwargs).infer(obs, noise=noise)
    with pytest.raises(TypeError, match=key):  # the graphed policy refuses it when built (no card needed for that)
        torch_policy.Policy(model, model.config, device="cuda", sample_kwargs=kwargs)


def test_the_graphed_policy_takes_jax_statics(pi05, rtc):
    _, _, model = pi05
    torch_policy.Policy(model, model.config, device="cuda", sample_kwargs={"num_steps": 5})
    _, _, rtc_model = rtc
    torch_policy.Policy(rtc_model, rtc_model.config, device="cuda", sample_kwargs=RTC_STATICS)
    with pytest.raises(TypeError, match="mask_prefix_delay"):
        torch_policy.Policy(rtc_model, rtc_model.config, device="cuda", sample_kwargs={"mask_prefix_delay": True})
    assert graphs.STATIC_SAMPLE_KWARGS == jax_policy._STATIC_SAMPLE_KWARGS


def test_two_step_counts_key_two_graphs():
    staged = model_inputs(5)
    plain = graphs.signature(staged)
    five, ten = graphs.signature(staged, None, {"num_steps": 5}), graphs.signature(staged, None, {"num_steps": 10})
    assert len({plain, five, ten}) == 3 and five == graphs.signature(staged, None, {"num_steps": 5})
    assert plain == graphs.signature(staged, None, {}) and plain == graphs.signature(staged, None, None)
    assert five[:-1] == plain and five[-1] == ("sample_kwargs", (("num_steps", 5),), "static")
    guided = graphs.signature(staged, (50, 14), RTC_STATICS)
    assert guided[-1] == ("prev_action_chunk", (50, 14), "rtc") and guided[:-1] != plain
    assert graphs.signature(staged, (50, 14), dict(reversed(list(RTC_STATICS.items())))) == guided
