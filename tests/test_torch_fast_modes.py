"""π₀-FAST served in int8, and FAST's temperature sampling, against the JAX package.

Debug size (``dummy`` Gemma, ``mu/14`` SigLIP, f32, 48 prompt tokens, 8-dim actions over 10
steps), numpy-seeded weights (``_torch_parity.numpy_params``) carried across by
``interop.state_from_jax``:

- int8: ``create_trained_policy(..., quantize=True)`` of both packages on ``pi0_fast_droid`` cut to
  that size (the setup of ``tests/test_quant.py::test_quantized_inference_pi0_fast_decodes``,
  through the serving chain: a raw DROID observation, 256 decode steps): the actions within 5e-3
  (int8 π₀.₅ serving's bound; activation codes may flip on f32 rounding), and the quantized
  models' greedy token buffers of ``sample_actions`` equal;
- temperature: JAX draws with ``jax.random.categorical``, the port with ``torch.multinomial``, so
  the draws are not compared. Held: the token buffer's shape and dtype and its EOS trim (zeros
  after the step at which every row drew EOS) while sampling, the same tokens from two runs on
  one seeded ``torch.Generator`` (and through ``Policy`` with ``sample_kwargs``), other tokens
  from another seed, and JAX's greedy tokens as the temperature goes to 0 (1e-8).
"""

import dataclasses
import functools
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_parity import numpy_params, to_torch
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu import transforms as jax_transforms
from kai0_tpu.models import model as jax_model
from kai0_tpu.models import pi0_fast as jax_fast
from kai0_tpu.ops import quant as jax_quant
from kai0_tpu.policies import droid_policy as jax_droid
from kai0_tpu.policies import policy_config as jax_policy_config
from kai0_tpu.shared import normalize as jax_normalize
from kai0_tpu.training import config as jax_config_module
from kai0_tpu_torch import interop
from kai0_tpu_torch.models import model as torch_model
from kai0_tpu_torch.models import pi0_fast
from kai0_tpu_torch.ops import quant
from kai0_tpu_torch.policies import policy as torch_policy
from kai0_tpu_torch.policies import policy_config
from kai0_tpu_torch.training import config as torch_config_module

TOKENS, STEPS = 48, 8
FAST = dict(paligemma_variant="dummy", vision_variant="mu/14", dtype="float32", action_dim=8, action_horizon=10,
            max_token_len=TOKENS)
INT8_TOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def no_hf_processor():
    """``transformers`` does not import, so neither package asks the hub for a FAST processor."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)
        yield


def _port_model(params):
    model = pi0_fast.Pi0FAST(pi0_fast.Pi0FASTConfig(**FAST), device="cpu")
    flat = {k: np.asarray(v) for k, v in jax_transforms.flatten_dict(params).items()}
    return interop.load_jax_state(model, interop.state_from_jax(flat, model))


@pytest.fixture(scope="module")
def models():
    jax_config = jax_fast.Pi0FASTConfig(**FAST)
    params = numpy_params(jax_config, seed=0)
    return jax_config, params, _port_model(params)


def _inputs(seed: int, batch: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    used = (20, 31)[:batch]
    mask = np.zeros((batch, TOKENS), bool)
    ar = np.zeros((batch, TOKENS), np.int32)
    for b in range(batch):
        mask[b, : used[b]] = True
        ar[b, used[b] - 6 : used[b]] = 1
    tokens = rng.integers(2, 257_152, (batch, TOKENS), dtype=np.int32)
    return {
        "image": {k: rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8) for k in pi0_fast.FAST_IMAGE_KEYS},
        "image_mask": {k: np.ones(batch, bool) for k in pi0_fast.FAST_IMAGE_KEYS},
        "state": rng.standard_normal((batch, 8)).astype(np.float32),
        "tokenized_prompt": np.where(mask, tokens, 0).astype(np.int32),
        "tokenized_prompt_mask": mask,
        "token_ar_mask": ar,
        "token_loss_mask": ar.astype(bool),
    }


def _sample(model, inputs, **kwargs) -> np.ndarray:
    obs = torch_model.Observation.from_dict(to_torch(inputs))
    return model.sample_actions(obs, max_decoding_steps=STEPS, **kwargs).numpy()


def _jax_greedy(jax_config, params, inputs) -> np.ndarray:
    sample = jax.jit(functools.partial(jax_fast.sample_actions, config=jax_config, max_decoding_steps=STEPS))
    return np.asarray(sample(params, rng=jax.random.key(1), observation=jax_model.Observation.from_dict(inputs)))


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def droid_checkpoint(models, tmp_path_factory):
    _, _, model = models
    ckpt = tmp_path_factory.mktemp("fast_int8")
    interop.save_torch_checkpoint(model, ckpt)
    rng = np.random.default_rng(3)
    lo = rng.uniform(-1.5, -0.5, 8)
    stat = lambda: jax_normalize.NormStats(mean=np.zeros(8), std=np.ones(8), q01=lo, q99=lo + rng.uniform(1, 3, 8))  # noqa: E731
    jax_normalize.save(ckpt / "assets" / "lerobot" / "droid_100", {"state": stat(), "actions": stat()})
    return ckpt


def test_int8_fast_serving_matches_jax(models, droid_checkpoint, monkeypatch):
    for name in ("KAI0_INT8_SITES", "KAI0_INT8_SIGLIP", "KAI0_INT8_WEIGHT_ONLY"):
        monkeypatch.delenv(name, raising=False)
    jax_config, params, _ = models
    jax_cfg = dataclasses.replace(jax_config_module.get_config("pi0_fast_droid"), model=jax_config)
    torch_cfg = dataclasses.replace(torch_config_module.get_config("pi0_fast_droid"),
                                    model=pi0_fast.Pi0FASTConfig(**FAST))
    np.random.seed(13)
    obs = jax_droid.make_droid_example()
    ref_policy = jax_policy_config.create_trained_policy(jax_cfg, droid_checkpoint, params=params, quantize=True)
    policy = policy_config.create_trained_policy(torch_cfg, droid_checkpoint, device="cpu", quantize=True)
    held = [m for m in policy.model.modules() if isinstance(m, quant.QuantLinear)]
    assert held and all(m.qweight.dtype == torch.int8 and not m.weight_only for m in held)
    want = np.asarray(ref_policy.infer(obs)["actions"])
    got = policy.infer(obs)["actions"]
    err = float(np.abs(got - want).max())
    print(f"int8 FAST request: max abs difference of the actions {err:.3e} (|actions| max {np.abs(want).max():.3f})")
    assert got.shape == want.shape == (10, 8) and np.isfinite(got).all() and np.abs(want).max() > 0
    assert err <= INT8_TOL, err
    # The quantized models' greedy token buffers, at model level.
    inputs = _inputs(6)
    ref_tokens = _jax_greedy(jax_config, jax_quant.quantize_inference_tree(params), inputs)
    np.testing.assert_array_equal(_sample(policy.model, inputs), ref_tokens)


# ---------------------------------------------------------------------------
# Temperature
# ---------------------------------------------------------------------------


def test_greedy_tokens_as_the_temperature_goes_to_zero(models):
    jax_config, params, model = models
    inputs = _inputs(5)
    want = _jax_greedy(jax_config, params, inputs)
    got = _sample(model, inputs, temperature=1e-8, generator=torch.Generator().manual_seed(0))
    assert got.shape == want.shape == (2, STEPS) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_a_seeded_generator_gives_the_same_draws(models):
    _, _, model = models
    inputs = _inputs(7)
    first, again, other = (_sample(model, inputs, temperature=1.0, generator=torch.Generator().manual_seed(seed))
                           for seed in (4, 4, 5))
    assert first.shape == (2, STEPS) and first.dtype == np.float32 and (first >= 0).all()
    np.testing.assert_array_equal(first, again)
    assert not np.array_equal(first, other)
    assert not np.array_equal(first, _sample(model, inputs))  # the draws are not the greedy tokens


def test_sampling_stops_and_trims_at_the_step_every_row_draws_eos(models, monkeypatch):
    _, _, model = models
    calls = []
    decode = pi0_fast._gemma.decode_logits

    def eos_at_step_2(lm, x):  # the third logits a request reads (the prefill's, then each decode step's)
        logits = decode(lm, x)
        calls.append(None)
        if len(calls) == 3:
            logits = logits.clone()
            logits[..., pi0_fast.PALIGEMMA_EOS_TOKEN] = 1e4
        return logits

    monkeypatch.setattr(pi0_fast._gemma, "decode_logits", eos_at_step_2)
    got = _sample(model, _inputs(8), temperature=0.7, generator=torch.Generator().manual_seed(1))
    assert got.shape == (2, STEPS) and len(calls) == 3  # no decode step after the EOS step
    assert (got[:, 2] == pi0_fast.PALIGEMMA_EOS_TOKEN).all() and not got[:, 3:].any() and got[:, :2].all()


def test_the_policy_passes_the_temperature_to_the_sampler(models):
    _, _, model = models
    inputs = {k: ({n: x[0] for n, x in v.items()} if isinstance(v, dict) else v[0]) for k, v in _inputs(9, 1).items()}
    runs = [torch_policy.Policy(model, model.config, device="cpu", generator=torch.Generator().manual_seed(seed),
                                sample_kwargs={"temperature": 1.0, "max_decoding_steps": STEPS}).infer(inputs)
            for seed in (2, 2)]
    assert runs[0]["actions"].shape == (STEPS,)
    np.testing.assert_array_equal(runs[0]["actions"], runs[1]["actions"])
    greedy = torch_policy.Policy(model, model.config, device="cpu",
                                 sample_kwargs={"max_decoding_steps": STEPS}).infer(inputs)["actions"]
    assert not np.array_equal(runs[0]["actions"], greedy)
