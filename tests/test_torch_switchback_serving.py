"""SwitchBack in the port's serving entry against the JAX package's, on the CPU.

JAX's ``create_trained_policy`` installs the config's knobs
(``apply_model_knobs``) and its models read ``KAI0_INT8_SB_GEMMA`` /
``KAI0_INT8_SB`` when they trace, so it serves through SwitchBack products
whenever the variable (or ``--knobs.int8_sb_gemma``) selects them; the port's
``create_trained_policy`` resolves the same knobs and installs
``ops/quant.switchback_tree`` before serving. One debug π₀.₅ checkpoint
(numpy-seeded, written by the JAX package) behind ``pi05_flatten_fold_normal``'s
Agilex transforms, one raw observation, fixed noise.

Tolerances: SwitchBack serving within 5e-3 of JAX's actions (the int8 serving
bar of ``test_torch_policy_config.py``: each product is bit-equal to JAX's,
but activation codes flip on f32 rounding through the model); with
``quantize`` the frozen int8 holders keep their product in both packages, so
the request is int8 serving's, within the same 5e-3. The config's knobs and
the environment's precedence: the port's actions bit-equal between the two
ways of selecting SwitchBack, and bit-equal to the bf16 policy's when the
environment turns the config's choice off.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import DEBUG, numpy_params
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu import interop as jax_interop
from kai0_tpu import knobs as jax_knobs
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.policies import agilex_policy as jax_agilex
from kai0_tpu.policies import policy_config as jax_policy_config
from kai0_tpu.shared import normalize as jax_normalize
from kai0_tpu.training import config as jax_config_module
from kai0_tpu_torch import knobs
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.ops import quant
from kai0_tpu_torch.policies import policy_config
from kai0_tpu_torch.training import config as torch_config_module

CONFIG = "pi05_flatten_fold_normal"
ASSET_ID = "data/FlattenFold/base"
TOL = 5e-3
# The debug model's Gemma FFN layers (gate, up, down) of both experts: depth 4 (dummy) each.
FFN_LAYERS = 2 * 4 * 3


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    """No int8 variable set, and JAX's process-wide config layer (written by ``apply_model_knobs``) restored."""
    for name in knobs.ENV.values():
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jax_knobs, "_configured", jax_knobs._configured)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    jax_model_config = jax_pi0.Pi0Config(**DEBUG)
    params = numpy_params(jax_model_config, seed=21)
    ckpt = tmp_path_factory.mktemp("ckpt")
    jax_interop.save_torch_checkpoint(params, jax_model_config, ckpt)
    rng = np.random.default_rng(22)
    lo = rng.uniform(-1.5, -0.5, 32)
    stat = lambda: jax_normalize.NormStats(mean=np.zeros(32), std=np.ones(32), q01=lo, q99=lo + rng.uniform(1, 3, 32))  # noqa: E731
    jax_normalize.save(ckpt / "assets" / ASSET_ID, {"state": stat(), "actions": stat()})
    return ckpt


def _configs(torch_knobs: knobs.Knobs | None = None):
    jax_cfg = dataclasses.replace(jax_config_module.get_config(CONFIG), model=jax_pi0.Pi0Config(**DEBUG))
    torch_cfg = dataclasses.replace(torch_config_module.get_config(CONFIG), model=torch_pi0.Pi0Config(**DEBUG))
    if torch_knobs is not None:
        torch_cfg = dataclasses.replace(torch_cfg, knobs=torch_knobs)
    return jax_cfg, torch_cfg


def _observation() -> dict:
    np.random.seed(23)
    return jax_agilex.make_agilex_example()


NOISE = np.random.default_rng(24).standard_normal((50, 32)).astype(np.float32)


def _switchback_layers(policy) -> list[str]:
    return [name for name, m in policy.model.named_modules() if quant.is_switchback(m)]


def _port_actions(cfg, ckpt, **kwargs):
    policy = policy_config.create_trained_policy(cfg, ckpt, device="cpu", **kwargs)
    return policy, policy.infer(_observation(), noise=NOISE)["actions"]


@pytest.mark.parametrize("quantize", [False, True])
def test_switchback_serving_matches_jax(checkpoint, monkeypatch, quantize):
    monkeypatch.setenv("KAI0_INT8_SB_GEMMA", "ffn")
    jax_cfg, torch_cfg = _configs()
    want = np.asarray(jax_policy_config.create_trained_policy(jax_cfg, checkpoint, quantize=quantize)
                      .infer(_observation(), noise=NOISE)["actions"])
    policy, got = _port_actions(torch_cfg, checkpoint, quantize=quantize)
    layers = _switchback_layers(policy)
    if quantize:  # every Gemma site is a frozen int8 holder, which keeps its product (lora.py:64-71)
        assert layers == [] and quant.has_quant(policy.model)
    else:
        assert len(layers) == FFN_LAYERS and all(name.split(".")[-1] in ("gate_proj", "up_proj", "down_proj")
                                                 for name in layers), layers
    err = float(np.abs(got - want).max())
    rel = err / float(np.abs(want).max())
    print(f"SwitchBack serving (quantize={quantize}): actions {got.shape} f64, max abs {err:.3e}, relative to "
          f"max |a| {rel:.3e}")
    assert got.shape == want.shape == (50, 14) and np.isfinite(got).all()
    assert err <= TOL, err


def test_switchback_moves_the_served_actions_off_bf16(checkpoint, monkeypatch):
    """The products really are SwitchBack's: the actions leave the bf16 policy's by more than f32 rounding."""
    _, torch_cfg = _configs()
    _, plain = _port_actions(torch_cfg, checkpoint)
    monkeypatch.setenv("KAI0_INT8_SB_GEMMA", "ffn")
    _, switched = _port_actions(torch_cfg, checkpoint)
    assert np.abs(switched - plain).max() > 1e-5


@pytest.mark.parametrize("environment", [None, "0"])
def test_config_knobs_reach_serving_and_the_environment_wins(checkpoint, monkeypatch, environment):
    _, torch_cfg = _configs(knobs.Knobs(int8_sb_gemma="ffn"))
    if environment is not None:
        monkeypatch.setenv("KAI0_INT8_SB_GEMMA", environment)
    policy, got = _port_actions(torch_cfg, checkpoint)
    monkeypatch.setenv("KAI0_INT8_SB_GEMMA", "ffn" if environment is None else "0")
    _, want = _port_actions(_configs()[1], checkpoint)
    assert len(_switchback_layers(policy)) == (FFN_LAYERS if environment is None else 0)
    np.testing.assert_array_equal(got, want)
    assert all(p.dtype == torch.bfloat16 for p in policy.model.parameters())
