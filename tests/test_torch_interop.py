"""``kai0_tpu_torch.interop.load_jax_state`` on the output of ``jax_to_torch_state``.

The port's parameter names are the ``PI0Pytorch`` layout the JAX package's
interop emits: a strict load leaves no key missing or unexpected, and every
value arrives bit for bit, in f32 and in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DEBUG, perturb_zero_leaves
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu_torch import interop as torch_interop
from kai0_tpu_torch.models import pi0 as torch_pi0


@pytest.fixture(scope="module")
def jax_state():
    config = jax_pi0.Pi0Config(**DEBUG)
    params = perturb_zero_leaves(config.init_params(jax.random.key(0)), seed=0)
    return config, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strict_load_is_exact(jax_state, dtype):
    config, params = jax_state
    if dtype == "bfloat16":
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    state = tsf.jax_to_torch_state(params, config)
    model = torch_pi0.Pi0(torch_pi0.Pi0Config(**DEBUG), device="cpu", param_dtype=getattr(torch, dtype))

    own = model.state_dict()
    assert set(own) == set(state)  # nothing missing, nothing unexpected
    torch_interop.load_jax_state(model, state)
    for key, value in model.state_dict().items():
        ref = np.asarray(state[key])
        assert tuple(value.shape) == ref.shape, key
        if dtype == "bfloat16":
            assert value.dtype == torch.bfloat16
            np.testing.assert_array_equal(value.view(torch.int16).numpy().view(np.uint16), ref.view(np.uint16), err_msg=key)
        else:
            np.testing.assert_array_equal(value.numpy(), ref, err_msg=key)


def test_strict_load_rejects_missing_and_unexpected_keys(jax_state):
    config, params = jax_state
    state = tsf.jax_to_torch_state(params, config)
    model = torch_pi0.Pi0(torch_pi0.Pi0Config(**DEBUG), device="cpu")
    missing = dict(state)
    missing.pop("time_mlp_in.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        torch_interop.load_jax_state(model, missing)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        torch_interop.load_jax_state(model, {**state, "state_proj.weight": np.zeros((64, 32), np.float32)})


def test_key_layout_matches_the_reference_names():
    keys = set(torch_pi0.Pi0(torch_pi0.Pi0Config(**DEBUG), device="cpu").state_dict())
    for key in (
        "paligemma_with_expert.paligemma.model.language_model.layers.0.self_attn.q_proj.weight",
        "paligemma_with_expert.paligemma.model.language_model.embed_tokens.weight",
        "paligemma_with_expert.gemma_expert.model.layers.3.input_layernorm.dense.weight",
        "paligemma_with_expert.gemma_expert.model.norm.dense.bias",
        "paligemma_with_expert.paligemma.model.vision_tower.vision_model.encoder.layers.0.mlp.fc1.weight",
        "paligemma_with_expert.paligemma.model.multi_modal_projector.linear.weight",
        "time_mlp_out.bias",
    ):
        assert key in keys, key


def test_only_pi05_is_ported():
    # π₀ is ported too now: each model has its own suffix leaves and no other's.
    pi0 = {k for k, _ in torch_pi0.Pi0(torch_pi0.Pi0Config(**{**DEBUG, "pi05": False}), device="cpu").named_parameters()}
    pi05 = {k for k, _ in torch_pi0.Pi0(torch_pi0.Pi0Config(**DEBUG), device="cpu").named_parameters()}
    heads = {f"{h}.{p}" for h in ("state_proj", "action_time_mlp_in", "action_time_mlp_out") for p in ("weight", "bias")}
    time_mlp = {f"{h}.{p}" for h in ("time_mlp_in", "time_mlp_out") for p in ("weight", "bias")}
    assert heads <= pi0 and not time_mlp & pi0 and time_mlp <= pi05 and not heads & pi05
