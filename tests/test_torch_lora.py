"""``kai0_tpu_torch.models.lora``, the freeze filter and the LoRA interop against the JAX package.

Same numpy inputs and factors through both packages on the CPU. Tolerances:
the einsum and FFN terms are a few f32 matrix products summed in another
order, 1e-5 x max |value| in f32; in bf16 each product rounds to bf16 once in
both packages, but the sums before it differ, 2e-2 x max |value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DEBUG, debug_lora_models
from kai0_tpu.models import lora as jax_lora
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.transforms import flatten_dict
from kai0_tpu_torch import interop, param_paths
from kai0_tpu_torch.models import gemma, lora
from kai0_tpu_torch.models import pi0 as torch_pi0

N, K, D, H, R = 4, 1, 32, 8, 4
EINSUMS = {
    "q": ("BTD,NDH->BTNH", (2, 7, D), (N, D, H)),
    "kv": ("BSD,2KDH->2BSKH", (2, 7, D), (2, K, D, H)),
    "qkv": ("BSD,3KDH->3BSKH", (2, 7, D), (3, N, D, H)),
    "out": ("BTNH,NHD->BTD", (2, 7, N, H), (N, H, D)),
}


@pytest.mark.parametrize("rslora", [False, True])
@pytest.mark.parametrize("site", list(EINSUMS))
def test_apply_einsum_matches_jax(site, rslora):
    eqn, x_shape, w_shape = EINSUMS[site]
    rng = np.random.default_rng(len(site))
    config = dict(rank=R, alpha=6.0, rslora=rslora)
    shape_a, shape_b = lora.lora_shapes(w_shape, lora.LoRAConfig(**config))
    x, w, a, b = (rng.standard_normal(s).astype(np.float32) for s in (x_shape, w_shape, shape_a, shape_b))
    params = {"w": jnp.asarray(w), "lora_a": jnp.asarray(a), "lora_b": jnp.asarray(b)}
    assert jax_lora.init_einsum(jax.random.key(0), w_shape, lambda k, s: jnp.zeros(s), jax_lora.LoRAConfig(**config))[
        "lora_a"].shape == shape_a
    want = np.asarray(jax_lora.apply_einsum(params, eqn, jnp.asarray(x), jax_lora.LoRAConfig(**config)))
    base = torch.einsum(lora._letters(eqn), torch.from_numpy(x), torch.from_numpy(w))
    got = lora.apply_einsum(base, eqn, torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), lora.LoRAConfig(**config))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(got.numpy() - base.numpy()).max() > 0.1  # the scaled term is there
    assert lora.apply_einsum(base, eqn, torch.from_numpy(x), None, None, None) is base


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("with_lora", [True, False])
def test_apply_ffn_split_path_matches_jax(with_lora, dtype, tol):
    d, f = 32, 96
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    params = {
        "gating_einsum": rng.standard_normal((2, d, f)).astype(np.float32) / np.sqrt(d),
        "linear": rng.standard_normal((f, d)).astype(np.float32) / np.sqrt(f),
    }
    if with_lora:  # unscaled in the FFN, whatever alpha says
        for name, shape in (("gating_einsum_lora_a", (2, d, R)), ("gating_einsum_lora_b", (2, R, f)),
                            ("linear_lora_a", (f, R)), ("linear_lora_b", (R, d))):
            params[name] = 0.3 * rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jax_lora.apply_ffn({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x, jdt)).astype(jnp.float32))

    config = gemma.Config(width=d, depth=1, mlp_dim=f, num_heads=N, num_kv_heads=K, head_dim=H,
                          lora_ffn=lora.LoRAConfig(rank=R, alpha=64.0) if with_lora else None)
    mlp = gemma.FeedForward(config)
    state = {"gate_proj.weight": params["gating_einsum"][0].T, "up_proj.weight": params["gating_einsum"][1].T,
             "down_proj.weight": params["linear"].T}
    if with_lora:
        state.update(gating_lora_a=params["gating_einsum_lora_a"], gating_lora_b=params["gating_einsum_lora_b"],
                     linear_lora_a=params["linear_lora_a"], linear_lora_b=params["linear_lora_b"])
    interop.load_jax_state(mlp, state)
    got = mlp(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert np.abs(got.float().detach().numpy() - want).max() <= tol * np.abs(want).max()


VARIANTS = [("dummy", "dummy"), ("dummy_lora", "dummy"), ("dummy", "dummy_lora"), ("dummy_lora", "dummy_lora")]


@pytest.mark.parametrize("paligemma,expert", VARIANTS)
def test_freeze_filter_marks_the_same_leaves_as_jax(paligemma, expert):
    overrides = dict(DEBUG, paligemma_variant=paligemma, action_expert_variant=expert)
    jax_config = jax_pi0.Pi0Config(**overrides)
    shapes = jax.eval_shape(jax_config.init_params, jax.random.key(0))
    jax_frozen = jax_config.freeze_filter()
    want = {path: jax_frozen(path) for path in flatten_dict(shapes)}

    torch_config = torch_pi0.Pi0Config(**overrides)
    model = torch_pi0.Pi0(torch_config, device="meta")
    frozen = torch_config.freeze_filter()
    seen = set()
    for name, _ in model.named_parameters():
        path = param_paths.jax_param_path(name)
        if "/llm/" in path:  # Gemma names map leaf for leaf
            assert path in want, (name, path)
            assert frozen(name) == want[path], name
            seen.add(path)
        else:  # SigLIP and the projections never freeze
            assert not frozen(name) and not any(v for k, v in want.items() if "/llm/" not in k)
    assert seen == {k for k in want if "/llm/" in k}  # every JAX Gemma leaf has its port parameters
    n_frozen = sum(frozen(n) for n, _ in model.named_parameters())
    assert (n_frozen > 0) == ("lora" in paligemma + expert)
    if "lora" in paligemma + expert:
        assert not any(frozen(n) for n, _ in model.named_parameters() if "lora" in n)


def test_lora_factors_cross_the_interop_leaf_for_leaf():
    _, params, _, model = debug_lora_models(seed=2, freeze=False)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params).items()}
    lora_leaves = {k: v for k, v in flat.items() if "lora" in k}
    assert len(lora_leaves) == 2 * (3 * 2 + 4)  # per expert: q, kv, out (a, b) and the FFN's four
    state = interop.lora_state_from_jax(flat)
    assert len(state) == 4 * len(lora_leaves)  # one tensor per layer
    got = dict(model.named_parameters())
    for name, value in state.items():
        layer = int(name.split(".layers.")[1].split(".")[0])
        np.testing.assert_array_equal(got[name].detach().numpy(), flat[param_paths.jax_param_path(name)][layer])
    assert flat["PaliGemma/llm/layers/attn/kv_einsum_1/lora_a"].shape == (4, 2, 1, 64, 4)  # per head, K then V
    assert flat["PaliGemma/llm/layers/mlp/gating_einsum_lora_b"].shape == (4, 2, 4, 128)
    assert {n for n in got if "lora" in n} == set(state)
