"""``kai0_tpu_torch.ops.quant`` against the frozen-base half of ``kai0_tpu.ops.quant``.

Identical inputs (numpy, from a seed) go through both packages on the CPU, the
port's kernels' plain versions standing in for K5, K4b and K4a. With identical
inputs every int8 operation is exact or a fixed sequence of f32 operations, so
codes, scales, ``qmm`` and its straight-through ``dx`` are held **bit-equal**
(but for the f32 ``qmm`` with an added term, where XLA fuses the last multiply
and the add on the CPU: 2^-22 x max |y|).
The fused FFN has small f32 matrix products around the int8 ones (``x @ a``,
the factor gradients), which the two frameworks sum in different orders:
forward and ``dx`` within 2e-6 x max |value| in f32, the six LoRA gradients
within 1e-5 x max |gradient| (inputs chosen so that no activation lands on a
rounding boundary of the act quantization; a flipped code would show as 1/127
of a row's scale).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import debug_lora_models
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.ops import quant as jax_quant
from kai0_tpu.transforms import flatten_dict, unflatten_dict
from kai0_tpu_torch import interop
from kai0_tpu_torch.ops import quant

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


@pytest.fixture(scope="module")
def quantized_models():
    return debug_lora_models(seed=0, quantize=True)


def test_codes_and_scales_of_every_site_match_jax_bit_for_bit(quantized_models):
    _, params, _, model = quantized_models
    flat = flatten_dict(params)
    sites = {k: (np.asarray(v.q), np.asarray(v.s)) for k, v in flat.items() if jax_quant.is_quant(v)}
    assert len(sites) == 10  # q, kv, attn_vec, gating, linear of both experts
    want = interop.quant_state_from_jax(sites)
    state = model.state_dict()
    assert len(want) == 2 * 6 * 4 * 2 and set(want) <= set(state)  # 6 holders a layer (K and V share one), 4 layers, 2 experts
    for key, value in want.items():
        assert state[key].dtype == (torch.int8 if key.endswith("qweight") else torch.float32)
        np.testing.assert_array_equal(state[key].numpy(), value, err_msg=key)
    # ... and the round trip through load_state_dict puts JAX's codes into the port's holders
    for key in want:
        state[key].zero_()
    result = model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in want.items()}, strict=False)
    assert not result.unexpected_keys and not set(result.missing_keys) & set(want)
    assert all(np.array_equal(model.state_dict()[k].numpy(), v) for k, v in want.items())


def test_dequantize_tree_matches_jax(quantized_models):
    jax_config, params, torch_config, _ = quantized_models
    _, _, _, model = debug_lora_models(seed=0, quantize=True)
    assert quant.has_quant(model)
    quant.dequantize_tree(model)
    assert not quant.has_quant(model)
    flat = flatten_dict(jax_quant.dequantize_tree(params))
    base = unflatten_dict({k: np.asarray(v.astype(jnp.float32)) for k, v in flat.items() if "lora" not in k})
    want = tsf.jax_to_torch_state(base, jax_config)
    state = model.state_dict()
    for key in (k for k in want if "_proj.weight" in k and ("language_model" in k or "gemma_expert" in k)):
        assert state[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(state[key]), want[key], err_msg=key)


def test_sq_norm_matches_jax(quantized_models):
    _, params, _, model = quantized_models
    want = sum(float(jax_quant.sq_norm(v)) for v in flatten_dict(params).values() if jax_quant.is_quant(v))
    got = sum(float(quant.sq_norm(m)) for m in model.modules() if quant.is_quant(m))
    assert abs(got - want) <= 1e-6 * want
    one = next(m for m in model.modules() if quant.is_quant(m))
    exact = float((one.qweight.double() * one.scale.double()[:, None]).square().sum())
    assert abs(float(quant.sq_norm(one)) - exact) <= 1e-6 * exact


def _weight(k, n, seed):
    return (np.random.default_rng(seed).standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)


def _holder(w: np.ndarray) -> tuple[jax_quant.QuantArray, quant.QuantLinear]:
    qa = jax.jit(functools.partial(jax_quant.quantize_einsum_weight, eqn="BD,DF->BF"))(jnp.asarray(w))
    q, s = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(np.asarray(qa.q).T, q.numpy())
    np.testing.assert_array_equal(np.asarray(qa.s), s.numpy())
    return qa, quant.QuantLinear(q, s, torch.float32)


@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmm_forward_and_straight_through_dx_are_bit_equal(dtype, with_add):
    rng = np.random.default_rng(3)
    x, cot, add = (rng.standard_normal(s).astype(np.float32) for s in ((24, 64), (24, 40), (24, 40)))
    qa, ql = _holder(_weight(64, 40, seed=4))

    def loss(xj, addj):
        y = jax_quant.qmm(xj, qa.q, qa.s, addj if with_add else None)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, yj), (dxj, daddj) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x, _JNP[dtype]), jnp.asarray(add, _JNP[dtype])
    )
    xt, addt = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_() for a in (x, add))
    y = quant.qmm(xt, ql, addt if with_add else None)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    assert y.dtype == xt.dtype
    if with_add and dtype == "float32":
        # XLA contracts ``acc·sx·s + add`` into one fused multiply-add on the CPU: one rounding fewer.
        assert np.abs(_bits(y) - np.asarray(yj)).max() <= 2.0**-22 * np.abs(np.asarray(yj)).max()
    else:
        np.testing.assert_array_equal(_bits(y), np.asarray(yj.astype(jnp.float32)))
    np.testing.assert_array_equal(_bits(xt.grad), np.asarray(dxj.astype(jnp.float32)))
    if with_add:
        np.testing.assert_array_equal(_bits(addt.grad), np.asarray(daddj.astype(jnp.float32)))
    assert ql.qweight.grad is None and not ql.qweight.requires_grad  # the frozen codes get no gradient


@pytest.mark.parametrize("with_lora", [False, True])
def test_fused_ffn_forward_and_all_gradients_match_jax(with_lora):
    d, f, r, rows = 32, 96, 4, (2, 9)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((*rows, d)).astype(np.float32)
    cot = rng.standard_normal((*rows, d)).astype(np.float32)
    wg, wu, wd = _weight(d, f, 1), _weight(d, f, 2), _weight(f, d, 3)
    lora = [0.3 * rng.standard_normal(s).astype(np.float32) for s in ((d, r), (r, f), (d, r), (r, f), (f, r), (r, d))]

    gating = jax.jit(functools.partial(jax_quant.quantize_einsum_weight, eqn="BTD,2DF->2BTF"))(jnp.stack([wg, wu]))
    linear = jax.jit(functools.partial(jax_quant.quantize_einsum_weight, eqn="BTF,FD->BTD"))(jnp.asarray(wd))

    def loss(xj, loraj):
        y = jax_quant.apply_fused_ffn(gating, linear, xj, loraj if with_lora else None)
        return jnp.sum(y * cot), y

    (_, yj), (dxj, dloraj) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), tuple(jnp.asarray(p) for p in lora)
    )

    holders = [quant.QuantLinear(*quant.quantize_weight(torch.from_numpy(w.T.copy())), torch.float32) for w in (wg, wu, wd)]
    # JAX quantizes gate | up as one matrix with per-column scales: its column halves are the port's two holders.
    np.testing.assert_array_equal(np.asarray(gating.q), np.concatenate([holders[0].qweight.numpy().T, holders[1].qweight.numpy().T], axis=1))
    xt = torch.from_numpy(x).requires_grad_()
    lt = [torch.from_numpy(p).requires_grad_() for p in lora]
    y = quant.apply_fused_ffn(*holders, xt, lt if with_lora else None)
    (y * torch.from_numpy(cot)).sum().backward()

    def close(got, want, tol, name):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), (name, np.abs(got - want).max(), np.abs(want).max())

    close(_bits(y), yj, 2e-6, "y")
    close(_bits(xt.grad), dxj, 2e-6, "dx")
    for i, (p, want) in enumerate(zip(lt, dloraj, strict=True)):
        if with_lora:
            close(_bits(p.grad), want, 1e-5, f"lora[{i}]")
            assert np.abs(np.asarray(want)).max() > 0
        else:
            assert p.grad is None


def test_fused_ffn_row_chunks_change_nothing_but_the_summation_order(monkeypatch):
    d, f, r = 16, 48, 4
    g = torch.Generator().manual_seed(0)
    holders = [quant.QuantLinear(*quant.quantize_weight(torch.randn(o, i, generator=g) / i**0.5), torch.float32)
               for o, i in ((f, d), (f, d), (d, f))]
    x = torch.randn(37, d, generator=g)
    lora = [0.3 * torch.randn(s, generator=g) for s in ((d, r), (r, f), (d, r), (r, f), (f, r), (r, d))]

    def run():
        xs, ls = x.clone().requires_grad_(), [p.clone().requires_grad_() for p in lora]
        y = quant.apply_fused_ffn(*holders, xs, ls)
        y.square().sum().backward()
        return y.detach(), xs.grad, [p.grad for p in ls]

    y1, dx1, dl1 = run()
    assert len(quant._row_chunks(37, f)) == 1 and len(quant._row_chunks(30976, 16384)) == 4
    monkeypatch.setattr(quant, "_CHUNK_BYTES", 8 * 4 * f)  # 8 rows of f32 [rows, f]
    assert len(quant._row_chunks(37, f)) == 5
    y2, dx2, dl2 = run()
    assert torch.equal(y1, y2) and torch.equal(dx1, dx2)  # rows are independent
    for a, b in zip(dl1, dl2, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_quantize_frozen_tree_skips_trainable_and_unmatched_leaves():
    _, _, _, model = debug_lora_models(seed=1, freeze=False)
    names = [n for n, _ in model.named_parameters()]
    lm = "paligemma_with_expert.paligemma.model.language_model."
    mask = {n: not (n.startswith(lm) and "lora" not in n) for n in names}  # freeze the PaliGemma base only
    del mask[lm + "layers.0.mlp.down_proj.weight"]  # a leaf missing from the mask counts as trainable
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    quant.quantize_frozen_tree(model, mask)
    held = {n for n, m in model.named_modules() if quant.is_quant(m)}
    want = {f"{lm}layers.{i}.{site}" for i in range(4)
            for site in ("self_attn.q_proj", "self_attn.kv_proj", "self_attn.o_proj",
                         "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")} - {lm + "layers.0.mlp.down_proj"}
    assert held == want  # no action-expert weight (trainable), no SigLIP matmul, no norm, no embedder (unmatched)
    after = dict(model.named_parameters())
    gone = {f"{n}.weight" for n in held} | {f"{n[:-7]}{p}_proj.weight" for n in held if n.endswith("kv_proj") for p in "kv"}
    assert set(after) == set(before) - gone
    assert all(torch.equal(after[n], before[n]) for n in after)
    some = model.get_submodule(lm + "layers.1.mlp.up_proj")
    err = (quant.dequantize(some) - before[lm + "layers.1.mlp.up_proj.weight"]).abs()
    assert (err <= 0.5 * some.scale[:, None] * (1 + 1e-6)).all()
    # inference quantization converts every Gemma site of both experts, and nothing else
    _, _, _, served = debug_lora_models(seed=1, freeze=False)
    quant.quantize_inference_tree(served)
    assert sum(quant.is_quant(m) for m in served.modules()) == 2 * 4 * 6
