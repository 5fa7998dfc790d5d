"""SwitchBack in ``kai0_tpu_torch.ops.quant`` against ``kai0_tpu.ops.quant`` on the CPU: int8 products over
weights that train.

The same numpy-seeded inputs go through JAX's jitted ``switchback_einsum`` /
``sb_fused_ffn`` (knobs set by ``monkeypatch.setenv``) and the port's
``switchback_linear`` / ``switchback_joint`` / ``sb_fused_ffn``, the port's K5
and K4b standing in as their plain versions. Tolerances:

- one product at every Gemma and SigLIP site (``SB_EQN_CASES`` and
  ``SB_GEMMA_EQN_CASES`` of ``tests/test_quant.py``), bf16: the forward and
  the straight-through ``dx`` bit-equal (every int8 operation is exact or one
  fixed sequence of f32 operations, as ``qmm`` in ``test_torch_quant.py``);
  dW, a product of bf16 operands summed in f32 and rounded once to bf16,
  within the f32 summation order: each element within one bf16 step (2^-8
  relative, the spacing of its binade) of JAX's, and at most 2% of the
  elements differing (bit-equal at these shapes);
- the fused SwitchBack FFN, chunked and not, f32 (as the frozen fused FFN in
  ``test_torch_quant.py``: XLA and torch round the f32 gelu differently in
  the last place): forward and ``dx`` within 2e-6 x max, the three weight
  gradients within 1e-5 x max;
- a debug-size π₀.₅ ``compute_loss`` with every Gemma and SigLIP product by
  SwitchBack (``int8_sb_gemma=all``, ``int8_switchback=all``), f32: through a
  whole model the packages' activations differ by f32 rounding, so an
  activation code flips now and then (``test_torch_lora_train.py``'s
  account); the int8 bar of ROADMAP Queue 3: the per-token loss within 1.9e-4
  x max(1, |loss|), every parameter gradient within 8.9e-3 x max(its max abs,
  1e-5). Measured: 2.4e-5 (of losses up to 3.8) and 5.4e-3 x max; SwitchBack
  itself moves JAX's loss by 1.2e-4 and its gradients by 3.8e-2 x max.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_loss_draws, model_inputs, numpy_params, to_torch
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import model as jax_model
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.ops import quant as jax_quant
from kai0_tpu_torch import interop
from kai0_tpu_torch.models import model as torch_model
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.ops import quant

BF16_STEP = 2.0**-8  # a bf16 step, relative to the value's binade


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _assert_wgrad_close(got: np.ndarray, want: np.ndarray, name: str):
    """Two roundings to bf16 of f32 sums in different orders: one bf16 step at most, and on few elements."""
    diff = np.abs(got - want)
    assert (diff <= BF16_STEP * np.abs(want) + 1e-30).all(), (name, diff.max())
    assert (diff > 0).mean() <= 0.02, (name, (diff > 0).mean())


# (eqn, x shape, w shape): the port's product takes x as [..., in] and the weight as [out, in]; ``to_port`` maps
# JAX's operands to the port's and ``from_port`` the port's output (and its dx) back to JAX's layout.
def _rows(w, n_contracted):  # JAX's weight with contracted leading axes -> [out, in]
    k = int(np.prod(w.shape[:n_contracted]))
    return w.reshape(k, -1).T


def _stacked(w):  # [S, K, D, H] (stacked qkv / kv) -> [S·K·H, D]: each slice's rows, then the next slice's
    return np.concatenate([wi.transpose(0, 2, 1).reshape(-1, wi.shape[1]) for wi in w])


SITES = {
    # SigLIP (kai0_tpu/models/siglip.py)
    "btd,dnh->bnth": ((2, 7, 32), (32, 4, 8), lambda x: x, lambda w: _rows(w, 1),
                      lambda y, w: y.reshape(2, 7, 4, 8).transpose(0, 2, 1, 3), 1),
    "bnth,nhd->btd": ((2, 4, 7, 8), (4, 8, 32), lambda x: x.transpose(0, 2, 1, 3).reshape(2, 7, 32),
                      lambda w: _rows(w, 2), lambda y, w: y, 1),
    "btd,df->btf": ((2, 7, 32), (32, 64), lambda x: x, lambda w: w.T, lambda y, w: y, 1),
    "btf,fd->btd": ((2, 7, 64), (64, 32), lambda x: x, lambda w: w.T, lambda y, w: y, 1),
    "btd,dc->btc": ((2, 7, 32), (32, 16), lambda x: x, lambda w: w.T, lambda y, w: y, 1),
    # Gemma (kai0_tpu/models/gemma.py through lora.apply_einsum / apply_ffn)
    "BSD,3KDH->3BSKH": ((2, 7, 32), (3, 4, 32, 8), lambda x: x, _stacked,
                        lambda y, w: y.reshape(2, 7, 3, 4, 8).transpose(2, 0, 1, 3, 4), 3),
    "BTD,NDH->BTNH": ((2, 7, 32), (4, 32, 8), lambda x: x, lambda w: w.transpose(0, 2, 1).reshape(-1, 32),
                      lambda y, w: y.reshape(2, 7, 4, 8), 1),
    "BSD,2KDH->2BSKH": ((2, 7, 32), (2, 1, 32, 8), lambda x: x, _stacked,
                        lambda y, w: y.reshape(2, 7, 2, 1, 8).transpose(2, 0, 1, 3, 4), 2),
    "BTNH,NHD->BTD": ((2, 7, 4, 8), (4, 8, 32), lambda x: x.reshape(2, 7, 32), lambda w: _rows(w, 2),
                      lambda y, w: y, 1),
    "BTD,DF->BTF": ((2, 7, 32), (32, 64), lambda x: x, lambda w: w.T, lambda y, w: y, 1),
}


def _port_switchback(x: torch.Tensor, w: torch.Tensor, joint: int) -> torch.Tensor:
    """The port's route for the site: one layer, or ``joint`` layers' weights through one product (kv, qkv)."""
    if joint == 1:
        return quant.switchback_linear(x, w)
    return quant.switchback_joint(x, [types.SimpleNamespace(weight=part, weight_only=False) for part in w.chunk(joint)])


def _site_case(eqn: str, seed: int, zero_weight: bool = False):
    x_shape, w_shape, x_to, w_to, y_from, joint = SITES[eqn]
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal(x_shape).astype(np.float32))
    w = np.zeros(w_shape, np.float32) if zero_weight else _bf16(rng.standard_normal(w_shape).astype(np.float32))
    y_shape = jax.eval_shape(lambda a, b: jnp.einsum(eqn, a, b), jnp.zeros(x_shape), jnp.zeros(w_shape)).shape
    cot = _bf16(rng.standard_normal(y_shape).astype(np.float32))

    def loss(xj, wj):
        y = jax_quant.switchback_einsum(eqn, xj, wj)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, yj), (dxj, dwj) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))

    # The port: grads of the same loss, through its layout (the JAX cotangent moved into the port's output layout).
    xt = torch.from_numpy(np.ascontiguousarray(x_to(x))).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w_to(w))).to(torch.bfloat16).requires_grad_()
    y = _port_switchback(xt, wt, joint)
    # The same loss: JAX's cotangent moved into the port's output layout.
    (y.float() * torch.from_numpy(_adjoint(y_from, w, tuple(y.shape), cot))).sum().backward()
    return {
        "y": (y_from(_bits(y), w), np.asarray(yj.astype(jnp.float32))),
        "dx": (_bits(xt.grad), np.asarray(x_to(np.asarray(dxj.astype(jnp.float32))))),
        "dw": (_bits(wt.grad), np.asarray(w_to(np.asarray(dwj.astype(jnp.float32))))),
    }


def _adjoint(y_from, w, port_shape, cot):
    """The cotangent ``cot`` (JAX's output layout) carried back to the port's layout: ``y_from`` is a permutation
    of the elements, so its adjoint is the inverse permutation."""
    index = np.arange(int(np.prod(port_shape)), dtype=np.float64).reshape(port_shape)
    moved = y_from(index, w).astype(np.int64).ravel()
    out = np.empty(int(np.prod(port_shape)), np.float32)
    out[moved] = cot.ravel()
    return out.reshape(port_shape)


@pytest.mark.parametrize("eqn", list(SITES))
def test_every_site_forward_and_dx_bit_equal_and_dw_within_summation_order(eqn):
    got = _site_case(eqn, seed=len(eqn))
    for name in ("y", "dx"):
        np.testing.assert_array_equal(got[name][0], got[name][1], err_msg=f"{eqn} {name}")
    _assert_wgrad_close(*got["dw"], f"{eqn} dw")
    assert np.abs(got["dw"][1]).max() > 0


def test_zero_weight_gives_zero_output_finite_dx_and_the_plain_wgrad():
    """SigLIP's head starts at zero: the scale's clamp keeps the codes finite; dW is the bf16 product, as JAX's."""
    got = _site_case("btd,dc->btc", seed=19, zero_weight=True)
    assert not got["y"][0].any() and not got["y"][1].any()
    np.testing.assert_array_equal(*got["dx"])
    assert np.isfinite(got["dx"][0]).all() and not got["dx"][0].any()
    _assert_wgrad_close(*got["dw"], "dw")
    assert np.abs(got["dw"][0]).max() > 0


def _weight(rows, cols, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal((rows, cols))).astype(np.float32)


@pytest.mark.parametrize("chunked", [False, True])
def test_fused_switchback_ffn_matches_jax(monkeypatch, chunked):
    """``sb_fused_ffn`` of both packages, f32, the port's row chunks (even spans) against JAX's (a divisor)."""
    rows, d, f = (96, 32, 80) if not chunked else (240, 32, 64)
    rng = np.random.default_rng(31 + chunked)
    x = rng.standard_normal((2, rows // 2, d)).astype(np.float32)
    cot = rng.standard_normal((2, rows // 2, d)).astype(np.float32)
    wg, wu, wd = _weight(d, f, 1), _weight(d, f, 2), _weight(f, d, 3)  # JAX's layouts: [D, F], [D, F], [F, D]
    if chunked:
        monkeypatch.setattr(jax_quant, "_CHUNK_BYTES", 4 * f * rows // 4)  # 4 chunks of 60 rows
        monkeypatch.setattr(quant, "_CHUNK_BYTES", 4 * f * 50)  # 5 spans of 48 rows
        assert jax_quant._row_chunks(rows, f) == 4 and len(quant._row_chunks(rows, f)) == 5
    else:
        assert jax_quant._row_chunks(rows, f) == 1 and len(quant._row_chunks(rows, f)) == 1

    def loss(*args):
        y = jax_quant.sb_fused_ffn(*args)
        return jnp.sum(y * cot), y

    (_, yj), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(a) for a in (x, wg, wu, wd)))
    xt = torch.from_numpy(x).requires_grad_()
    ws = [torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_() for w in (wg, wu, wd)]
    y = quant.sb_fused_ffn(xt, *ws)
    (y * torch.from_numpy(cot)).sum().backward()

    def close(got, want, tol, name):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), (name, np.abs(got - want).max(), np.abs(want).max())

    close(_bits(y), yj, 2e-6, "y")
    close(_bits(xt.grad), grads[0], 2e-6, "dx")
    for name, w, g in zip(("gate", "up", "down"), ws, grads[1:], strict=True):
        close(_bits(w.grad), np.asarray(g).T, 1e-5, f"d{name}")
    # The fused op is the split one, fused: the per-product SwitchBack path gives the same forward and dx.
    split = quant.switchback_linear(
        torch.nn.functional.gelu(quant.switchback_linear(xt, ws[0]), approximate="tanh") * quant.switchback_linear(xt, ws[1]),
        ws[2])
    np.testing.assert_array_equal(_bits(split), _bits(y))


@pytest.fixture(scope="module")
def switchback_models():
    config_kwargs = dict(paligemma_variant="dummy", action_expert_variant="dummy", vision_variant="mu/14",
                         dtype="float32", pi05=True)
    jax_config = jax_pi0.Pi0Config(**config_kwargs)
    params = numpy_params(jax_config, seed=7)
    model = torch_pi0.Pi0(torch_pi0.Pi0Config(**config_kwargs), device="cpu")
    interop.load_jax_state(model, tsf.jax_to_torch_state(params, jax_config))
    return jax_config, params, model


def test_compute_loss_with_every_product_switchback_tracks_jax(monkeypatch, switchback_models):
    jax_config, params, model = switchback_models
    batch = 2
    inputs = model_inputs(4, batch=batch)
    actions = np.random.default_rng(5).standard_normal((batch, 50, 32)).astype(np.float32)
    rng = jax.random.key(3)
    monkeypatch.setenv("KAI0_INT8_SB_GEMMA", "all")
    monkeypatch.setenv("KAI0_INT8_SB", "all")
    obs = jax_model.Observation.from_dict(inputs)

    def chunked_loss(p):
        return jax_pi0.compute_loss(p, jax_config, rng, obs, jnp.asarray(actions), train=False)

    want, grads = jax.jit(lambda p: (chunked_loss(p), jax.grad(lambda q: jnp.mean(chunked_loss(q)))(p)))(params)
    want = np.asarray(want)
    want_grads = tsf.jax_to_torch_state(grads, jax_config)

    names = [n for n, _ in model.named_parameters()]
    quant.switchback_tree(model, gemma="all", siglip="all")
    assert [n for n, _ in model.named_parameters()] == names  # the swap keeps every parameter and its name
    assert sum(quant.is_switchback(m) for m in model.modules()) == 2 * 4 * 7 + 6 + 1
    draws = jax_loss_draws(rng, batch, actions.shape)
    model.zero_grad(set_to_none=True)
    got = model.compute_loss(torch_model.Observation.from_dict(to_torch(inputs)), torch.from_numpy(actions),
                             train=False, noise=draws["noise"], time=draws["time"])
    got.mean().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1.9e-4 * max(1.0, np.abs(want).max()))
    for name, p in model.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        ref = np.asarray(want_grads[name], np.float32)
        assert np.abs(g - ref).max() <= 8.9e-3 * max(np.abs(ref).max(), 1e-5), (name, np.abs(g - ref).max())
