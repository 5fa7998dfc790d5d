"""``row_quant_plain`` of the port against the JAX package's row quantization.

The same numpy inputs go through ``kai0_tpu.ops.quant._row_quant`` (the XLA
spelling, jitted as every caller runs it), ``kai0_tpu.ops.pallas_rowquant.row_quant``
(the TPU kernel, in interpret mode) and the port's ``row_quant`` on CPU tensors
(its plain version): codes and scales are held bit-equal, in bf16 and f32, with
a row of zeros and with K not a multiple of 128. Under jit XLA compiles the
scale's ``/ 127.0`` to a multiplication by the f32 reciprocal; the eager
``_row_quant`` divides and is one unit in the last place off on some rows, so
it is held to 2 ulps of the scale only.

The column-scale mode (``row_quant(dy, col_scale=s)``, the straight-through
backward's ``q_row(dy · s)``) is held bit-equal to the JAX package's jitted
``_row_quant(dy.astype(f32) * s)`` (``kai0_tpu/ops/quant.py`` ``_bwd_dx``,
``_qbwd_col``), and the port's ``qmm`` and fused-FFN backwards to the ``dx``
they gave when ``_dx`` wrote ``dy.float() * s`` before quantizing it.
"""

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from kai0_tpu.ops import pallas_rowquant
from kai0_tpu.ops import quant as jax_quant
from kai0_tpu_torch.ops import int8_matmul as mm
from kai0_tpu_torch.ops import quant
from kai0_tpu_torch.ops import row_quant as rq


def _input(m, k, dtype, seed):
    x = (np.random.default_rng(seed).standard_normal((m, k)) * 3).astype(np.float32)
    x[1] = 0.0  # a row of zeros: s = 1e-30/127, codes 0
    x[2, 0] = 1e-20  # a row far below every other
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    return xj, xt


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k", [(40, 256), (7, 100), (33, 1027)])
def test_plain_matches_jax_bit_for_bit(dtype, m, k):
    xj, xt = _input(m, k, dtype, seed=m + k)
    before = rq.LAUNCHES["row_quant"]
    xq, sx = rq.row_quant(xt)
    assert rq.LAUNCHES["row_quant"] == before  # a CPU tensor takes the plain version
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32 and sx.shape == (m, 1)
    with pltpu.force_tpu_interpret_mode():
        pallas = pallas_rowquant.row_quant(xj)
    for name, (jq, js) in {"xla": jax.jit(jax_quant._row_quant)(xj), "pallas": pallas}.items():
        np.testing.assert_array_equal(np.asarray(js), sx.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(jq), xq.numpy(), err_msg=name)
    _, eager_s = jax_quant._row_quant(xj)
    np.testing.assert_allclose(np.asarray(eager_s), sx.numpy(), rtol=2 * np.finfo(np.float32).eps, atol=0)
    assert not xq[1].any() and sx[1].item() == np.float32(1e-30) * (np.float32(1.0) / np.float32(127.0))
    assert xq.abs().max().item() == 127


def test_dequantized_rows_are_within_half_a_step():
    _, xt = _input(16, 512, "float32", seed=0)
    xq, sx = rq.row_quant_plain(xt)
    assert ((xq.float() * sx - xt).abs() <= 0.5 * sx * (1 + 1e-6)).all()


def _col_scale(k, seed):
    """Per-column weight scales spanning 1e-5 to 1e-2, log-uniform (the range of ``QuantLinear.scale``)."""
    return (10.0 ** np.random.default_rng(seed).uniform(-5, -2, k)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k", [(40, 256), (7, 100), (33, 1027)])
def test_col_scale_mode_matches_jax_bit_for_bit(dtype, m, k):
    dyj, dyt = _input(m, k, dtype, seed=3 * m + k)
    s = _col_scale(k, seed=k)
    before = dict(rq.LAUNCHES)
    xq, sx = rq.row_quant(dyt, col_scale=torch.from_numpy(s))
    assert rq.LAUNCHES == before  # a CPU tensor takes the plain version
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32 and sx.shape == (m, 1)
    jq, js = jax.jit(lambda dy, s: jax_quant._row_quant(dy.astype(jnp.float32) * s))(dyj, jnp.asarray(s))
    np.testing.assert_array_equal(np.asarray(js), sx.numpy())
    np.testing.assert_array_equal(np.asarray(jq), xq.numpy())
    assert not xq[1].any() and xq.abs().max().item() == 127
    ref_q, ref_s = rq.row_quant_plain(dyt.to(torch.float32) * torch.from_numpy(s))
    assert torch.equal(xq, ref_q) and torch.equal(sx, ref_s)


def _old_dx(ql, dy):
    """``quant._dx`` as it was before the column-scale mode: the f32 ``dy · s`` written, then quantized."""
    gq, sg = rq.row_quant(dy.to(torch.float32) * ql.scale)
    return mm.int8_matmul(gq, ql.qweight, sg, None, nt=False, out_dtype=dy.dtype)


def _holders(shapes, seed):
    g = torch.Generator().manual_seed(seed)
    return [quant.QuantLinear(*quant.quantize_weight(torch.randn(o, i, generator=g) / i**0.5), torch.float32)
            for o, i in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qmm_and_fused_ffn_backwards_give_the_dx_of_the_written_product(monkeypatch, dtype):
    d, f, r = 32, 96, 4
    g = torch.Generator().manual_seed(5)
    (proj,) = _holders([(40, d)], seed=6)
    ffn = _holders([(f, d), (f, d), (d, f)], seed=7)
    x = torch.randn(2, 9, d, generator=g).to(dtype)
    lora = [(0.3 * torch.randn(s, generator=g)).to(dtype) for s in ((d, r), (r, f), (d, r), (r, f), (f, r), (r, d))]

    def grads():
        xs, ls = x.clone().requires_grad_(), [p.clone().requires_grad_() for p in lora]
        y = quant.linear(xs, proj).square().sum() + quant.apply_fused_ffn(*ffn, xs, ls).float().square().sum()
        y.backward()
        return [xs.grad, *(p.grad for p in ls)]

    new = grads()
    monkeypatch.setattr(quant, "_dx", _old_dx)
    old = grads()
    assert new[0].abs().max() > 0
    for a, b in zip(new, old, strict=True):
        assert torch.equal(a, b)
