"""``row_quant_plain`` of the port against the JAX package's row quantization.

The same numpy inputs go through ``kai0_tpu.ops.quant._row_quant`` (the XLA
spelling, jitted as every caller runs it), ``kai0_tpu.ops.pallas_rowquant.row_quant``
(the TPU kernel, in interpret mode) and the port's ``row_quant`` on CPU tensors
(its plain version): codes and scales are held bit-equal, in bf16 and f32, with
a row of zeros and with K not a multiple of 128. Under jit XLA compiles the
scale's ``/ 127.0`` to a multiplication by the f32 reciprocal; the eager
``_row_quant`` divides and is one unit in the last place off on some rows, so
it is held to 2 ulps of the scale only.
"""

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from kai0_tpu.ops import pallas_rowquant
from kai0_tpu.ops import quant as jax_quant
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
