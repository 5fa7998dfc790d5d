"""The plain int8 products of the port against ``kai0_tpu.ops.pallas_quant`` in interpret mode.

The same numpy operands go through the TPU kernels (``int8_matmul``,
``int8_matmul_lora``, under ``pltpu.force_tpu_interpret_mode()``) and the
port's wrappers on CPU tensors (their plain versions). K4b is held bit-equal:
both orientations, with and without column scales, bf16 and f32 outputs, sizes
off every tile. K4a sums its rank-r term in another order, so the bf16
rounding of that term can flip by one unit in its last place: at most 1e-3 of
the outputs differ, each within ``rtol=2**-7, atol=1e-6`` (the JAX package's
own criterion, ``tests/test_quant.py`` ``_assert_bf16_ulp_close``).

Orientation: the JAX kernel's ``nt=False`` takes ``w [K, N]`` and ``nt=True``
``w [N, K]``; the port's K4b wrapper takes the same flag with the same meaning,
and the port's models call the ``nt`` form with the weight as stored. The
port's K4a takes the stored weight ``[N, K]`` only, the JAX kernel ``[K, N]``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kai0_tpu.ops import pallas_quant
from kai0_tpu_torch.ops import int8_matmul as mm

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = (rng.random((m, 1), dtype=np.float32) * 0.1).astype(np.float32)
    sn = (rng.random(n, dtype=np.float32) * 0.01).astype(np.float32)
    return xq, w, sx, sn


def _f32(x) -> np.ndarray:
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jnp.ndarray) else x.to(torch.float32).numpy()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("nt", [False, True])
@pytest.mark.parametrize("m,k,n", [(96, 256, 128), (50, 300, 72)])
def test_int8_matmul_plain_is_bit_equal_to_the_tpu_kernel(m, k, n, nt, scaled, out_dtype):
    xq, w, sx, sn = _operands(m, k, n, seed=m + k + n)
    w = np.ascontiguousarray(w.T) if nt else w
    sn = sn if scaled else None
    with pltpu.force_tpu_interpret_mode():
        want = pallas_quant.int8_matmul(
            jnp.asarray(xq), jnp.asarray(w), jnp.asarray(sx), None if sn is None else jnp.asarray(sn),
            nt=nt, out_dtype=_JNP[out_dtype],
        )
    before = dict(mm.LAUNCHES)
    got = mm.int8_matmul(
        torch.from_numpy(xq), torch.from_numpy(w), torch.from_numpy(sx), None if sn is None else torch.from_numpy(sn),
        nt=nt, out_dtype=out_dtype,
    )
    assert mm.LAUNCHES == before  # CPU tensors take the plain version
    assert got.dtype == out_dtype and got.shape == (m, n)
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_plain_product_is_exact_where_f32_accumulation_is_not():
    """K = 16384 at full code magnitude: the sum exceeds 2^24, which an f32 accumulator cannot hold."""
    xq = torch.full((2, 16384), 127, dtype=torch.int8)
    w = torch.full((3, 16384), 127, dtype=torch.int8)
    w[1, ::2] = -127
    w[2, 0] = 126
    got = mm.int8_matmul_plain(xq, w, torch.ones(2, 1), None, nt=True, out_dtype=torch.float32)
    want = torch.tensor([16384 * 127 * 127, 0, 16384 * 127 * 127 - 127], dtype=torch.float64).to(torch.float32)
    assert torch.equal(got, want.expand(2, 3))


@pytest.mark.parametrize("m,k,n,r", [(300, 257, 130, 16), (96, 2048, 512, 16), (64, 128, 128, 4), (96, 256, 130, 64)])
def test_int8_matmul_lora_plain_matches_the_tpu_kernel_bf16(m, k, n, r):
    xq, w, sx, sn = _operands(m, k, n, seed=7)
    rng = np.random.default_rng(r)
    u = rng.standard_normal((m, r)).astype(np.float32)
    b = rng.standard_normal((r, n)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_quant.int8_matmul_lora(
            jnp.asarray(xq), jnp.asarray(w), jnp.asarray(sx), jnp.asarray(sn),
            jnp.asarray(u, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), out_dtype=jnp.bfloat16,
        )
    ut, bt = (torch.from_numpy(x).to(torch.bfloat16) for x in (u, b))
    args = (torch.from_numpy(xq), torch.from_numpy(np.ascontiguousarray(w.T)), torch.from_numpy(sx), torch.from_numpy(sn))
    got = mm.int8_matmul_lora(*args, ut, bt)
    g, ref = _f32(got), _f32(want)
    assert (g != ref).mean() <= 1e-3
    np.testing.assert_allclose(g, ref, rtol=2**-7, atol=1e-6)
    assert np.abs(g - _f32(mm.int8_matmul(*args, nt=True))).max() > 0.5  # the rank-r term is there


def test_int8_matmul_lora_plain_f32_has_no_bf16_rounding():
    """With f32 activations the term is ``u @ b`` in f32: the XLA spelling ``base + dot(u, b)`` in x's dtype."""
    xq, w, sx, sn = _operands(40, 128, 64, seed=1)
    rng = np.random.default_rng(2)
    u, b = rng.standard_normal((40, 4)).astype(np.float32), rng.standard_normal((4, 64)).astype(np.float32)
    acc = xq.astype(np.int64) @ w.astype(np.int64)
    want = acc.astype(np.float32) * sx * sn + u @ b
    got = mm.int8_matmul_lora(
        torch.from_numpy(xq), torch.from_numpy(np.ascontiguousarray(w.T)), torch.from_numpy(sx), torch.from_numpy(sn),
        torch.from_numpy(u), torch.from_numpy(b), out_dtype=torch.float32,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_mismatched_operands():
    xq, w, sx, sn = (torch.from_numpy(x) for x in _operands(8, 32, 16, seed=0))
    with pytest.raises(ValueError):
        mm.int8_matmul(xq, w, sx, sn, nt=True)  # w is [K, N]: the trailing axes do not match
    with pytest.raises(ValueError):
        mm.int8_matmul(xq.float(), w, sx, sn)
    with pytest.raises(ValueError):
        mm.int8_matmul_lora(xq, w.T.contiguous(), sx, sn, torch.zeros(8, 4), torch.zeros(4, 16))  # f32 factors, bf16 output
    with pytest.raises(ValueError):
        mm.int8_matmul_lora(xq, w, sx, sn, torch.zeros(8, 4).bfloat16(), torch.zeros(4, 16).bfloat16())  # w is [K, N]
