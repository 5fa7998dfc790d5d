"""Gradients of the port's attention (its plain path, on the CPU) against the JAX package.

Inputs, masks and the output cotangent come from numpy seeds; q is scaled by
head_dim**-0.5 as its callers do. The JAX side is ``jax.vjp`` of the Pallas
kernels in interpret mode (``pltpu.force_tpu_interpret_mode``, both the forward
and the custom-VJP backward), or of ``mha_reference`` where the mask has fully
masked rows, which the TPU kernel handles differently by design (its backward
recomputes exp(BIG_NEG - lse) = 1 there; the port follows the plain softmax).
Tolerance: max abs <= 1e-4 x max |grad| per gradient, f32 (sums in another order).
"""

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import numpy as np
import pytest
import torch

from kai0_tpu.ops import attention as jax_attention
from kai0_tpu.ops import pallas_attention
from kai0_tpu.ops.masks import make_attn_mask as jax_make_attn_mask
from kai0_tpu_torch.ops import attention
from kai0_tpu_torch.ops import flash_attention as fa

TOL = 1e-4


def _torch_grads(fn, arrays, dout, *rest):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    fn(*leaves, *rest).backward(torch.from_numpy(dout))
    return [x.grad.numpy() for x in leaves]


def _jax_grads(fn, arrays, dout):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _assert_close(got, want):
    for name, a, b in zip("qkv", got, want, strict=True):
        assert a.shape == b.shape, name
        scale = np.abs(b).max()
        assert scale > 0, name
        assert np.abs(a - b).max() <= TOL * scale, (name, np.abs(a - b).max(), scale)


def _mqa_inputs(rng, b, t, s):
    q = (rng.standard_normal((b, t, 8, 256)) / 16).astype(np.float32)
    k, v = (rng.standard_normal((b, s, 1, 256)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((b, t, 8, 256)).astype(np.float32)
    return (q, k, v), dout


def test_flash_mha_grads_match_the_pallas_kernel():
    rng = np.random.default_rng(0)
    (q, k, v), dout = _mqa_inputs(rng, 1, 100, 300)
    mask = rng.random((1, 100, 300)) < 0.8
    mask[:, :, 0] = True  # no fully masked row
    with pltpu.force_tpu_interpret_mode():
        want = _jax_grads(lambda q, k, v: pallas_attention.flash_mha(q, k, v, jnp.asarray(mask)), (q, k, v), dout)
    got = _torch_grads(attention.mha, (q, k, v), dout, torch.from_numpy(mask))
    _assert_close(got, want)


def test_flash_mha_grads_with_fully_masked_rows_match_the_reference():
    """Prefix-LM mask with padded tokens (fully masked rows); dO is non-zero on those rows too."""
    rng = np.random.default_rng(1)
    prefix, suffix = 96, 32
    t = prefix + suffix
    input_mask = np.ones((1, t), bool)
    input_mask[:, 80:96] = False
    ar_mask = np.array([False] * prefix + [True] + [False] * (suffix - 1))
    mask = np.array(jax_make_attn_mask(jnp.asarray(input_mask), jnp.asarray(ar_mask)))
    assert (~mask).all(axis=-1).sum() == 16
    (q, k, v), dout = _mqa_inputs(rng, 1, t, t)
    want = _jax_grads(lambda q, k, v: jax_attention.mha_reference(q, k, v, jnp.asarray(mask)), (q, k, v), dout)
    got = _torch_grads(attention.mha, (q, k, v), dout, torch.from_numpy(mask))
    _assert_close(got, want)
    # The backward kernel's plain version is autograd of the plain forward: the same numbers.
    plain = fa.flash_mha_bwd_plain(*map(torch.from_numpy, (q, k, v, mask, dout)))
    for a, b in zip(plain, got, strict=True):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("shape", [(1, 16, 256, 72)])
def test_flash_mhsa_grads_match_the_pallas_kernel(shape):
    rng = np.random.default_rng(2)
    q = (rng.standard_normal(shape) / np.sqrt(72)).astype(np.float32)
    k, v, dout = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = _jax_grads(pallas_attention.flash_mhsa, (q, k, v), dout)
    got = _torch_grads(attention.mhsa_dense_hm, (q, k, v), dout)
    _assert_close(got, want)
    plain = fa.flash_mhsa_bwd_plain(*map(torch.from_numpy, (q, k, v, dout)))
    for a, b in zip(plain, got, strict=True):
        np.testing.assert_array_equal(a.numpy(), b)


def test_flash_mhsa_plain_bf16_matches_the_pallas_kernel():
    """bf16 at SigLIP's shape: the plain ``flash_mhsa`` (which the card's tensor-core K2 is held to) against the
    TPU kernel's forward and custom VJP in interpret mode, on the same bf16 inputs and dO.

    Both take f32 logits and softmax, round P to bf16 before P·V and sum in f32; they differ in where the
    backward rounds (the kernel rounds dS, autograd of the plain version rounds dP) and in summation order.
    Tolerance, as the card's bf16 checks: out within 2e-2 max abs and 2e-3 mean abs; each gradient within
    2e-2 x its max |grad|.
    """
    rng = np.random.default_rng(5)
    shape = (1, 16, 256, 72)
    q = (rng.standard_normal(shape) / np.sqrt(72)).astype(np.float32)
    k, v, dout = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want_out, vjp = jax.vjp(pallas_attention.flash_mhsa, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
        want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dout, jnp.bfloat16))]
    leaves = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
    out = attention.mhsa_dense_hm(*leaves)
    out.backward(torch.from_numpy(dout).bfloat16())
    assert out.dtype == torch.bfloat16
    err = np.abs(out.detach().float().numpy() - np.asarray(want_out.astype(jnp.float32)))
    assert err.max() <= 2e-2 and err.mean() <= 2e-3, (err.max(), err.mean())
    for name, x, b in zip("qkv", leaves, want, strict=True):
        assert x.grad.dtype == torch.bfloat16, name
        scale = np.abs(b).max()
        assert scale > 0 and np.abs(x.grad.float().numpy() - b).max() <= 2e-2 * scale, (name, scale)
