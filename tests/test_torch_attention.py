"""Plain attention of kai0_tpu_torch against kai0_tpu's Pallas kernels and reference (CPU).

The JAX kernels run in TPU interpret mode, as tests/test_pallas_attention.py runs
them. Real head layout of the Gemma experts (8 query heads of 256, one KV head)
and of SigLIP (16 heads of 72). Tolerances, f32: 1e-4 absolute. Rows whose every
key is masked are compared with ``mha_reference`` only: the TPU kernel pads S to
a multiple of 128 with masked keys, so its fully masked rows average over the
padded length, while the reference and the port average over the real keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kai0_tpu.ops import attention as jax_attention
from kai0_tpu.ops import pallas_attention
from kai0_tpu.ops.masks import make_attn_mask as jax_make_attn_mask
from kai0_tpu_torch.ops import attention as torch_attention
from kai0_tpu_torch.ops import flash_attention as fa


def _prefix_lm_mask(rng, t: int, s: int) -> np.ndarray:
    """bool[1, t, s]: the last t of s tokens query a prefix-LM sequence with padded tokens."""
    input_mask = np.ones((1, s), bool)
    input_mask[0, rng.choice(s - t // 2, size=max(2, s // 10), replace=False)] = False  # padded prompt / camera
    ar = np.zeros(s, bool)
    ar[s - t // 2] = True  # a causal block at the end
    full = np.array(jax_make_attn_mask(jnp.asarray(input_mask), jnp.asarray(ar)))
    return full[:, s - t :, :]


def _qkv(rng, b, t, s, n, h):
    q = (rng.standard_normal((b, t, n, h)) / np.sqrt(h)).astype(np.float32)
    k = rng.standard_normal((b, s, 1, h)).astype(np.float32)
    v = rng.standard_normal((b, s, 1, h)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("t,s", [(50, 1018), (200, 200)])
def test_flash_mha_plain_matches_jax(t, s):
    rng = np.random.default_rng(t + s)
    q, k, v = _qkv(rng, 1, t, s, 8, 256)
    mask = _prefix_lm_mask(rng, t, s)
    dead = ~mask.any(axis=-1)[0]  # fully masked query rows
    if t == s:
        assert dead.any(), "the (T,S)=(200,200) case must exercise fully masked rows"

    out = fa.flash_mha_plain(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(pallas_attention.flash_mha(*map(jnp.asarray, (q, k, v, mask))))
    reference = np.asarray(jax_attention.mha_reference(*map(jnp.asarray, (q, k, v, mask))))

    np.testing.assert_allclose(out[:, ~dead], kernel[:, ~dead], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out, reference, rtol=0, atol=1e-4)
    if dead.any():  # uniform average of V over the real keys
        np.testing.assert_allclose(out[0, dead], np.broadcast_to(v.mean(axis=1)[0], out[0, dead].shape), atol=1e-5)


def test_flash_mha_plain_4d_mask_and_dispatch():
    """[B,1,T,S] masks (as gemma passes them) and the mha dispatcher give the same result on CPU."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 2, 20, 40, 8, 16))
    mask = torch.from_numpy(rng.random((2, 20, 40)) < 0.7)
    fa.reset_launches()
    ref = fa.flash_mha_plain(q, k, v, mask)
    torch.testing.assert_close(torch_attention.mha(q, k, v, mask[:, None]), ref, rtol=0, atol=0)
    torch.testing.assert_close(torch_attention.mha_reference(q, k, v, mask), ref, rtol=0, atol=0)
    assert set(fa.LAUNCHES.values()) == {0}  # CPU tensors never reach a kernel, forward or backward


def test_flash_mha_plain_bf16_matches_jax_reference():
    """bf16: the same rounding points (f32 logits, probabilities cast before P·V)."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 1, 50, 300, 8, 256)
    mask = _prefix_lm_mask(rng, 50, 300)
    out = fa.flash_mha_plain(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), torch.from_numpy(mask))
    ref = jax_attention.mha_reference(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(mask))
    assert out.dtype == torch.bfloat16
    # Equal up to bf16 rounding of the output and of P (summation order differs).
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=2e-2)


def test_flash_mhsa_plain_matches_jax():
    rng = np.random.default_rng(3)
    q = (rng.standard_normal((1, 16, 256, 72)) / np.sqrt(72)).astype(np.float32)
    k, v = (rng.standard_normal((1, 16, 256, 72)).astype(np.float32) for _ in range(2))
    out = fa.flash_mhsa_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(pallas_attention.flash_mhsa(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(out, kernel, rtol=0, atol=1e-4)
    torch.testing.assert_close(
        torch_attention.mhsa_dense_hm(*map(torch.from_numpy, (q, k, v))), torch.from_numpy(out), rtol=0, atol=0
    )
