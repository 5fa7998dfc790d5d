"""kai0_tpu_torch.ops.masks against kai0_tpu.ops.masks (CPU, seeded numpy inputs).

Tolerance 1e-6 absolute: the port computes the same f32 frequency tables as
XLA, so what remains is the last ulp of sin/cos between the two libraries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kai0_tpu.ops import masks as jax_masks
from kai0_tpu_torch.ops import masks as torch_masks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_attn_mask(seed):
    rng = np.random.default_rng(seed)
    input_mask = rng.random((3, 40)) < 0.8
    mask_ar = rng.random(40) < 0.2
    ref = jax_masks.make_attn_mask(jnp.asarray(input_mask), jnp.asarray(mask_ar))
    out = torch_masks.make_attn_mask(torch.from_numpy(input_mask), torch.from_numpy(mask_ar))
    assert out.dtype == torch.bool
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_make_attn_mask_prefix_lm_with_padding():
    """A padded prefix token's row and column are all False (the fully masked rows of serving)."""
    input_mask = np.array([[True, True, False, True, True]])
    mask_ar = [False, False, False, True, False]
    out = torch_masks.make_attn_mask(torch.from_numpy(input_mask), mask_ar).numpy()[0]
    np.testing.assert_array_equal(out, np.asarray(jax_masks.make_attn_mask(jnp.asarray(input_mask), jnp.asarray(mask_ar)))[0])
    assert not out[2].any() and not out[:, 2].any()
    assert out[3, 0] and not out[0, 3]


@pytest.mark.parametrize("dim", [64, 1024])
def test_posemb_sincos(dim):
    pos = np.random.default_rng(dim).random(16).astype(np.float32)
    pos[:3] = [0.0, 1.0, 0.9]
    ref = jax_masks.posemb_sincos(jnp.asarray(pos), dim, min_period=4e-3, max_period=4.0)
    out = torch_masks.posemb_sincos(torch.from_numpy(pos), dim, min_period=4e-3, max_period=4.0)
    assert out.dtype == torch.float32 and out.shape == (16, dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("head_dim,dtype", [(256, np.float32), (16, np.float32), (256, "bfloat16")])
def test_apply_rope(head_dim, dtype):
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 30, 4, head_dim)).astype(np.float32)
    positions = np.cumsum(rng.integers(0, 70, (2, 30)), axis=1).astype(np.int32)  # up to ~1000
    if dtype == "bfloat16":
        ref = jax_masks.apply_rope(jnp.asarray(x, jnp.bfloat16), positions=jnp.asarray(positions))
        out = torch_masks.apply_rope(torch.from_numpy(x).bfloat16(), positions=torch.from_numpy(positions))
        assert out.dtype == torch.bfloat16
        # Same f32 math, one bf16 rounding of the result: equal up to that rounding.
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=2**-8, atol=1e-6)
    else:
        ref = jax_masks.apply_rope(jnp.asarray(x), positions=jnp.asarray(positions))
        out = torch_masks.apply_rope(torch.from_numpy(x), positions=torch.from_numpy(positions))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
