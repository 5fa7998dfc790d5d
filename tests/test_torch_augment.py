"""The port's train-time augmentation against ``kai0_tpu.models.augment``, with explicit parameters.

Images come from a numpy seed; the parameters are the ones the JAX package
draws from its keys (``_torch_parity.jax_augment_draws``), handed to the port.
Tolerance: max abs <= 1e-5 on [-1, 1] images (f32 sums in another order).
``augment_image`` is compared with jit disabled: XLA's fusion of the jitted
function moves its own output by up to 8.2e-5 against its eager run on these
inputs, while the port agrees with the eager run to 2.4e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_augment_draws, to_torch
from kai0_tpu.models import augment as jax_augment
from kai0_tpu_torch.models import augment

TOL = 1e-5


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return (rng.random((3, 224, 224, 3)) * 2 - 1).astype(np.float32)


def test_affine_warp_matches(images):
    rng = np.random.default_rng(1)
    offset = (rng.random((3, 2)) * 11.2).astype(np.float32)
    theta = np.deg2rad(rng.uniform(-5, 5, 3)).astype(np.float32)
    want = np.stack([
        np.asarray(jax_augment._affine_warp_single(jnp.asarray(img), jnp.asarray(o), jnp.asarray(t)))
        for img, o, t in zip(images, offset, theta, strict=True)
    ])
    got = augment.affine_warp(*map(torch.from_numpy, (images, offset, theta))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # Corners rotate out of the crop: zero-padded taps, as in JAX.
    assert np.abs(got - images).max() > 0.1


def test_color_jitter_matches(images):
    keys = jax.random.split(jax.random.key(2), 3)
    unit = images / 2 + 0.5
    want = np.stack([np.asarray(jax_augment._color_jitter_single(k, jnp.asarray(img))) for k, img in zip(keys, unit)])
    params = {n: [] for n in ("brightness", "contrast", "saturation")}
    for k in keys:  # the draws inside _color_jitter_single
        kb, kc, ks = jax.random.split(k, 3)
        for name, kk, amount in (("brightness", kb, 0.3), ("contrast", kc, 0.4), ("saturation", ks, 0.5)):
            params[name].append(float(jax.random.uniform(kk, (), minval=1 - amount, maxval=1 + amount)))
    got = augment.color_jitter(torch.from_numpy(unit), *(torch.tensor(params[n]) for n in params)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("crop_and_rotate", [True, False])
def test_augment_image_matches_with_the_jax_draws(images, crop_and_rotate):
    rng = jax.random.key(3)
    with jax.disable_jit():
        want = np.asarray(jax_augment.augment_image(rng, jnp.asarray(images), crop_and_rotate))
    params = to_torch(jax_augment_draws(rng, 3, crop_and_rotate))
    assert ("offset" in params) == crop_and_rotate
    got = augment.augment_image(torch.from_numpy(images), params).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_draws_follow_the_generator_and_their_ranges():
    a = augment.draw_augment_params(torch.Generator().manual_seed(0), 256, True)
    b = augment.draw_augment_params(torch.Generator().manual_seed(0), 256, True)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert set(augment.draw_augment_params(None, 2, False)) == {"brightness", "contrast", "saturation"}
    assert a["offset"].shape == (256, 2) and float(a["offset"].min()) >= 0 and float(a["offset"].max()) <= 224 * 0.05
    assert float(a["theta"].abs().max()) <= np.deg2rad(5.0)
    for name, amount in (("brightness", 0.3), ("contrast", 0.4), ("saturation", 0.5)):
        assert float((a[name] - 1).abs().max()) <= amount
