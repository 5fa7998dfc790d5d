"""The π₀.₅ serving slice of kai0_tpu_torch against kai0_tpu, at debug size (CPU, f32).

Same weights (zero-initialised leaves perturbed, so gates are open and image
tokens reach the actions) and the same seeded inputs, with one camera masked
and a padded prompt. Tolerances: the stages agree to 1e-4 (f32 sums taken in
another order); sampled actions to 1e-3, the action-fidelity bar of
BASELINE.md.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import debug_models, model_inputs, to_torch
from kai0_tpu.models import model as jax_model
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu_torch.models import model as torch_model


@pytest.fixture(scope="module")
def setup():
    jax_config, params, torch_config, model = debug_models(seed=0)
    inputs = model_inputs(1)
    jax_obs = jax_model.preprocess_observation(None, jax_model.Observation.from_dict(inputs))
    torch_obs = torch_model.preprocess_observation(torch_model.Observation.from_dict(to_torch(inputs)))
    return jax_config, params, model, jax_obs, torch_obs


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


def test_embed_prefix(setup):
    jax_config, params, model, jax_obs, torch_obs = setup
    tokens, mask, ar = jax_pi0.embed_prefix(params, jax_config, jax_obs)
    with torch.no_grad():
        t_tokens, t_mask, t_ar = model.embed_prefix(torch_obs)
    assert tokens.shape == t_tokens.shape == (1, 3 * 256 + 48, 64)
    np.testing.assert_array_equal(np.asarray(mask), t_mask.numpy())
    np.testing.assert_array_equal(np.asarray(ar), t_ar.numpy())
    np.testing.assert_allclose(_np(t_tokens), np.asarray(tokens), rtol=1e-4, atol=1e-4)
    # The masked camera's tokens are real values, masked only in attention.
    assert np.abs(_np(t_tokens)[0, 512:768]).max() > 0.1


def test_prefix_kv_cache(setup):
    jax_config, params, model, jax_obs, torch_obs = setup
    (k, v), prefix_mask = jax_pi0.compute_prefix_kv_cache(params, jax_config, jax_obs)
    with torch.no_grad():
        cache, t_mask = model.compute_prefix_kv_cache(torch_obs)
    assert len(cache) == k.shape[0]
    valid = np.asarray(prefix_mask)[0]
    for layer, (tk, tv) in enumerate(cache):
        # Rows of padded tokens are not meaningful in either package (never attended to).
        np.testing.assert_allclose(_np(tk)[0, valid], np.asarray(k[layer])[0, valid], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(tv)[0, valid], np.asarray(v[layer])[0, valid], rtol=1e-4, atol=1e-4)


def test_compute_velocity(setup):
    jax_config, params, model, jax_obs, torch_obs = setup
    x_t = np.random.default_rng(2).standard_normal((1, 50, 32)).astype(np.float32)
    kv, prefix_mask = jax_pi0.compute_prefix_kv_cache(params, jax_config, jax_obs)
    v_jax = jax_pi0.compute_velocity(params, jax_config, jax_obs, kv, prefix_mask, jnp.asarray(x_t), 0.7)
    with torch.no_grad():
        cache, t_mask = model.compute_prefix_kv_cache(torch_obs)
        v_torch = model.compute_velocity(torch_obs, cache, t_mask, torch.from_numpy(x_t), torch.tensor(0.7))
    np.testing.assert_allclose(v_torch.numpy(), np.asarray(v_jax), rtol=1e-4, atol=1e-4)


def test_sample_actions(setup):
    jax_config, params, model, _, _ = setup
    inputs = model_inputs(1)
    noise = np.random.default_rng(3).standard_normal((1, 50, 32)).astype(np.float32)
    actions_jax = jax_pi0.sample_actions(
        params, jax_config, None, jax_model.Observation.from_dict(inputs), noise=jnp.asarray(noise)
    )
    actions = model.sample_actions(torch_model.Observation.from_dict(to_torch(inputs)), noise=torch.from_numpy(noise))
    assert actions.shape == (1, 50, 32) and actions.dtype == torch.float32
    np.testing.assert_allclose(actions.numpy(), np.asarray(actions_jax), rtol=0, atol=1e-3)
    # Not vacuous: the sampled chunk moved away from the noise.
    assert np.abs(actions.numpy() - noise).max() > 0.1


def test_images_reach_the_actions(setup):
    """With the zero-init leaves perturbed, changing an unmasked camera changes the actions."""
    _, _, model, _, _ = setup
    inputs = model_inputs(1)
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 50, 32)).astype(np.float32))
    base = model.sample_actions(torch_model.Observation.from_dict(to_torch(inputs)), noise=noise)
    inputs["image"]["base_0_rgb"] = 255 - inputs["image"]["base_0_rgb"]
    other = model.sample_actions(torch_model.Observation.from_dict(to_torch(inputs)), noise=noise)
    assert (base - other).abs().max() > 1e-4


def test_sample_actions_default_noise_uses_generator(setup):
    _, _, model, _, _ = setup
    obs = torch_model.Observation.from_dict(to_torch(model_inputs(4)))
    a = model.sample_actions(obs, generator=torch.Generator().manual_seed(7))
    b = model.sample_actions(obs, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all()


@pytest.mark.parametrize("shape", [(200, 224), (480, 640), (120, 160)])
def test_preprocess_resizes_other_resolutions(shape):
    """A camera that is not 224×224 is resized with padding as JAX's ``preprocess_observation`` does
    (``jax.image.resize``, antialiased when it downsamples; within 1e-4), the others pass unchanged."""
    inputs = model_inputs(5)
    inputs["image"]["base_0_rgb"] = np.random.default_rng(5).integers(0, 256, (1, *shape, 3), dtype=np.uint8)
    jax_obs = jax_model.preprocess_observation(None, jax_model.Observation.from_dict(inputs))
    obs = torch_model.preprocess_observation(torch_model.Observation.from_dict(to_torch(inputs)))
    for key, image in obs.images.items():
        assert tuple(image.shape) == (1, 224, 224, 3)
        np.testing.assert_allclose(image.numpy(), np.asarray(jax_obs.images[key]), rtol=0, atol=1e-4)


def test_preprocess_default_fills_image_masks():
    inputs = to_torch(model_inputs(5))
    del inputs["image_mask"]["left_wrist_0_rgb"]
    obs = torch_model.preprocess_observation(torch_model.Observation.from_dict(inputs))
    assert obs.image_masks["left_wrist_0_rgb"].dtype == torch.bool
    assert obs.image_masks["left_wrist_0_rgb"].tolist() == [True]
    assert obs.image_masks["right_wrist_0_rgb"].tolist() == [False]
