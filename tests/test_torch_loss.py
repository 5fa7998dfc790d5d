"""The port's ``compute_loss`` and its gradients against ``kai0_tpu.models.pi0.compute_loss``.

Debug size (``dummy``/``dummy`` Gemma, ``mu/14`` SigLIP, f32, π₀.₅), batch 2,
train=True: augmentation on, the right wrist camera masked, a padded prompt.
The JAX package draws its noise, time and augmentation from its key; the same
draws (made with the splits of ``pi0.py:271-276``, ``model.py:138`` and
``augment.py:94-110``) are handed to the port. JAX augments with jit disabled
and runs the rest of the loss jitted (``_torch_parity.jax_augmented_observation``:
its jitted warp moves the images by up to 3.2e-5, which moves the loss by
6.6e-4). Tolerances: the per-(batch, step) loss within 1e-5 x max(1, max
|loss|); every parameter gradient (JAX's mapped through ``jax_to_torch_state``)
within 1e-4 x max(its max abs, 1e-5) (f32 sums in another order; the floor
covers tensors whose gradient is zero up to rounding, such as SigLIP's key
bias, which softmax cancels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import debug_models, jax_augmented_observation, jax_loss_draws, model_inputs, to_torch
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu_torch.models import model as torch_model

BATCH = 2


@pytest.fixture(scope="module")
def setup():
    jax_config, params, torch_config, model = debug_models(seed=0)
    inputs = model_inputs(1, batch=BATCH)
    actions = np.random.default_rng(2).standard_normal((BATCH, 50, 32)).astype(np.float32)
    rng = jax.random.key(5)
    augmented = jax_augmented_observation(rng, inputs)

    def chunked_loss(p):
        return jax_pi0.compute_loss(p, jax_config, rng, augmented, jnp.asarray(actions), train=False)

    chunked, grads = jax.jit(lambda p: (chunked_loss(p), jax.grad(lambda q: jnp.mean(chunked_loss(q)))(p)))(params)
    draws = jax_loss_draws(rng, BATCH, actions.shape)
    return model, inputs, actions, draws, np.asarray(chunked), tsf.jax_to_torch_state(grads, jax_config)


@pytest.fixture(scope="module")
def port(setup):
    """The port's per-(batch, step) loss and parameter gradients with recompute on (the default)."""
    model, inputs, actions, draws, _, _ = setup
    return _torch_loss_and_grads(model, inputs, actions, draws)


def _torch_loss_and_grads(model, inputs, actions, draws, *, remat: bool = True):
    model.zero_grad(set_to_none=True)
    obs = torch_model.Observation.from_dict(to_torch(inputs))
    chunked = model.compute_loss(obs, torch.from_numpy(actions), train=True, remat=remat, **draws)
    chunked.mean().backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy() for k, p in model.named_parameters()}
    return chunked.detach().numpy(), grads


def test_compute_loss_matches(setup, port):
    model, inputs, actions, draws, want, _ = setup
    got, _ = port
    assert got.shape == want.shape == (BATCH, 50) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    # The augmentation matters: without it the loss is another number.
    no_aug = model.compute_loss(
        torch_model.Observation.from_dict(to_torch(inputs)), torch.from_numpy(actions), train=False,
        noise=draws["noise"], time=draws["time"],
    )
    assert np.abs(no_aug.detach().numpy() - want).max() > 1e-4


def test_every_parameter_gradient_matches(setup, port):
    want = setup[-1]
    _, got = port
    assert set(got) == set(want)
    unreached = set()
    for key, g in got.items():
        ref = np.asarray(want[key], dtype=np.float32)
        scale = np.abs(ref).max()
        assert g.shape == ref.shape, key
        assert np.abs(g - ref).max() <= 1e-4 * max(scale, 1e-5), (key, np.abs(g - ref).max(), scale)
        if scale <= 1e-5:
            unreached.add(key)
    # What the loss cannot reach: the prefix expert's last layer past its K/V and its final norm (only
    # suffix outputs enter the loss), and SigLIP's key bias (softmax cancels it).
    last = "paligemma_with_expert.paligemma.model.language_model.layers.3."
    assert unreached == {
        *(last + name + ".weight" for name in (
            "mlp.down_proj", "mlp.gate_proj", "mlp.up_proj", "post_attention_layernorm", "self_attn.o_proj",
            "self_attn.q_proj")),
        "paligemma_with_expert.paligemma.model.language_model.norm.weight",
        "paligemma_with_expert.paligemma.model.vision_tower.vision_model.encoder.layers.0.self_attn.k_proj.bias",
    }


def test_recompute_gives_the_same_gradients(setup, port):
    model, inputs, actions, draws, _, _ = setup
    loss_on, grads_on = port
    loss_off, grads_off = _torch_loss_and_grads(model, inputs, actions, draws, remat=False)
    np.testing.assert_array_equal(loss_on, loss_off)
    for key, g in grads_on.items():
        np.testing.assert_allclose(g, grads_off[key], rtol=0, atol=1e-6 * max(np.abs(g).max(), 1e-30), err_msg=key)


def test_compute_loss_draws_from_the_generator(setup):
    model, inputs, actions, _, _, _ = setup
    obs = torch_model.Observation.from_dict(to_torch(inputs))

    def loss(seed):
        with torch.no_grad():
            return model.compute_loss(obs, torch.from_numpy(actions), train=True,
                                      generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(loss(0), loss(0), rtol=0, atol=0)
    assert (loss(0) - loss(1)).abs().max() > 1e-3
