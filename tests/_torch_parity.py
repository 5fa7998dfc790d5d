"""Shared set-up for the tests that hold kai0_tpu_torch to kai0_tpu.

Weights are drawn by the JAX init, with every all-zero leaf (adaRMS ``Dense_0``,
the SigLIP ``head``, biases, RMSNorm scales) replaced by seeded numpy noise so
that no path of the model is switched off; the same tree then goes to both
packages through ``jax_to_torch_state``. Inputs are numpy arrays from a seed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.transforms import flatten_dict, unflatten_dict
from kai0_tpu_torch import interop as torch_interop
from kai0_tpu_torch.models import pi0 as torch_pi0

DEBUG = dict(paligemma_variant="dummy", action_expert_variant="dummy", vision_variant="mu/14", dtype="float32", pi05=True)


def perturb_zero_leaves(params: dict, seed: int, std: float = 0.05) -> dict:
    rng = np.random.default_rng(seed)
    flat = flatten_dict(params)
    for key, value in flat.items():
        value = np.asarray(value)
        if not value.any():
            flat[key] = (std * rng.standard_normal(value.shape)).astype(value.dtype)
    return unflatten_dict(flat)


def sub_state(state: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def debug_models(seed: int = 0, **overrides):
    """(jax config, jax params, torch config, torch model) at debug size, same weights."""
    jax_config = jax_pi0.Pi0Config(**{**DEBUG, **overrides})
    params = perturb_zero_leaves(jax_config.init_params(jax.random.key(seed)), seed)
    torch_config = torch_pi0.Pi0Config(**{**DEBUG, **overrides})
    model = torch_pi0.Pi0(torch_config, device="cpu")
    torch_interop.load_jax_state(model, tsf.jax_to_torch_state(params, jax_config))
    return jax_config, params, torch_config, model


def model_inputs(seed: int, *, batch: int = 1, prompt_len: int = 48, used: int = 20, action_dim: int = 32) -> dict:
    """The model-facing dict: 224x224 uint8 cameras (right wrist masked), state, padded prompt."""
    rng = np.random.default_rng(seed)
    keys = ("base_0_rgb", "left_wrist_0_rgb", "right_wrist_0_rgb")
    mask = np.zeros((batch, prompt_len), bool)
    mask[:, :used] = True
    return {
        "image": {k: rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8) for k in keys},
        "image_mask": {k: np.full((batch,), k != "right_wrist_0_rgb") for k in keys},
        "state": rng.standard_normal((batch, action_dim)).astype(np.float32),
        "tokenized_prompt": rng.integers(0, 257_152, (batch, prompt_len), dtype=np.int32),
        "tokenized_prompt_mask": mask,
    }


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def jax_augment_draws(rng, batch: int, crop_and_rotate: bool, height: int = 224, width: int = 224) -> dict:
    """The parameters ``kai0_tpu.models.augment.augment_image(rng, ...)`` draws, as numpy [B, ...] arrays."""
    from kai0_tpu.models import augment as jax_augment

    draws = {"brightness": [], "contrast": [], "saturation": [], "offset": [], "theta": []}
    for key in jax.random.split(rng, batch):
        if crop_and_rotate:
            ko, kt = jax.random.split(key)
            max_off = jnp.array([height * (1.0 - jax_augment.CROP_FRACTION), width * (1.0 - jax_augment.CROP_FRACTION)])
            draws["offset"].append(jax.random.uniform(ko, (2,)) * max_off)
            rot = jax_augment.MAX_ROTATION_DEG
            draws["theta"].append(jax.random.uniform(kt, (), minval=-rot, maxval=rot) * (jnp.pi / 180.0))
        kb, kc, ks = jax.random.split(jax.random.fold_in(key, 1), 3)
        for name, k, amount in (("brightness", kb, jax_augment.BRIGHTNESS), ("contrast", kc, jax_augment.CONTRAST),
                                ("saturation", ks, jax_augment.SATURATION)):
            draws[name].append(jax.random.uniform(k, (), minval=1.0 - amount, maxval=1.0 + amount))
    return {k: np.stack([np.asarray(x) for x in v]) for k, v in draws.items() if v}


def jax_loss_draws(rng, batch: int, actions_shape) -> dict:
    """Noise, time and per-camera augmentation as ``kai0_tpu.models.pi0.compute_loss(rng, train=True)`` draws them.

    Returned as torch tensors, ready for the port's ``compute_loss(noise=, time=, augment_params=)``.
    """
    from kai0_tpu.models import model as jax_model

    preprocess_rng, noise_rng, time_rng = jax.random.split(rng, 3)
    augment = {}
    for key in jax_model.IMAGE_KEYS:
        preprocess_rng, sub = jax.random.split(preprocess_rng)
        augment[key] = to_torch(jax_augment_draws(sub, batch, "wrist" not in key))
    noise = jax.random.normal(noise_rng, actions_shape)
    time = jax.random.beta(time_rng, 1.5, 1, (batch,)) * 0.999 + 0.001
    return {"noise": to_torch(noise), "time": to_torch(time), "augment_params": augment}


def jax_augmented_observation(rng, inputs: dict):
    """The observation JAX's ``compute_loss(rng, train=True)`` feeds the model, augmented with jit disabled.

    XLA's fusion of the jitted warp moves the images by up to 3.2e-5 against
    the eager run (which the port matches to 2.4e-7, ``test_torch_augment.py``).
    ``compute_loss(rng, obs, train=False)`` on this observation is the train
    branch with eager augmentation: noise and time use the same key splits.
    """
    from kai0_tpu.models import model as jax_model

    with jax.disable_jit():
        return jax_model.preprocess_observation(
            jax.random.split(rng, 3)[0], jax_model.Observation.from_dict(inputs), train=True
        )
