"""Shared set-up of the Model Arithmetic tests over the π₀-FAST and estimator families and under SwitchBack.

Three checkpoints as fine-tunes of one numpy-seeded base (``_torch_parity.numpy_params``): copies 1 and 2 move
every leaf by seeded noise. The port reads them as ``model.safetensors``; JAX's ``DeviceEnsemble`` reads the same
trees through ``kai0_tpu.arithmetic.core.load_params`` (cast to bf16 as it casts them) where JAX has no reader of
the family's ``model.safetensors`` (π₀-FAST: ``build_sites`` needs an action expert). ``Kept`` keeps JAX's
evaluations by their weights (key 0 makes its objective a function of them).
"""

from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import numpy_params
from kai0_tpu.arithmetic import core as jax_core
from kai0_tpu.parallel import sharding as jax_sharding
from kai0_tpu.transforms import flatten_dict, unflatten_dict
from kai0_tpu_torch import interop
from kai0_tpu_torch.arithmetic import core
from kai0_tpu_torch.models import model as torch_model

SEEDS = (0, 1, 2)


class Kept:
    """JAX's ``DeviceEnsemble`` whose evaluations are kept by their f32 weights."""

    def __init__(self, ensemble):
        self.ensemble, self.params_list, self.kept = ensemble, ensemble.params_list, {}

    def _call(self, method: str, weights, batches):
        key = (method, np.asarray(weights, np.float32).tobytes())
        if key not in self.kept:
            self.kept[key] = getattr(self.ensemble, method)(weights, batches)
        return self.kept[key]

    def loss(self, weights, batches):
        return self._call("loss", weights, batches)

    def loss_and_weight_grad(self, weights, batches):
        return self._call("loss_and_weight_grad", weights, batches)

    def checkpoint_losses(self, batches):
        return [self.loss(np.eye(len(self.params_list))[i], batches) for i in range(len(self.params_list))]


def fine_tunes(jax_model_config, std: float = 0.05) -> list[dict]:
    """The base's flat tree and two copies with every leaf moved by ``std`` x seeded normal noise."""
    base = flatten_dict(numpy_params(jax_model_config, 0))
    trees = []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        trees.append({k: v if seed == 0 else (v + std * rng.standard_normal(v.shape)).astype(v.dtype)
                      for k, v in base.items()})
    return trees


def ensembles(root: pathlib.Path, jax_model_config, torch_model_config, monkeypatch, *, device="cpu"):
    """(paths, port ``Ensemble``, JAX ``Kept(DeviceEnsemble)``) over ``fine_tunes``: the port's checkpoints written by
    the port's writer from the same trees; JAX's loader handed the trees."""
    trees = fine_tunes(jax_model_config)
    paths = []
    for seed, flat in zip(SEEDS, trees, strict=True):
        model = torch_model.model_class(torch_model_config)(torch_model_config, device="cpu")
        interop.load_jax_state(model, interop.state_from_jax(flat, model))
        paths.append(str(interop.save_torch_checkpoint(model, root / f"ckpt_{seed}").parent))
    by_path = dict(zip(paths, trees, strict=True))

    def load_params(path, dtype=None, model_config=None):
        return unflatten_dict({k: jnp.asarray(v, dtype) for k, v in by_path[str(path)].items()})

    monkeypatch.setattr(jax_core, "load_params", load_params)
    mesh = jax_sharding.make_mesh(1, devices=jax.devices()[:1])
    jax_ensemble = Kept(jax_core.DeviceEnsemble(paths, jax_model_config, mesh=mesh))
    return paths, core.Ensemble(paths, torch_model_config, device=device), jax_ensemble


def key0_flow_draws(shape) -> tuple[torch.Tensor, torch.Tensor]:
    """Noise and time as a flow model's ``compute_loss`` draws them from ``jax.random.key(0)``."""
    _, noise_rng, time_rng = jax.random.split(jax.random.key(0), 3)
    time = jax.random.beta(time_rng, 1.5, 1, shape[:1]) * 0.999 + 0.001
    return torch.from_numpy(np.array(jax.random.normal(noise_rng, shape))), torch.from_numpy(np.array(time))
