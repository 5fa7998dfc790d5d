"""The port's ``train_step`` against ``kai0_tpu.training.train_lib.train_step``.

Three steps of the kai0 default configuration (f32 parameters, f32 AdamW with
b2 0.95, weight decay 1e-10 and the global-norm clip at 1, EMA 0.99) at debug
size, batch 2, on the same batch. The schedule is the default cosine shape
with a short warmup and a larger peak (1e-3 at step 2) so that three steps
move the parameters by far more than f32 rounding. JAX's step runs jitted with
the model's ``compute_loss`` fed images augmented eagerly with the step's own
draws (``_torch_parity.jax_augmented_observation``; its jitted warp would move
them by up to 3.2e-5); the port's step gets the same draws
(``fold_in(rng, step)`` split as ``compute_loss`` splits it).

Tolerances: loss within 1e-5 x max(1, loss); grad_norm within 1e-5 relative;
after three steps, every element's change of the parameters and of the EMA
within 1e-2 x the tensor's largest change, plus 4 f32 ulps of the element
(the change is a difference of rounded values), and at most 2e-3 of the
elements beyond 1e-3 x the largest change. Adam normalises each element, so
an element whose gradient is within a few ulps of eps in both packages moves
by another fraction of the learning rate: the worst element measured 4.4e-3 x
the largest change, and no tensor had more than one element beyond 1e-3.
SigLIP's key bias is left out: softmax cancels its gradient, so both packages
normalise rounding noise. One step of the single-card bundle (bf16 parameters
with stochastic rounding, int8 moments, no EMA) is checked for finite numbers,
dtypes and shapes.

π₀ (``pi05=False``: the state token and the action-time MLP; numpy-seeded
weights carried across by ``interop.state_from_jax``): one step of both
packages, without augmentation, on the same noise and time: loss and
grad_norm within 1e-5 relative, the π₀ heads' change within 1e-5 x their
largest change plus 4 f32 ulps (``test_torch_pi0_state.py`` holds its loss
and every gradient).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (DEBUG, debug_models, jax_augmented_observation, jax_loss_draws, model_inputs,
                           numpy_params, to_torch)
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import model as jax_model
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.training import optimizer as jax_opt
from kai0_tpu.training import train_lib as jax_train_lib
from kai0_tpu.training import utils as jax_utils
from kai0_tpu.transforms import flatten_dict
from kai0_tpu_torch import interop
from kai0_tpu_torch.models import model as torch_model
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.training import optimizer as opt
from kai0_tpu_torch.training import train_lib

BATCH, STEPS = 2, 3
SCHEDULE = dict(peak_lr=1e-3, decay_lr=1e-4, warmup_steps=2, decay_steps=100)


@dataclasses.dataclass(frozen=True)
class _PreAugmented:
    """JAX's model config whose ``compute_loss(train=True)`` takes already-augmented images."""

    config: jax_pi0.Pi0Config

    def compute_loss(self, params, rng, observation, actions, *, train):
        assert train
        return jax_pi0.compute_loss(params, self.config, rng, observation, actions, train=False)


@dataclasses.dataclass(frozen=True)
class _JaxConfig:
    model: _PreAugmented
    param_dtype: str | None = None
    ema_decay: float | None = 0.99


@pytest.fixture(scope="module")
def runs():
    jax_config, params, _, model = debug_models(seed=0)
    inputs = model_inputs(3, batch=BATCH)
    actions = np.random.default_rng(4).standard_normal((BATCH, 50, 32)).astype(np.float32)
    rng = jax.random.key(9)

    tx = jax_opt.create_optimizer(jax_opt.AdamW(), jax_opt.CosineDecaySchedule(**SCHEDULE))
    step_fn = jax.jit(functools.partial(
        jax_train_lib.train_step, _JaxConfig(_PreAugmented(jax_config)), tx, jax.tree.map(lambda _: True, params)
    ))
    jax_state = jax_utils.TrainState(step=jnp.int32(0), params=params, opt_state=tx.init(params), ema_params=params)

    config = train_lib.TrainConfig(lr_schedule=opt.CosineDecaySchedule(**SCHEDULE))
    state = train_lib.init_train_state(model, config, device="cpu")
    before = {k: p.detach().clone() for k, p in state.params.items()}
    obs = torch_model.Observation.from_dict(to_torch(inputs))

    infos = []
    for i in range(STEPS):
        train_rng = jax.random.fold_in(rng, i)
        jax_state, jax_info = step_fn(rng, jax_state, (jax_augmented_observation(train_rng, inputs), actions))
        state, info = train_lib.train_step(
            model, state, (obs, torch.from_numpy(actions)), config, **jax_loss_draws(train_rng, BATCH, actions.shape)
        )
        infos.append(({k: float(v) for k, v in jax_info.items()}, {k: float(v) for k, v in info.items()}))
    assert int(jax_state.step) == state.step == STEPS
    want = {
        "params": tsf.jax_to_torch_state(jax_state.params, jax_config),
        "ema": tsf.jax_to_torch_state(jax_state.ema_params, jax_config),
    }
    return infos, before, state, want


def test_loss_and_grad_norm_track_jax(runs):
    infos, _, _, _ = runs
    for want, got in infos:
        assert np.isfinite(got["loss"]) and got["grad_norm"] > 0
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * max(1.0, abs(want["loss"]))
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-5 * want["grad_norm"]
    assert any(got["grad_norm"] > 1.0 for _, got in infos) or all(got["grad_norm"] < 1.0 for _, got in infos)


@pytest.mark.parametrize("which", ["params", "ema"])
def test_params_and_ema_track_jax(runs, which):
    _, before, state, want = runs
    tensors = state.params if which == "params" else state.ema
    moved = 0
    for key, p in tensors.items():
        if key.endswith("self_attn.k_proj.bias") and "vision_tower" in key:
            continue
        start = before[key].numpy().astype(np.float64)
        got = p.detach().numpy().astype(np.float64) - start
        ref = np.asarray(want[which][key], dtype=np.float64) - start
        scale = np.abs(ref).max()
        err = np.abs(got - ref)
        floor = 4 * np.finfo(np.float32).eps * np.abs(start) + 1e-12
        assert (err <= 1e-2 * scale + floor).all(), (key, err.max(), scale)
        assert (err > 1e-3 * scale + floor).mean() <= 2e-3, key
        moved += scale > 1e-5
    assert moved >= len(tensors) - 8  # the tensors the loss cannot reach move by weight decay only


def test_one_step_of_the_single_card_bundle():
    model = torch_pi0.Pi0(torch_pi0.Pi0Config(**DEBUG), device="cpu").init_weights(torch.Generator().manual_seed(1))
    config = train_lib.TrainConfig(optimizer=opt.AdamW(state_dtype="int8"), param_dtype="bfloat16", ema_decay=None)
    state = train_lib.init_train_state(model, config, device="cpu")
    shapes = {k: p.shape for k, p in state.params.items()}
    obs = torch_model.Observation.from_dict(to_torch(model_inputs(2, batch=1)))
    actions = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 50, 32)).astype(np.float32))
    state, info = train_lib.train_step(model, state, (obs, actions), config)
    assert state.step == 1 and state.ema is None and state.opt_state["count"] == 1
    assert np.isfinite(float(info["loss"])) and float(info["grad_norm"]) > 0
    for key, p in state.params.items():
        assert p.dtype == torch.bfloat16 and p.shape == shapes[key] and torch.isfinite(p.float()).all(), key
        mu, nu = state.opt_state["mu"][key], state.opt_state["nu"][key]
        assert mu["q"].dtype == torch.int8 and nu["q"].dtype == torch.uint8 and mu["q"].shape == shapes[key]
    assert all(state.opt_state["nu"][k]["s"].max() > 0 for k in ("action_in_proj.weight", "time_mlp_out.weight"))


PI0 = dict(DEBUG, pi05=False)
PI0_HEADS = ("state_proj", "action_time_mlp_in", "action_time_mlp_out")


def _pi0_draws(rng, batch: int) -> dict:
    """Noise and time as ``kai0_tpu.models.pi0.compute_loss`` draws them from ``rng``."""
    _, noise_rng, time_rng = jax.random.split(rng, 3)
    noise = jax.random.normal(noise_rng, (batch, 50, 32))
    time = jax.random.beta(time_rng, 1.5, 1, (batch,)) * 0.999 + 0.001
    return {"noise": to_torch(noise), "time": to_torch(time)}


def test_one_pi0_train_step_matches_jax():
    jax_config = jax_pi0.Pi0Config(**PI0)
    params = numpy_params(jax_config, seed=0)
    model = torch_pi0.Pi0(torch_pi0.Pi0Config(**PI0), device="cpu")
    interop.load_jax_state(model, interop.state_from_jax({k: np.asarray(v) for k, v in flatten_dict(params).items()},
                                                         model))
    inputs = model_inputs(3, batch=BATCH)
    actions = np.random.default_rng(4).standard_normal((BATCH, 50, 32)).astype(np.float32)
    rng = jax.random.key(9)

    # Both steps skip the augmentation (held to JAX by the π₀.₅ steps above; its eager JAX run costs ~9 s here).
    @dataclasses.dataclass(frozen=True)
    class Unaugmented:
        def compute_loss(self, p, key, observation, acts, *, train):
            return jax_pi0.compute_loss(p, jax_config, key, observation, acts, train=False)

    @dataclasses.dataclass(frozen=True)
    class JaxConfig:
        model: Unaugmented = Unaugmented()
        param_dtype: str | None = None
        ema_decay: float | None = 0.99

    class PortUnaugmented:
        device = model.device

        def compute_loss(self, observation, acts, *, train, **kwargs):
            return model.compute_loss(observation, acts, train=False, **kwargs)

    tx = jax_opt.create_optimizer(jax_opt.AdamW(), jax_opt.CosineDecaySchedule(**SCHEDULE))
    mask = jax.tree.map(lambda _: True, params)
    step_fn = jax.jit(functools.partial(jax_train_lib.train_step, JaxConfig(), tx, mask))
    jax_state = jax_utils.TrainState(step=jnp.int32(0), params=params, opt_state=tx.init(params), ema_params=params)
    jax_state, jax_info = step_fn(rng, jax_state, (jax_model.Observation.from_dict(inputs), actions))

    config = train_lib.TrainConfig(lr_schedule=opt.CosineDecaySchedule(**SCHEDULE))
    state = train_lib.init_train_state(model, config, device="cpu")
    before = {k: p.detach().clone() for k, p in state.params.items()}
    obs = torch_model.Observation.from_dict(to_torch(inputs))
    state, info = train_lib.train_step(PortUnaugmented(), state, (obs, torch.from_numpy(actions)), config,
                                       **_pi0_draws(jax.random.fold_in(rng, 0), BATCH))
    for k in ("loss", "grad_norm"):
        assert abs(float(info[k]) - float(jax_info[k])) <= 1e-5 * max(1.0, abs(float(jax_info[k]))), k
    want = tsf.jax_to_torch_state(jax_state.params, jax_config)
    for key in (f"{h}.{p}" for h in PI0_HEADS for p in ("weight", "bias")):
        start = before[key].numpy().astype(np.float64)
        ref = np.asarray(want[key], np.float64) - start
        got = state.params[key].detach().numpy().astype(np.float64) - start
        assert np.abs(ref).max() > 0, key
        bound = 1e-5 * np.abs(ref).max() + 4 * np.finfo(np.float32).eps * np.abs(start).max()
        assert np.abs(got - ref).max() <= bound, (key, np.abs(got - ref).max())
