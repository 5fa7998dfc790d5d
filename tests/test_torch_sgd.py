"""The port's ``SGD`` and ``ClipSGD`` against ``kai0_tpu.training.optimizer``'s optax transforms.

Both sides run eagerly (no XLA fusion) on the same gradients, from numpy seeds,
with a constant learning rate (a schedule is computed in f32 by JAX and in f64
by the port; ``test_torch_optimizer.py`` holds the schedules). The updates and
the momentum trace are bit-equal in f32 over 3 steps, with and without Nesterov.
``ClipSGD``'s gradients are multiples of 1/4 no larger than 2, so every sum of
squares is exact in f32 whatever the order of its terms, and the global norm,
the clip and the updates are bit-equal, f32 and bf16, with the clip on and off.
Through one port ``train_step`` of a debug π₀.₅ (f32 parameters, batch 1): the
parameters move by exactly optax's update of the step's own gradients. The
state survives a checkpoint: SGD's trace bit-equal, ClipSGD's nothing but the
count. ``cli`` overrides reach their fields.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import DEBUG, model_inputs, to_torch
from kai0_tpu.training import optimizer as jax_opt
from kai0_tpu_torch.models import model as torch_model
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.training import checkpoints, cli, train_lib
from kai0_tpu_torch.training import optimizer as opt

LR = 0.01
SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 4, 3)}


def _grads(seed: int, *, quarters: bool = False, scale: float = 1.0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    if quarters:  # multiples of 1/4 in [-2, 2]: squares and their sums exact in f32
        return {k: (rng.integers(-8, 9, s) / 4 * scale).astype(np.float32) for k, s in SHAPES.items()}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _equal(got: dict, want: dict) -> None:
    for k, w in want.items():
        g = got[k]
        assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16 else torch.float32), k
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32), err_msg=k)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_matches_optax_bit_for_bit(nesterov):
    tx = jax_opt.SGD(momentum=0.9, nesterov=nesterov).create(lambda count: LR)
    port = opt.SGD(momentum=0.9, nesterov=nesterov)
    params = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    jax_state, state = tx.init({k: jnp.asarray(v) for k, v in params.items()}), port.init(to_torch(params))
    for step in range(3):
        grads = _grads(step)
        want, jax_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jax_state)
        got, state = port.update(to_torch(grads), state, None, lambda count: LR)
        _equal(got, want)
        _equal(state["trace"], jax_state[0].trace)
        assert state["count"] == int(jax_state[1].count) == step + 1


def test_sgd_refuses_a_weight_decay_mask_as_jax():
    mask = {k: True for k in SHAPES}
    with pytest.raises(ValueError, match="weight-decay mask"):
        jax_opt.SGD().create(lambda count: LR, weight_decay_mask=mask)
    with pytest.raises(ValueError, match="weight-decay mask"):
        opt.SGD().init(to_torch(_grads(0)), weight_decay_mask=mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.05, 1.0])  # global norm ~0.4 (no clip) and ~8 (clipped to 1)
def test_clip_sgd_matches_optax_bit_for_bit(dtype, scale):
    tx = jax_opt.ClipSGD().create(lambda count: LR)
    port = opt.ClipSGD()
    grads = _grads(1, quarters=True, scale=scale)
    jax_grads = {k: jnp.asarray(v, dtype) for k, v in grads.items()}
    port_grads = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in grads.items()}
    state = port.init(port_grads)
    assert state == {"count": 0}
    norm = float(opt.global_norm_f32(port_grads.values()))
    assert norm == float(jax_opt.global_norm_f32(jax_grads)) and (norm > 1.0) == (scale == 1.0)
    want, _ = tx.update(jax_grads, tx.init(jax_grads))
    got, state = port.update(port_grads, state, None, lambda count: LR)
    _equal(got, want)
    assert state == {"count": 1}


class _Captured:
    """``update`` of an optimizer class wrapped to keep a copy of the gradients it was handed."""

    def __init__(self, monkeypatch, cls):
        self.grads, update = None, cls.update

        def wrapped(optimizer, grads, *args):
            self.grads = {k: g.detach().clone() for k, g in grads.items()}
            return update(optimizer, grads, *args)

        monkeypatch.setattr(cls, "update", wrapped)


@pytest.mark.parametrize("optimizer", [opt.SGD(momentum=0.9), opt.ClipSGD(clip_gradient_norm=1e9)],
                         ids=["sgd", "clip_sgd"])
def test_one_train_step_applies_optax_update(monkeypatch, optimizer):
    model = torch_pi0.Pi0(torch_pi0.Pi0Config(**DEBUG), device="cpu").init_weights(torch.Generator().manual_seed(2))
    config = train_lib.TrainConfig(optimizer=optimizer, lr_schedule=lambda count: LR, ema_decay=None)
    state = train_lib.init_train_state(model, config, device="cpu")
    before = {k: p.detach().clone() for k, p in state.params.items()}
    captured = _Captured(monkeypatch, type(optimizer))
    obs = torch_model.Observation.from_dict(to_torch(model_inputs(3, batch=1)))
    actions = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 50, 32)).astype(np.float32))
    state, info = train_lib.train_step(model, state, (obs, actions), config)
    assert state.step == 1 and state.opt_state["count"] == 1 and np.isfinite(float(info["loss"]))
    create = jax_opt.SGD(momentum=0.9) if isinstance(optimizer, opt.SGD) else jax_opt.ClipSGD(1e9)
    tx = create.create(lambda count: LR)
    grads = {k: jnp.asarray(g.numpy()) for k, g in captured.grads.items()}
    updates, _ = tx.update(grads, tx.init(grads))
    moved = 0
    for k, p in state.params.items():
        want = np.asarray(optax.apply_updates(jnp.asarray(before[k].numpy()), updates[k]))
        np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=k)
        moved += bool((p.detach() != before[k]).any())
    assert moved > len(state.params) // 2


@pytest.mark.parametrize("optimizer", [opt.SGD(momentum=0.5, nesterov=True), opt.ClipSGD()], ids=["sgd", "clip_sgd"])
def test_checkpoint_round_trip(tmp_path, optimizer):
    config = train_lib.TrainConfig(optimizer=optimizer, lr_schedule=lambda count: LR, ema_decay=None)
    obs = torch_model.Observation.from_dict(to_torch(model_inputs(5, batch=1)))
    actions = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 50, 32)).astype(np.float32))

    def fresh():
        model = torch_pi0.Pi0(torch_pi0.Pi0Config(**DEBUG), device="cpu").init_weights(torch.Generator().manual_seed(7))
        return model, train_lib.init_train_state(model, config, device="cpu")

    model, state = fresh()
    for _ in range(2):
        state, _ = train_lib.train_step(model, state, (obs, actions), config)
    manager, _ = checkpoints.initialize_checkpoint_dir(tmp_path / "run", keep_period=None, overwrite=False,
                                                       resume=False)
    checkpoints.save_state(manager, model, state, 1)
    other_model, other = fresh()
    restored = checkpoints.restore_state(manager, other_model, other)
    assert restored.step == state.step == 2 and restored.opt_state["count"] == 2
    assert set(restored.opt_state) == set(state.opt_state)
    for k, p in state.params.items():
        assert torch.equal(restored.params[k], p), k
    if isinstance(optimizer, opt.SGD):
        assert all(torch.equal(restored.opt_state["trace"][k], t) for k, t in state.opt_state["trace"].items())
        assert any(bool(t.any()) for t in state.opt_state["trace"].values())


def test_cli_overrides_reach_sgd_and_clip_sgd():
    base = train_lib.TrainConfig()
    got = cli.parse_overrides(dataclasses.replace(base, optimizer=opt.ClipSGD()), {"optimizer.clip_gradient_norm": "0.5"})
    assert got.optimizer == opt.ClipSGD(clip_gradient_norm=0.5)
    got = cli.parse_overrides(dataclasses.replace(base, optimizer=opt.SGD()),
                              {"optimizer.momentum": "0.8", "optimizer.nesterov": "true"})
    assert got.optimizer == opt.SGD(momentum=0.8, nesterov=True)
