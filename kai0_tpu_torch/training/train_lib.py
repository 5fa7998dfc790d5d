"""Train-state init and the train step of the π₀.₅ full fine-tune.

Counterpart of ``kai0_tpu/training/train_lib.py:45-162``: ``init_train_state``
casts the parameters to ``param_dtype`` and builds the optimizer state and the
EMA; ``train_step`` runs ``compute_loss`` -> backward -> clip -> AdamW ->
weight decay -> learning rate -> apply (stochastically rounded into bf16
parameters) -> EMA, and returns ``{"loss", "grad_norm"}`` with the norm
accumulated in f32. Parameters and optimizer state are updated in place.

Randomness: noise, time and augmentation draw from a generator determined by
(seed 42, kai0's default ``TrainConfig.seed``, and the step), like
``fold_in(rng, step)``; explicit ``noise``,
``time`` and ``augment_params`` override those draws (the CPU tests hand in
the JAX package's). The bf16 apply and the optimizer's rounding have their
own step-derived generators (``optimizer.step_generator``).
"""

from __future__ import annotations

import dataclasses

import torch

from kai0_tpu_torch.training import optimizer as _optimizer
from kai0_tpu_torch.training.utils import TrainState

_SEED = 42  # kai0_tpu.training.config.TrainConfig.seed


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of ``kai0_tpu.training.config.TrainConfig`` the step reads, with its defaults."""

    optimizer: _optimizer.AdamW = dataclasses.field(default_factory=_optimizer.AdamW)
    lr_schedule: _optimizer.CosineDecaySchedule | _optimizer.RsqrtDecaySchedule = dataclasses.field(
        default_factory=_optimizer.CosineDecaySchedule
    )
    ema_decay: float | None = 0.99
    param_dtype: str | None = None  # storage dtype of the parameters; None keeps the model's (f32)


def init_train_state(model: torch.nn.Module, config: TrainConfig, *, device="cuda") -> TrainState:
    """Move the model to ``device`` in ``param_dtype``; build the optimizer state and the EMA."""
    model.to(device=device, dtype=None if config.param_dtype is None else getattr(torch, config.param_dtype))
    params = dict(model.named_parameters())
    ema = None if config.ema_decay is None else {k: p.detach().clone() for k, p in params.items()}
    return TrainState(step=0, params=params, opt_state=config.optimizer.init(params), ema=ema)


def train_step(
    model,
    state: TrainState,
    batch,
    config: TrainConfig,
    *,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    time: torch.Tensor | None = None,
    augment_params: dict | None = None,
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimisation step on ``batch = (observation, actions)``; returns (state, {"loss", "grad_norm"})."""
    observation, actions = batch
    if generator is None:
        generator = _optimizer.step_generator(_SEED, state.step, device=model.device)
    params = state.params
    for p in params.values():
        p.grad = None
    with torch.enable_grad():
        loss = model.compute_loss(
            observation, actions, train=True, noise=noise, time=time, augment_params=augment_params,
            generator=generator,
        ).mean()
        loss.backward()

    with torch.no_grad():
        # A parameter the loss does not reach (the prefix expert's final norm) has a zero gradient.
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in params.items()}
        for p in params.values():
            p.grad = None
        grad_norm = _optimizer.global_norm_f32(grads.values())
        updates, opt_state = config.optimizer.update(grads, state.opt_state, params, config.lr_schedule)
        del grads
        if config.param_dtype == "bfloat16":
            _optimizer.apply_updates_sr(params, updates, state.step)
        else:
            _optimizer.apply_updates(params, updates)
        del updates
        if state.ema is not None:
            d = config.ema_decay
            for k, e in state.ema.items():
                e.copy_(d * e + (1 - d) * params[k])
    new_state = TrainState(step=state.step + 1, params=params, opt_state=opt_state, ema=state.ema)
    return new_state, {"loss": loss.detach(), "grad_norm": grad_norm}
