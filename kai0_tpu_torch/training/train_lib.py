"""Train-state init and the train step of the π₀.₅ fine-tunes (full, and LoRA over a frozen base).

Counterpart of ``kai0_tpu/training/train_lib.py:45-181``: ``init_train_state``
casts the parameters to ``param_dtype``, freezes what the model's freeze
filter names (the base weights of a ``*_lora`` expert: stored in bf16, without
gradients and, with ``quantize_frozen``, their matmul weights quantized to
int8 once) and builds the optimizer state, over the trainable parameters only,
and the EMA; ``train_step`` runs ``compute_loss`` -> backward -> clip -> AdamW ->
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

import torch

from kai0_tpu_torch.ops import quant as _quant
from kai0_tpu_torch.training import optimizer as _optimizer
from kai0_tpu_torch.training.config import TrainConfig
from kai0_tpu_torch.training.utils import TrainState, split_by_mask

_SEED = 42  # kai0_tpu.training.config.TrainConfig.seed


def trainable_mask(model: torch.nn.Module) -> dict[str, bool]:
    """name -> trainable for every parameter, from the model config's freeze filter (``TrainConfig.trainable_mask``)."""
    frozen = model.config.freeze_filter()
    return {name: not frozen(name) for name, _ in model.named_parameters()}


def freeze_params(model: torch.nn.Module, *, quantize: bool = False) -> dict[str, bool]:
    """Freeze what the model's freeze filter names, in place, and return the trainable mask.

    A frozen parameter loses its gradient and is stored in bf16; with
    ``quantize`` the frozen Gemma matmul weights then become int8
    ``QuantLinear`` holders (``quantize_frozen_tree``).
    """
    mask = trainable_mask(model)
    if not all(mask.values()):
        for name, p in model.named_parameters():
            if not mask[name]:
                p.requires_grad_(False)
                p.data = p.data.to(torch.bfloat16)
        if quantize:
            _quant.quantize_frozen_tree(model, mask)
    return mask


def init_train_state(model: torch.nn.Module, config: TrainConfig, *, device="cuda") -> TrainState:
    """Move the model to ``device`` in ``param_dtype``, freeze (and quantize) the frozen leaves; build the optimizer
    state over the trainable parameters and the EMA."""
    model.to(device=device, dtype=None if config.param_dtype is None else getattr(torch, config.param_dtype))
    mask = freeze_params(model, quantize=config.quantize_frozen)
    params = dict(model.named_parameters())
    trainable, _ = split_by_mask(params, mask)
    ema = None if config.ema_decay is None else {k: p.detach().clone() for k, p in params.items()}
    return TrainState(step=0, params=params, opt_state=config.optimizer.init(trainable), ema=ema)


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
    # The trainable leaves; frozen ones (and the int8 codes, which are buffers) pass through untouched.
    params = {k: p for k, p in state.params.items() if p.requires_grad}
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
            # Over every parameter, as JAX's tree map; quantized leaves are no parameters and pass through.
            d = config.ema_decay
            for k, e in state.ema.items():
                e.copy_(d * e + (1 - d) * state.params[k])
    new_state = TrainState(step=state.step + 1, params=state.params, opt_state=opt_state, ema=state.ema)
    return new_state, {"loss": loss.detach(), "grad_norm": grad_norm}


def param_norm(model: torch.nn.Module) -> torch.Tensor:
    """Kernel-params norm: >1-D weights without biases, scales and embeddings; a quantized leaf adds the norm of
    the weight it represents, from its codes and scales (``sq_norm``), so the metric compares with bf16 runs."""
    skip = ("bias", "position_embedding.weight", "embed_tokens.weight")
    total = sum(
        torch.sum(torch.square(p.detach().float()))
        for name, p in model.named_parameters() if p.ndim > 1 and not name.endswith(skip)
    )
    total = total + sum(_quant.sq_norm(m) for m in model.modules() if _quant.is_quant(m))
    return torch.sqrt(total)
