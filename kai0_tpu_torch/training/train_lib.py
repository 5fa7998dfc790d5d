"""Train-state init, the train step and the training loop of the π₀, π₀.₅ and π₀-FAST fine-tunes (full, and LoRA over
a frozen base) and of the advantage estimator.

Counterpart of ``kai0_tpu/training/train_lib.py``: ``init_train_state``
copies in the weight loader's weights (unless the run resumes, when the
checkpoint brings them), casts the parameters to ``param_dtype``, freezes what the model's freeze
filter names (the base weights of a ``*_lora`` expert: stored in bf16, without
gradients and, with ``quantize_frozen``, their matmul weights at the
``int8_sites`` quantized to int8 once), runs the selected products by
SwitchBack (``TrainConfig.knobs``: ``int8_sb_gemma``, ``int8_switchback``;
same parameters, so checkpoints and optimizer state keep their keys) and
builds the optimizer state, over the trainable parameters only, and the EMA; ``train_step`` runs ``compute_loss`` -> backward -> clip -> AdamW ->
weight decay -> learning rate -> apply (stochastically rounded into bf16
parameters) -> EMA, and returns ``{"loss", "grad_norm"}`` with the norm
accumulated in f32. Parameters and optimizer state are updated in place.
``main`` is the loop of ``scripts/train_torch.py``: data, checkpoints with
resume, metrics and the profiler around ``train_step`` (its docstring).

Randomness: noise, time and augmentation draw from a generator determined by
(``TrainConfig.seed``, 42 by default, and the step), like
``fold_in(rng, step)``; explicit ``noise``,
``time`` and ``augment_params`` override those draws (the CPU tests hand in
the JAX package's). The bf16 apply and the optimizer's rounding have their
own step-derived generators (``optimizer.step_generator``).
"""

from __future__ import annotations

from collections.abc import Callable
import logging
import time

import torch

from kai0_tpu_torch import knobs as _knobs
from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.ops import quant as _quant
from kai0_tpu_torch.training import optimizer as _optimizer
from kai0_tpu_torch.training.config import TrainConfig
from kai0_tpu_torch.training.utils import TrainState, array_tree_to_info, split_by_mask

logger = logging.getLogger("kai0_tpu_torch")


def trainable_mask(model: torch.nn.Module) -> dict[str, bool]:
    """name -> trainable for every parameter, from the model config's freeze filter (``TrainConfig.trainable_mask``)."""
    frozen = model.config.freeze_filter()
    return {name: not frozen(name) for name, _ in model.named_parameters()}


def freeze_params(model: torch.nn.Module, *, quantize: bool = False, knobs: _knobs.Knobs | None = None) -> dict[str, bool]:
    """Freeze what the model's freeze filter names, in place, and return the trainable mask.

    A frozen parameter loses its gradient and is stored in bf16; with
    ``quantize`` the frozen Gemma matmul weights at ``knobs.int8_sites`` then
    become int8 ``QuantLinear`` holders (``quantize_frozen_tree``), weight-only
    under ``knobs.int8_weight_only``.
    """
    mask = trainable_mask(model)
    if not all(mask.values()):
        for name, p in model.named_parameters():
            if not mask[name]:
                p.requires_grad_(False)
                p.data = p.data.to(torch.bfloat16)
        if quantize:
            knobs = _knobs.resolve(knobs)
            _quant.quantize_frozen_tree(model, mask, _quant.gemma_sites(knobs.int8_sites),
                                        weight_only=knobs.int8_weight_only)
    return mask



def _load_weights_and_validate(loader, model: torch.nn.Module) -> None:
    """Copy the loader's weights into the model; they must have the model's keys, shapes and dtypes (JAX's
    ``check_pytree_equality`` and the unknown-key check of its ``init``)."""
    params = model.state_dict()
    loaded = loader.load(params)
    missing, extra = sorted(set(params) - set(loaded)), sorted(set(loaded) - set(params))
    if missing or extra:
        raise ValueError(
            "Loaded weights do not match the model.\n"
            + (f"  Missing keys ({len(missing)}): {missing[:20]}\n" if missing else "")
            + (f"  Unknown keys ({len(extra)}): {extra[:20]}\n" if extra else "")
        )
    errors = [f"  {k}: {tuple(v.shape)} {v.dtype} != expected {tuple(params[k].shape)} {params[k].dtype}"
              for k, v in loaded.items() if v.shape != params[k].shape or v.dtype != params[k].dtype]
    if errors:
        raise ValueError("Loaded weights differ from the model's:\n" + "\n".join(errors[:40]))
    with torch.no_grad():
        for k, v in loaded.items():
            if v is not params[k]:
                params[k].copy_(v)


def init_train_state(model: torch.nn.Module, config: TrainConfig, *, device="cuda", resume: bool = False) -> TrainState:
    """Copy in ``config.weight_loader``'s weights unless ``resume`` (a resume restores them from the checkpoint),
    move the model to ``device`` in ``param_dtype``, freeze (and quantize) the frozen leaves, install SwitchBack
    where the knobs select it; build the optimizer state over the trainable parameters and the EMA."""
    model.to(device=device)
    if not resume:
        _load_weights_and_validate(config.weight_loader, model)
    model.to(dtype=None if config.param_dtype is None else getattr(torch, config.param_dtype))
    knobs = _knobs.resolve(config.knobs)
    mask = freeze_params(model, quantize=config.quantize_frozen, knobs=knobs)
    _quant.switchback_tree(model, gemma=knobs.int8_sb_gemma, siglip=knobs.int8_switchback,
                           weight_only=knobs.int8_weight_only)
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
        generator = _optimizer.step_generator(config.seed, state.step, device=model.device)
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


def create_model(config: TrainConfig, *, device="cuda") -> torch.nn.Module:
    """The config's model (``model.model_class``) on ``device`` in ``param_dtype`` (f32 without one), drawn from
    ``config.seed``."""
    dtype = torch.float32 if config.param_dtype is None else getattr(torch, config.param_dtype)
    model = _model.model_class(config.model)(config.model, device=device, param_dtype=dtype)
    return model.init_weights(torch.Generator(device=device).manual_seed(config.seed))


def main(
    config: TrainConfig,
    *,
    device="cuda",
    on_step: Callable[[int, dict], None] | None = None,
) -> tuple[torch.nn.Module, TrainState]:
    """Train ``config`` on ``device`` (the card unless the caller says otherwise); returns the model and its state.

    The loop of ``kai0_tpu/training/train_lib.py:184-311``, step by step:
    checkpoint directory and resume detection, ``MetricsLogger``, the loader
    and its first batch (logged), ``init_train_state`` with the weight loader
    (none on a resume, which restores the checkpoint and requantizes an int8
    base), then the steps: a ``torch.profiler`` trace of ``profile_steps``
    steps into ``<checkpoint_dir>/profile``, every ``log_interval`` the mean
    ``loss`` and ``grad_norm``, ``param_norm`` and ``steps_per_sec`` (logged
    and appended to ``metrics.jsonl``), and a synchronous save at
    ``save_interval`` and at the last step. The state's step is the loop step
    + 1, and a checkpoint is named by the loop step, as in JAX.

    ``on_step(step, record)``, when given, is called after each step with its
    ``loss`` and ``grad_norm`` (tensors on the device), ``loader_wait_ms``
    (how long the loop waited for the next batch) and, at a save,
    ``save_s`` and ``save_bytes``.
    """
    from kai0_tpu_torch.training import checkpoints as _checkpoints
    from kai0_tpu_torch.training import data_loader as _data_loader
    from kai0_tpu_torch.training import metrics as _metrics

    logger.info(f"Training config: {config.name} exp={config.exp_name}")
    if config.fsdp_devices > 1:
        raise NotImplementedError(
            f"fsdp_devices={config.fsdp_devices}: training sharded over several cards waits for multi-GPU (ROADMAP "
            "Queue 1 item 10)"
        )
    n_data_shards = 1  # one card: data parallelism over several is ROADMAP Queue 1 item 10
    if config.batch_size % n_data_shards != 0:
        raise ValueError(f"Batch size {config.batch_size} must be divisible by the number of data shards {n_data_shards}.")
    device = torch.device(device)

    manager, resuming = _checkpoints.initialize_checkpoint_dir(
        config.checkpoint_dir, keep_period=config.keep_period, overwrite=config.overwrite, resume=config.resume
    )
    metrics_logger = _metrics.MetricsLogger(
        config.checkpoint_dir, resuming=resuming, enabled=config.wandb_enabled, config=config
    )
    data_loader = _data_loader.create_data_loader(config, device=device, shuffle=True)
    data_config = data_loader.data_config()
    data_iter = iter(data_loader)
    try:
        batch = next(data_iter)
        logger.info(f"Initialized data loader:\n{array_tree_to_info(batch)}")

        model = create_model(config, device=device)
        state = init_train_state(model, config, device=device, resume=resuming)
        if resuming:
            state = _checkpoints.restore_state(manager, model, state)

        start_step = state.step
        profile_start = max(start_step + 1, config.profile_start_step)
        profile_stop_step = profile_start + config.profile_steps if config.profile_steps > 0 else None
        profiler = None
        infos = []
        t_last = time.time()
        for step in range(start_step, config.num_train_steps):
            if profile_stop_step is not None and step == profile_start:
                profile_dir = config.checkpoint_dir / "profile"
                logger.info(f"Capturing a torch.profiler trace of {config.profile_steps} steps → {profile_dir}")
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            state, info = train_step(model, state, batch, config)
            if profiler is not None and step + 1 == profile_stop_step:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.stop()
                profile_dir.mkdir(parents=True, exist_ok=True)
                profiler.export_chrome_trace(str(profile_dir / f"trace_steps_{profile_start}-{step}.json"))
                profiler = profile_stop_step = None
            infos.append(info)
            if step % config.log_interval == 0:
                reduced = {k: float(torch.stack([i[k] for i in infos]).mean()) for k in sorted(infos[0])}  # JAX order
                reduced["param_norm"] = float(param_norm(model))
                elapsed = time.time() - t_last
                t_last = time.time()
                reduced["steps_per_sec"] = len(infos) / max(elapsed, 1e-9)
                info_str = ", ".join(f"{k}={float(v):.4f}" for k, v in reduced.items())
                logger.info(f"Step {step}: {info_str}")
                metrics_logger.log(reduced, step=step)
                infos = []
            t_wait = time.perf_counter()
            batch = next(data_iter)
            record = {**info, "loader_wait_ms": (time.perf_counter() - t_wait) * 1000}

            if (step % config.save_interval == 0 and step > start_step) or step == config.num_train_steps - 1:
                t_save = time.perf_counter()
                nbytes = _checkpoints.save_state(
                    manager, model, state, step, norm_stats=data_config.norm_stats, asset_id=data_config.asset_id
                )
                record.update(save_s=time.perf_counter() - t_save, save_bytes=nbytes)
                logger.info(f"Saved step {step} to {manager.step_dir(step)}: {nbytes / 1e9:.3f} GB in "
                            f"{record['save_s']:.2f}s (synchronous)")
            if on_step is not None:
                on_step(step, record)
    finally:
        data_iter.close()
        data_loader.close()
        metrics_logger.close()
    return model, state
