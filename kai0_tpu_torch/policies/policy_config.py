"""Assemble a trained Policy from a checkpoint.

Counterpart of ``kai0_tpu/policies/policy_config.py:28-151``: reads the
checkpoint's ``model.safetensors`` (the ``PI0Pytorch`` key layout; π₀-FAST's
is its PaliGemma half) into the config's model with bf16 parameters (π₀ or
π₀.₅ ``Pi0``, ``Pi0RTC`` for an RTC config, ``Pi0FAST``), optionally
quantizes its Gemma matmul weights to int8
(``ops/quant.quantize_inference_tree``; the config's ``knobs`` under the
``KAI0_INT8_*`` environment choose the Gemma sites, the SigLIP sites and
weight-only), runs the products that ``int8_sb_gemma`` / ``int8_switchback``
select by SwitchBack (``ops/quant.switchback_tree``, as JAX's
``apply_model_knobs`` makes its models trace them; with ``quantize`` a frozen
int8 site keeps its int8 product), loads the norm stats from the
checkpoint's ``assets/<asset_id>`` (so serving uses the stats training used),
and builds the transform chains

    inputs : repack → InjectDefaultPrompt → data-in → Normalize → model-in
    outputs: model-out → Unnormalize → data-out → repack-out

``sample_kwargs`` go to every sampler call (a FAST config's
``max_decoding_steps``, ``temperature``); ``max_batch`` > 1 wraps the policy in
``serving/batching.BatchingPolicy``. An Orbax ``params/`` checkpoint is read
only by the JAX package. Serving sharded over several cards waits for its
slice.
"""

from __future__ import annotations

from collections.abc import Mapping
import logging
import pathlib
from typing import Any

import numpy as np
import torch

from kai0_tpu_torch import interop as _interop
from kai0_tpu_torch import knobs as _knobs
from kai0_tpu_torch import transforms as _transforms
from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.ops import quant as _quant
from kai0_tpu_torch.policies import policy as _policy

logger = logging.getLogger("kai0_tpu_torch")


def _load_model(model_config, checkpoint_dir: pathlib.Path, params: Mapping | None, device):
    model_cls = _model.model_class(model_config)
    if params is not None:
        state = {k: v if isinstance(v, torch.Tensor) else _interop._to_tensor(np.asarray(v)) for k, v in params.items()}
        dtype = next(v.dtype for v in state.values() if v.is_floating_point())
        model = model_cls(model_config, device=device, param_dtype=dtype)
        model.load_state_dict(state, strict=True)
        return model
    if not _interop.is_torch_checkpoint(checkpoint_dir):
        if (checkpoint_dir / "params").exists():
            raise NotImplementedError(
                f"{checkpoint_dir / 'params'} is an Orbax checkpoint, which only the JAX package reads; export it with "
                "kai0_tpu.interop.save_torch_checkpoint to model.safetensors"
            )
        raise FileNotFoundError(f"no {_interop.CHECKPOINT_FILE} under {checkpoint_dir} (the port reads local directories)")
    logger.info(f"Loading model from {checkpoint_dir}...")
    model = model_cls(model_config, device=device, param_dtype=torch.bfloat16)
    return _interop.load_torch_checkpoint(model, checkpoint_dir)


def create_trained_policy(
    train_config,
    checkpoint_dir: pathlib.Path | str,
    *,
    repack_transforms: _transforms.Group | None = None,
    default_prompt: str | None = None,
    norm_stats: dict | None = None,
    warmup: bool = False,
    quantize: bool = False,
    prompt_buckets: list[int] | None = None,
    sample_kwargs: dict[str, Any] | None = None,
    fsdp_devices: int = 1,
    max_batch: int = 1,
    batch_wait_ms: float = 0.0,
    params: Mapping[str, Any] | None = None,
    device: torch.device | str = "cuda",
) -> _policy.Policy:
    """A ``Policy`` serving ``train_config``'s model from ``checkpoint_dir``, on the card unless ``device`` says
    otherwise, behind a ``BatchingPolicy`` when ``max_batch`` > 1. ``params`` (a state dict in the ``PI0Pytorch``
    layout) replaces the checkpoint's weights, in their dtype; noise is drawn from a generator seeded with 0."""
    if fsdp_devices > 1:
        raise NotImplementedError(
            f"fsdp_devices={fsdp_devices}: serving sharded over several cards waits for multi-GPU (ROADMAP Queue 1 "
            "item 10)"
        )
    repack_transforms = repack_transforms or _transforms.Group()
    checkpoint_dir = pathlib.Path(checkpoint_dir)
    model = _load_model(train_config.model, checkpoint_dir, params, device).eval()
    knobs = _knobs.resolve(train_config.knobs)
    logger.info(f"Model knobs: {knobs}")
    if quantize:
        # int8 matmul weights: half the weight bytes; moves the actions slightly.
        _quant.quantize_inference_tree(
            model, sites=_quant.gemma_sites(knobs.int8_sites), siglip_sites=_quant.siglip_inference_sites(knobs.int8_siglip),
            weight_only=knobs.int8_weight_only,
        )
    # SwitchBack where the knobs select it, before any graph is captured; frozen int8 holders keep their product.
    _quant.switchback_tree(model, gemma=knobs.int8_sb_gemma, siglip=knobs.int8_switchback,
                           weight_only=knobs.int8_weight_only)

    data_config = train_config.data.create(train_config.assets_dirs, train_config.model)
    if norm_stats is None and data_config.asset_id is not None:
        # From the checkpoint, not the config's assets: serving must use the stats the training run used.
        try:
            norm_stats = _interop.load_norm_stats(checkpoint_dir / "assets", data_config.asset_id)
        except FileNotFoundError:
            logger.warning(
                f"No norm stats under {checkpoint_dir / 'assets'} for asset {data_config.asset_id}; "
                "serving without normalization."
            )

    policy = _policy.Policy(
        model,
        train_config.model,
        device=device,
        generator=torch.Generator(device=device).manual_seed(0),
        transforms=[
            *repack_transforms.inputs,
            _transforms.InjectDefaultPrompt(default_prompt),
            *data_config.data_transforms.inputs,
            _transforms.Normalize(norm_stats, use_quantiles=data_config.use_quantile_norm),
            *data_config.model_transforms.inputs,
        ],
        output_transforms=[
            *data_config.model_transforms.outputs,
            _transforms.Unnormalize(norm_stats, use_quantiles=data_config.use_quantile_norm),
            *data_config.data_transforms.outputs,
            *repack_transforms.outputs,
        ],
        metadata=train_config.policy_metadata,
        prompt_buckets=prompt_buckets,
        sample_kwargs=sample_kwargs,
    )
    if max_batch > 1:
        from kai0_tpu_torch.serving import batching as _batching

        policy = _batching.BatchingPolicy(policy, max_batch, wait_ms=batch_wait_ms)
    if warmup:
        policy.warmup(_warmup_example(train_config))
    return policy


def _warmup_example(train_config) -> dict | None:
    """A raw observation of the config's robot family, or None for a config without robot transforms."""
    from kai0_tpu_torch.policies import agilex_policy, aloha_policy, droid_policy, libero_policy
    from kai0_tpu_torch.training import config as _config
    from kai0_tpu_torch.training import robot_configs

    data = train_config.data
    if isinstance(data, (robot_configs.LerobotAgilexDataConfig, robot_configs.LerobotARXDataConfig)):
        return agilex_policy.make_agilex_example()
    if isinstance(data, robot_configs.LeRobotAlohaDataConfig):
        return aloha_policy.make_aloha_example()
    if isinstance(data, (robot_configs.LeRobotDROIDDataConfig, robot_configs.RLDSDroidDataConfig)):
        return droid_policy.make_droid_example()
    if isinstance(data, robot_configs.LeRobotLiberoDataConfig):
        return libero_policy.make_libero_example()
    if isinstance(data, _config.FakeDataConfig):
        return None
    if isinstance(data, _config.SimpleDataConfig) and any(
        isinstance(t, droid_policy.DroidInputs) for t in data.data_transforms(train_config.model).inputs
    ):
        return droid_policy.make_droid_example()  # the RoboArena baselines
    return agilex_policy.make_agilex_example()
