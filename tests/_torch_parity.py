"""Shared set-up for the tests that hold kai0_tpu_torch to kai0_tpu.

Weights are drawn by the JAX init, with every all-zero leaf (adaRMS ``Dense_0``,
the SigLIP ``head``, biases, RMSNorm scales) replaced by seeded numpy noise so
that no path of the model is switched off; the same tree then goes to both
packages through ``jax_to_torch_state``. Inputs are numpy arrays from a seed.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.transforms import flatten_dict, unflatten_dict
from kai0_tpu_torch import interop as torch_interop
from kai0_tpu_torch.models import pi0 as torch_pi0

DEBUG = dict(paligemma_variant="dummy", action_expert_variant="dummy", vision_variant="mu/14", dtype="float32", pi05=True)


@pytest.fixture(scope="module", autouse=True)
def worker_share_of_torch_threads():
    """Torch's CPU threads cut to the pytest-xdist worker's share of the cores for the module that imports this.

    With more threads than cores (each of 6 workers taking all 8), every one of the
    debug models' many small parallel regions waits for descheduled threads: the
    slowest port modules ran 5-10x slower in the parallel run than alone. Alone
    (no xdist) the count is unchanged.
    """
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
    yield
    torch.set_num_threads(threads)


def assert_same(a, b):
    """Nested dicts of arrays (or strings) with the same keys in the same order, dtypes, shapes and bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (list(a), list(b))
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, str):
        assert a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b)


def perturb_zero_leaves(params: dict, seed: int, std: float = 0.05) -> dict:
    rng = np.random.default_rng(seed)
    flat = flatten_dict(params)
    for key, value in flat.items():
        value = np.asarray(value)
        if not value.any():
            flat[key] = (std * rng.standard_normal(value.shape)).astype(value.dtype)
    return unflatten_dict(flat)


@functools.lru_cache(maxsize=8)
def _param_shapes(config) -> dict:
    """The flattened shapes of ``config.init_params``'s tree (tracing the init takes half a second)."""
    return flatten_dict(jax.eval_shape(config.init_params, jax.random.key(0)))


def numpy_params(config, seed: int) -> dict:
    """Every leaf of ``config.init_params``'s tree drawn from ``np.random.default_rng(seed)`` (JAX's eager init
    takes seconds on the CPU): matrices and embeddings ~ N(0, 0.05²), biases ~ N(0, 0.02²), SigLIP's LayerNorm
    scales ~ 1 + N(0, 0.1²) and Gemma's RMSNorm scales (applied as 1 + w) ~ N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in _param_shapes(config).items():
        if path.endswith("scale"):
            value = (1.0 if path.startswith("PaliGemma/img") else 0.0) + 0.1 * rng.standard_normal(leaf.shape)
        else:
            value = (0.02 if path.endswith("bias") else 0.05) * rng.standard_normal(leaf.shape)
        flat[path] = value.astype(leaf.dtype)
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


DEBUG_LORA = dict(DEBUG, paligemma_variant="dummy_lora", action_expert_variant="dummy_lora")


def debug_lora_models(seed: int = 0, *, freeze: bool = True, quantize: bool = False, **overrides):
    """(jax config, jax params, torch config, torch model) for LoRA variants at debug size, same weights.

    One JAX init (zero leaves perturbed) feeds both: the base weights through
    ``jax_to_torch_state``, the LoRA factors through the port's
    ``lora_state_from_jax``. With ``freeze`` the frozen leaves are cast to bf16
    on both sides (JAX as ``init_train_state`` does, the port by
    ``freeze_params``), and with ``quantize`` each side then quantizes them to
    int8 with its own ``quantize_frozen_tree``.
    """
    from kai0_tpu.ops import quant as jax_quant
    from kai0_tpu_torch.training import train_lib as torch_train_lib

    jax_config = jax_pi0.Pi0Config(**{**DEBUG_LORA, **overrides})
    params = perturb_zero_leaves(jax_config.init_params(jax.random.key(seed)), seed)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params).items()}
    torch_config = torch_pi0.Pi0Config(**{**DEBUG_LORA, **overrides})
    model = torch_pi0.Pi0(torch_config, device="cpu")
    base = unflatten_dict({k: v for k, v in flat.items() if "lora" not in k})
    torch_interop.load_jax_state(
        model, {**tsf.jax_to_torch_state(base, jax_config), **torch_interop.lora_state_from_jax(flat)}
    )
    if freeze:
        frozen = jax_config.freeze_filter()
        mask = unflatten_dict({k: not frozen(k) for k in flat})
        params = jax.tree.map(lambda p, t: p if t else p.astype(jnp.bfloat16), params, mask)
        if quantize:
            params = jax_quant.quantize_frozen_tree(params, mask)
        torch_train_lib.freeze_params(model, quantize=quantize)
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


def lora_finetune_runs(*, quantize: bool, steps: int = 3, batch: int = 2, seed: int = 0) -> dict:
    """Both packages' LoRA fine-tune at ``dummy_lora`` size in f32 activations, on the same weights, batch and draws.

    The frozen base is bf16 or, with ``quantize``, int8. JAX runs
    ``train_lib.train_step`` jitted (f32 AdamW, EMA 0.99, the cosine schedule
    with a short warmup) with images augmented eagerly by the step's own
    draws; the port's ``train_step`` gets the same draws. Before the steps,
    the loss and the trainable gradients of step 0's draws are taken on both
    sides. Returns everything the tests compare, JAX's trees mapped to the
    port's names.
    """
    import dataclasses
    import functools

    from kai0_tpu.training import optimizer as jax_opt
    from kai0_tpu.training import train_lib as jax_train_lib
    from kai0_tpu.training import utils as jax_utils
    from kai0_tpu_torch.models import model as torch_model
    from kai0_tpu_torch.training import optimizer as torch_opt
    from kai0_tpu_torch.training import train_lib as torch_train_lib

    schedule = dict(peak_lr=1e-3, decay_lr=1e-4, warmup_steps=2, decay_steps=100)
    jax_config, params, _, model = debug_lora_models(seed=seed, quantize=quantize)
    frozen_fn = jax_config.freeze_filter()
    is_leaf = lambda x: hasattr(x, "q")  # noqa: E731  (a QuantArray is one leaf)
    flat_paths = flatten_dict(jax.tree.map(lambda x: 0, params, is_leaf=is_leaf))
    mask = unflatten_dict({k: not frozen_fn(k) for k in flat_paths})
    inputs = model_inputs(seed + 3, batch=batch)
    actions = np.random.default_rng(seed + 4).standard_normal((batch, 50, 32)).astype(np.float32)
    rng = jax.random.key(9)

    @dataclasses.dataclass(frozen=True)
    class PreAugmented:
        def compute_loss(self, p, key, observation, acts, *, train):
            return jax_pi0.compute_loss(p, jax_config, key, observation, acts, train=False)

    @dataclasses.dataclass(frozen=True)
    class JaxTrainConfig:
        model: PreAugmented = PreAugmented()
        param_dtype: str | None = None
        ema_decay: float | None = 0.99

    def to_port_names(tree: dict) -> dict:
        """A JAX tree of trainable leaves (None or absent where frozen) under the port's parameter names."""
        flat = {k: np.asarray(v) for k, v in flatten_dict(tree).items() if v is not None and not hasattr(v, "q")}
        shapes = flatten_dict(jax.eval_shape(jax_config.init_params, jax.random.key(0)))
        base = {k: flat.get(k, np.zeros(s.shape, np.float32)) for k, s in shapes.items() if "lora" not in k}
        state = {**tsf.jax_to_torch_state(unflatten_dict(base), jax_config), **torch_interop.lora_state_from_jax(flat)}
        keep = {n for n, p in model.named_parameters() if p.requires_grad}
        return {k: np.asarray(v, np.float32) for k, v in state.items() if k in keep}

    # loss and trainable gradients at step 0's draws
    trainable, frozen = jax_utils.split_by_mask(params, mask)
    rng0 = jax.random.fold_in(rng, 0)
    augmented0 = jax_augmented_observation(rng0, inputs)

    def loss_fn(tr):
        merged = jax_utils.merge_by_mask(tr, frozen)
        return jnp.mean(jax_pi0.compute_loss(merged, jax_config, rng0, augmented0, jnp.asarray(actions), train=False))

    jax_loss, jax_grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    obs = torch_model.Observation.from_dict(to_torch(inputs))
    model.zero_grad(set_to_none=True)
    loss = model.compute_loss(obs, torch.from_numpy(actions), train=True, **jax_loss_draws(rng0, batch, actions.shape)).mean()
    loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
             for k, p in model.named_parameters() if p.requires_grad}
    model.zero_grad(set_to_none=True)

    # the steps
    tx = jax_opt.create_optimizer(jax_opt.AdamW(), jax_opt.CosineDecaySchedule(**schedule))
    step_fn = jax.jit(functools.partial(jax_train_lib.train_step, JaxTrainConfig(), tx, mask))
    jax_state = jax_utils.TrainState(step=jnp.int32(0), params=params, opt_state=tx.init(trainable), ema_params=params)
    config = torch_train_lib.TrainConfig(lr_schedule=torch_opt.CosineDecaySchedule(**schedule), quantize_frozen=quantize)
    state = torch_train_lib.init_train_state(model, config, device="cpu")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    infos = []
    for i in range(steps):
        step_rng = jax.random.fold_in(rng, i)
        jax_state, jax_info = step_fn(rng, jax_state, (jax_augmented_observation(step_rng, inputs), actions))
        state, info = torch_train_lib.train_step(
            model, state, (obs, torch.from_numpy(actions)), config, **jax_loss_draws(step_rng, batch, actions.shape)
        )
        infos.append(({k: float(v) for k, v in jax_info.items()}, {k: float(v) for k, v in info.items()}))
    return {
        "model": model, "state": state, "before": before, "infos": infos,
        "loss": (float(loss.detach()), float(jax_loss)), "grads": grads, "jax_grads": to_port_names(jax_grads),
        "jax_params": to_port_names(jax_utils.split_by_mask(jax_state.params, mask)[0]),
        "jax_ema": to_port_names(jax_utils.split_by_mask(jax_state.ema_params, mask)[0]),
    }
