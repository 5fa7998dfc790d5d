"""The port's advantage estimator against ``kai0_tpu.models.advantage`` on the same weights and draws.

Debug size (``dummy``/``dummy`` Gemma, ``mu/14`` SigLIP, f32, π₀.₅, 48 prompt
tokens as ``debug_pi05``) with numpy-seeded weights (``_numpy_params``), batch 2, both loss weights non-zero (0.5 and 1) so
that both terms reach every gradient. Each observation also carries the three
history cameras (``*_-100_rgb``), which both packages drop, and a progress
target partly outside [-1, 1], which both clamp. JAX's draws (noise, then
time, from its key's splits) are handed to the port.

- ``compute_loss_and_aux`` (JAX's jitted): the loss [B, H] and both aux means within 1e-5 x
  max(1, |x|); every parameter gradient, the value head's included, within
  1e-4 x max(its max abs, 1e-5).
- ``sample_values`` within 1e-5.
- One ``train_step`` of both packages (f32 AdamW, EMA; JAX's jitted): loss and grad_norm
  within 1e-5 relative, the value head's parameters after the step within
  1e-5 x their change.
- Weights JAX → port → JAX bit-equal; a ``model.safetensors`` written by
  ``kai0_tpu.interop`` (``value_head.{0,2,4}``) read by the port and one written
  by the port read by ``kai0_tpu.interop``, bit-equal.
- A π₀.₅ checkpoint without a value head: both packages'
  ``CheckpointWeightLoader`` + validation refuse it, naming the value head's
  keys (a π₀.₅ base checkpoint cannot start an estimator in either package).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DEBUG, model_inputs, to_torch
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import advantage as jax_advantage
from kai0_tpu.models import model as jax_model
from kai0_tpu.training import optimizer as jax_opt
from kai0_tpu.training import train_lib as jax_train_lib
from kai0_tpu.training import utils as jax_utils
from kai0_tpu.transforms import flatten_dict, unflatten_dict
from kai0_tpu_torch import interop, param_paths
from kai0_tpu_torch.models import advantage
from kai0_tpu_torch.models import model as torch_model
from kai0_tpu_torch.training import optimizer as opt
from kai0_tpu_torch.training import train_lib

BATCH = 2
CONFIG = dict(DEBUG, max_token_len=48, discrete_state_input=False, loss_action_weight=0.5, loss_value_weight=1.0)
HISTORY = ("base_-100_rgb", "left_wrist_-100_rgb", "right_wrist_-100_rgb")
SCHEDULE = dict(peak_lr=1e-3, decay_lr=1e-4, warmup_steps=2, decay_steps=100)


def _inputs(seed: int) -> dict:
    inputs = model_inputs(seed, batch=BATCH)
    rng = np.random.default_rng(seed + 100)
    for key in HISTORY:
        inputs["image"][key] = rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
        inputs["image_mask"][key] = np.ones(BATCH, bool)
    inputs["progress"] = np.asarray([0.4, -1.3], np.float32)[:BATCH]
    inputs["episode_index"] = np.arange(BATCH, dtype=np.int32)
    inputs["frame_index"] = np.arange(BATCH, dtype=np.int32) + 3
    inputs["episode_length"] = np.full(BATCH, 12, np.int32)
    return inputs


def _loss_draws(rng, batch: int) -> dict:
    _, noise_rng, time_rng = jax.random.split(rng, 3)
    noise = jax.random.normal(noise_rng, (batch, 50, 32))
    time = jax.random.beta(time_rng, 1.5, 1, (batch,)) * 0.999 + 0.001
    return {"noise": to_torch(noise), "time": to_torch(time)}


def _numpy_params(config, seed: int) -> dict:
    """Every leaf of ``config.init_params``'s tree drawn from ``np.random.default_rng(seed)`` (JAX's eager init
    takes 9 s on the CPU): matrices and embeddings ~ N(0, 0.05²), biases ~ N(0, 0.02²), SigLIP's LayerNorm scales ~
    1 + N(0, 0.1²) and Gemma's RMSNorm scales (applied as 1 + w) ~ N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in flatten_dict(jax.eval_shape(config.init_params, jax.random.key(0))).items():
        if path.endswith("scale"):
            value = (1.0 if path.startswith("PaliGemma/img") else 0.0) + 0.1 * rng.standard_normal(leaf.shape)
        else:
            value = (0.02 if path.endswith("bias") else 0.05) * rng.standard_normal(leaf.shape)
        flat[path] = value.astype(leaf.dtype)
    return unflatten_dict(flat)


@pytest.fixture(scope="module")
def models():
    jax_config = jax_advantage.AdvantageEstimatorConfig(**CONFIG)
    params = _numpy_params(jax_config, seed=0)
    model = advantage.AdvantageEstimator(advantage.AdvantageEstimatorConfig(**CONFIG), device="cpu")
    interop.load_jax_state(model, tsf.jax_to_torch_state(params, jax_config))
    return jax_config, params, model


@pytest.fixture(scope="module")
def loss_setup(models):
    jax_config, params, model = models
    inputs = _inputs(1)
    actions = np.random.default_rng(2).standard_normal((BATCH, 50, 32)).astype(np.float32)
    rng = jax.random.key(5)
    obs = jax_model.Observation.from_dict(inputs)

    def loss_fn(p):
        loss, aux = jax_advantage.compute_loss_and_aux(p, jax_config, rng, obs, jnp.asarray(actions))
        return jnp.mean(loss), (loss, aux)

    (_, (loss, aux)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model.zero_grad(set_to_none=True)
    got, got_aux = model.compute_loss_and_aux(
        torch_model.Observation.from_dict(to_torch(inputs)), torch.from_numpy(actions), **_loss_draws(rng, BATCH)
    )
    got.mean().backward()
    got_grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
                 for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    want = (np.asarray(loss), {k: float(v) for k, v in aux.items()}, tsf.jax_to_torch_state(grads, jax_config))
    return want, (got.detach().numpy(), {k: float(v.detach()) for k, v in got_aux.items()}, got_grads)


def test_loss_and_aux_match(loss_setup):
    (want, want_aux, _), (got, got_aux, _) = loss_setup
    assert got.shape == want.shape == (BATCH, 50) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    assert set(got_aux) == set(want_aux) == {"loss_action", "loss_value"}
    for k, v in want_aux.items():
        assert abs(got_aux[k] - v) <= 1e-5 * max(1.0, abs(v)), (k, got_aux[k], v)
    assert want_aux["loss_value"] > 0 and want_aux["loss_action"] > 0


def test_every_gradient_matches_including_the_value_head(loss_setup):
    (_, _, want), (_, _, got) = loss_setup
    assert set(got) == set(want)
    assert {f"value_head.{i}.{p}" for i in (0, 2, 4) for p in ("weight", "bias")} <= set(got)
    for key, g in got.items():
        ref = np.asarray(want[key], dtype=np.float32)
        assert g.shape == ref.shape, key
        assert np.abs(g - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1e-5), (key, np.abs(g - ref).max())
    assert all(np.abs(got[f"value_head.{i}.weight"]).max() > 1e-6 for i in (0, 2, 4))


def test_sample_values_match(models):
    jax_config, params, model = models
    inputs = _inputs(7)
    rng = jax.random.key(0)
    want = np.asarray(jax.jit(functools.partial(jax_advantage.sample_values, config=jax_config))(
        params, rng=rng, observation=jax_model.Observation.from_dict(inputs)))
    noise_rng, time_rng = jax.random.split(rng)
    noise = to_torch(jax.random.normal(noise_rng, (BATCH, 50, 32)))
    time = to_torch(jax.random.beta(time_rng, 1.5, 1, (BATCH,)) * 0.999 + 0.001)
    got = model.sample_values(torch_model.Observation.from_dict(to_torch(inputs)), noise=noise, time=time).numpy()
    assert got.shape == want.shape == (BATCH, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got).max() < 1
    # Drawn from the generator: the same seed gives the same values.
    obs = torch_model.Observation.from_dict(to_torch(inputs))
    a, b = (model.sample_values(obs, generator=torch.Generator().manual_seed(0)) for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_one_train_step_matches_jax(models):
    jax_config, params, _ = models
    model = advantage.AdvantageEstimator(advantage.AdvantageEstimatorConfig(**CONFIG), device="cpu")
    interop.load_jax_state(model, tsf.jax_to_torch_state(params, jax_config))
    inputs = _inputs(3)
    actions = np.random.default_rng(4).standard_normal((BATCH, 50, 32)).astype(np.float32)
    rng = jax.random.key(9)

    @dataclasses.dataclass(frozen=True)
    class JaxConfig:
        model: object
        param_dtype: str | None = None
        ema_decay: float | None = 0.99

    tx = jax_opt.create_optimizer(jax_opt.AdamW(), jax_opt.CosineDecaySchedule(**SCHEDULE))
    mask = jax.tree.map(lambda _: True, params)
    step_fn = jax.jit(functools.partial(jax_train_lib.train_step, JaxConfig(jax_config), tx, mask))
    jax_state = jax_utils.TrainState(step=jnp.int32(0), params=params, opt_state=tx.init(params), ema_params=params)
    jax_state, jax_info = step_fn(rng, jax_state, (jax_model.Observation.from_dict(inputs), actions))

    config = train_lib.TrainConfig(lr_schedule=opt.CosineDecaySchedule(**SCHEDULE))
    state = train_lib.init_train_state(model, config, device="cpu")
    before = {k: p.detach().clone() for k, p in state.params.items()}
    obs = torch_model.Observation.from_dict(to_torch(inputs))
    state, info = train_lib.train_step(model, state, (obs, torch.from_numpy(actions)), config,
                                       **_loss_draws(jax.random.fold_in(rng, 0), BATCH))
    for k in ("loss", "grad_norm"):
        assert abs(float(info[k]) - float(jax_info[k])) <= 1e-5 * max(1.0, abs(float(jax_info[k]))), k
    want = tsf.jax_to_torch_state(jax_state.params, jax_config)
    for key in (f"value_head.{i}.{p}" for i in (0, 2, 4) for p in ("weight", "bias")):
        start = before[key].numpy().astype(np.float64)
        ref = np.asarray(want[key], np.float64) - start
        got = state.params[key].detach().numpy().astype(np.float64) - start
        assert np.abs(ref).max() > 0, key
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max() + 4 * np.finfo(np.float32).eps * np.abs(start).max()


def test_weights_cross_both_ways_bit_equal(models, tmp_path):
    jax_config, params, model = models
    back = tsf.torch_state_to_jax({k: v.numpy() for k, v in model.state_dict().items()}, jax_config)
    flat, flat_back = flatten_dict(params), flatten_dict(back)
    assert set(flat) == set(flat_back) and {"value_head/Dense_0/kernel", "value_head/Dense_2/bias"} <= set(flat)
    head = [name for name, _ in model.named_parameters() if name.startswith("value_head.")]
    assert len(head) == 6 and {param_paths.jax_param_path(name) for name in head} <= set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[k]), np.asarray(v), err_msg=k)

    # model.safetensors: JAX writes, the port reads; the port writes, JAX reads.
    tsf.save_torch_checkpoint(params, jax_config, tmp_path / "jax")
    port = advantage.AdvantageEstimator(advantage.AdvantageEstimatorConfig(**CONFIG), device="cpu")
    interop.load_torch_checkpoint(port, tmp_path / "jax")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=0, atol=0, msg=k)
    interop.save_torch_checkpoint(model, tmp_path / "port")
    header = interop.read_safetensors(tmp_path / "port" / interop.CHECKPOINT_FILE)
    assert {"value_head.0.weight", "value_head.2.weight", "value_head.4.weight", "value_head.4.bias"} <= set(header)
    read = flatten_dict(tsf.load_torch_checkpoint(tmp_path / "port", jax_config))
    assert set(read) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(read[k]), np.asarray(v), err_msg=k)


def test_a_pi05_checkpoint_without_value_head_is_refused_by_both(models, tmp_path):
    import orbax.checkpoint as ocp

    from kai0_tpu.training import weight_loaders as jax_weight_loaders
    from kai0_tpu_torch.models import pi0 as torch_pi0
    from kai0_tpu_torch.training import weight_loaders

    jax_config, params, _ = models
    base = {k: v for k, v in params.items() if k != "value_head"}
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(tmp_path / "jax" / "params", {"params": jax.tree.map(np.asarray, base)})
    shapes = jax.eval_shape(jax_config.init_params, jax.random.key(0))
    with pytest.raises(ValueError, match=r"Missing keys \(6\).*value_head") as jax_err:
        jax_train_lib._load_weights_and_validate(
            jax_weight_loaders.CheckpointWeightLoader(str(tmp_path / "jax" / "params")), shapes)

    pi05 = torch_pi0.Pi0(torch_pi0.Pi0Config(**{k: v for k, v in CONFIG.items() if not k.startswith("loss_")}),
                         device="cpu")
    interop.save_torch_checkpoint(pi05, tmp_path / "port")
    estimator = advantage.AdvantageEstimator(advantage.AdvantageEstimatorConfig(**CONFIG), device="cpu")
    with pytest.raises(ValueError, match=r"Missing keys \(6\).*value_head") as port_err:
        train_lib._load_weights_and_validate(weight_loaders.CheckpointWeightLoader(str(tmp_path / "port")), estimator)
    assert "value_head/Dense_0" in str(jax_err.value) and "value_head.0.weight" in str(port_err.value)
