"""The port's Model Arithmetic over advantage-estimator checkpoints against ``kai0_tpu.arithmetic.core``.

Three dummy estimators (``debug_pi05``'s model with the value head, 48
tokens, f32) as fine-tunes of one numpy-seeded base (``_torch_ensembles``),
written as the port's ``model.safetensors``, which JAX's ``DeviceEnsemble``
reads with its own reader (the value-head sites). One batch of 2 with the
history cameras and a progress target partly outside [-1, 1]. JAX draws noise
and time from ``jax.random.key(0)`` on every evaluation; the port is handed
those draws. Tolerances as ``test_torch_arithmetic.py``: losses within 1e-5
relative, dL/dw within 1e-4 x max, 2 iterations of gradient descent and the
mixing script's (2 iterations) within 1e-5.
"""

import dataclasses
import pathlib
import pickle
import sys

import jax
import numpy as np
import pytest

from _torch_ensembles import Kept, fine_tunes, key0_flow_draws
from _torch_parity import DEBUG, model_inputs
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.arithmetic import core as jax_core
from kai0_tpu.models import advantage as jax_advantage
from kai0_tpu.models import model as jax_model
from kai0_tpu.parallel import sharding as jax_sharding
from kai0_tpu_torch import interop
from kai0_tpu_torch.arithmetic import core
from kai0_tpu_torch.models import advantage
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.training import config as torch_config

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
import model_arithmetic_torch as torch_cli  # noqa: E402

BATCH = 2
CONFIG = dict(DEBUG, max_token_len=48, discrete_state_input=False, loss_action_weight=0.5, loss_value_weight=1.0)
HISTORY = ("base_-100_rgb", "left_wrist_-100_rgb", "right_wrist_-100_rgb")


def _inputs(seed: int) -> dict:
    inputs = model_inputs(seed, batch=BATCH)
    rng = np.random.default_rng(seed + 100)
    for key in HISTORY:
        inputs["image"][key] = rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
        inputs["image_mask"][key] = np.ones(BATCH, bool)
    inputs["progress"] = np.asarray([0.4, -1.3], np.float32)
    return inputs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("estimator")
    jax_config, model_config = jax_advantage.AdvantageEstimatorConfig(**CONFIG), advantage.AdvantageEstimatorConfig(
        **CONFIG)
    paths = []
    for k, flat in enumerate(fine_tunes(jax_config)):
        model = advantage.AdvantageEstimator(model_config, device="cpu")
        interop.load_jax_state(model, interop.state_from_jax(flat, model))
        paths.append(str(interop.save_torch_checkpoint(model, root / f"ckpt_{k}").parent))
    mesh = jax_sharding.make_mesh(1, devices=jax.devices()[:1])
    jax_ensemble = Kept(jax_core.DeviceEnsemble(paths, jax_config, mesh=mesh))
    ensemble = core.Ensemble(paths, model_config, device="cpu")
    inputs = _inputs(7)
    actions = np.random.default_rng(8).standard_normal((BATCH, 50, 32)).astype(np.float32)
    draws = key0_flow_draws(actions.shape)
    return dict(paths=paths, ensemble=ensemble, jax_ensemble=jax_ensemble, inputs=inputs, actions=actions,
                draws=draws, batches=ensemble.stage([(inputs, actions)], draws=[draws]),
                jax_batches=[(jax.tree.map(np.asarray, jax_model.Observation.from_dict(inputs)), actions)],
                model_config=model_config)


def test_estimator_ensemble_losses_and_weight_gradient_match_jax(setup):
    ensemble, jax_ensemble = setup["ensemble"], setup["jax_ensemble"]
    assert isinstance(ensemble.model, advantage.AdvantageEstimator)
    got, want = ensemble.checkpoint_losses(setup["batches"]), jax_ensemble.checkpoint_losses(setup["jax_batches"])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    weights = [0.2, 0.5, 0.3]
    loss, grad = ensemble.loss_and_weight_grad(weights, setup["batches"])
    jax_loss, jax_grad = jax_ensemble.loss_and_weight_grad(weights, setup["jax_batches"])
    print(f"estimator ensemble: loss {loss:.7f} / {jax_loss:.7f}, dL/dw {grad.tolist()} / "
          f"{np.asarray(jax_grad).tolist()}")
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-5)
    np.testing.assert_allclose(grad, jax_grad, rtol=0, atol=1e-4 * np.abs(jax_grad).max())
    assert np.abs(jax_grad).min() > 0


def test_estimator_gradient_descent_and_the_mixing_script_match_jax(setup, tmp_path, monkeypatch):
    kwargs = dict(num_iterations=2, learning_rate=0.05)
    want = jax_core.optimize_weights_gradient_descent(setup["jax_ensemble"], setup["jax_batches"], **kwargs)
    got = core.optimize_weights_gradient_descent(setup["ensemble"], setup["batches"], **kwargs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    config = dataclasses.replace(torch_config.get_config("ADVANTAGE_TORCH_KAI0_FLATTEN_FOLD"),
                                 model=setup["model_config"])
    monkeypatch.setattr(torch_config, "get_config", lambda name: config)
    monkeypatch.setattr(torch_pi0, "draw_noise_and_time", lambda *args, **kwargs: setup["draws"])
    with open(tmp_path / "val.pkl", "wb") as f:
        pickle.dump([(setup["inputs"], setup["actions"])], f)
    script = torch_cli.main(["--checkpoints", *setup["paths"], "--output", str(tmp_path / "mixed"),
                             "--optimize_method", "gradient_descent", "--config", "ADVANTAGE_TORCH_KAI0_FLATTEN_FOLD",
                             "--data-path", str(tmp_path / "val.pkl"), "--num_iterations", "2", "--device", "cpu"])
    np.testing.assert_allclose(script, want, rtol=0, atol=1e-5)
    mixed = interop.read_safetensors(tmp_path / "mixed" / "model.safetensors")
    assert {f"value_head.{i}.weight" for i in (0, 2, 4)} <= set(mixed)
