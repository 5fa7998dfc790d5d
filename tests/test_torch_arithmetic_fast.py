"""The port's Model Arithmetic over π₀-FAST checkpoints against ``kai0_tpu.arithmetic.core.DeviceEnsemble``.

Three dummy π₀-FAST checkpoints (``dummy`` Gemma, ``mu/14`` SigLIP, f32, 8-dim
actions, 48 tokens) as fine-tunes of one numpy-seeded base
(``_torch_ensembles``), one batch of 2 with next-token targets on 6 tokens a
row. FAST's loss draws nothing, so the port's batches carry no noise or time.
Tolerances (as ``test_torch_arithmetic.py`` holds π₀.₅): vertex losses and the
loss at a non-vertex within 1e-5 relative, dL/dw within 1e-4 x max, 2
iterations of gradient descent within 1e-5, and ``scripts/model_arithmetic_torch.py
--optimize_method gradient_descent`` on the config for 2 iterations within 1e-5
of JAX's ``optimize_weights_gradient_descent`` (its evaluations kept by weight).
"""

import dataclasses
import pathlib
import sys

import jax
import numpy as np
import pytest

from _torch_ensembles import ensembles
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.arithmetic import core as jax_core
from kai0_tpu.models import model as jax_model
from kai0_tpu.models import pi0_fast as jax_fast
from kai0_tpu_torch.arithmetic import core
from kai0_tpu_torch.models import pi0_fast
from kai0_tpu_torch.training import config as torch_config

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
import model_arithmetic_torch as torch_cli  # noqa: E402

TOKENS, BATCH = 48, 2
FAST = dict(paligemma_variant="dummy", vision_variant="mu/14", dtype="float32", action_dim=8, action_horizon=10,
            max_token_len=TOKENS)


def _inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    used = (20, 31)
    mask = np.zeros((BATCH, TOKENS), bool)
    ar = np.zeros((BATCH, TOKENS), np.int32)
    for b in range(BATCH):
        mask[b, : used[b]] = True
        ar[b, used[b] - 6 : used[b]] = 1
    tokens = rng.integers(2, 257_152, (BATCH, TOKENS), dtype=np.int32)
    return {
        "image": {k: rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8) for k in pi0_fast.FAST_IMAGE_KEYS},
        "image_mask": {k: np.ones(BATCH, bool) for k in pi0_fast.FAST_IMAGE_KEYS},
        "state": rng.standard_normal((BATCH, 8)).astype(np.float32),
        "tokenized_prompt": np.where(mask, tokens, 0).astype(np.int32),
        "tokenized_prompt_mask": mask,
        "token_ar_mask": ar,
        "token_loss_mask": ar.astype(bool),
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        paths, ensemble, jax_ensemble = ensembles(tmp_path_factory.mktemp("fast"), jax_fast.Pi0FASTConfig(**FAST),
                                                  pi0_fast.Pi0FASTConfig(**FAST), mp)
    inputs = _inputs(5)
    actions = np.zeros((BATCH, 10, 8), np.float32)
    batches = ensemble.stage([(inputs, actions)])
    jax_batches = [(jax.tree.map(np.asarray, jax_model.Observation.from_dict(inputs)), actions)]
    return dict(paths=paths, ensemble=ensemble, jax_ensemble=jax_ensemble, batches=batches, jax_batches=jax_batches,
                inputs=inputs, actions=actions)


def test_fast_ensemble_losses_and_weight_gradient_match_jax(setup):
    ensemble, jax_ensemble = setup["ensemble"], setup["jax_ensemble"]
    assert isinstance(ensemble.model, pi0_fast.Pi0FAST)
    assert all(b.noise is None and b.time is None for b in setup["batches"])
    got, want = ensemble.checkpoint_losses(setup["batches"]), jax_ensemble.checkpoint_losses(setup["jax_batches"])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert min(abs(a - b) for i, a in enumerate(want) for b in want[i + 1:]) > 1e-4 * max(want)
    weights = [0.2, 0.5, 0.3]
    loss, grad = ensemble.loss_and_weight_grad(weights, setup["batches"])
    jax_loss, jax_grad = jax_ensemble.loss_and_weight_grad(weights, setup["jax_batches"])
    print(f"FAST ensemble: loss {loss:.7f} / {jax_loss:.7f}, dL/dw {grad.tolist()} / {np.asarray(jax_grad).tolist()}")
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-5)
    np.testing.assert_allclose(grad, jax_grad, rtol=0, atol=1e-4 * np.abs(jax_grad).max())
    assert np.abs(jax_grad).min() > 0


def test_fast_gradient_descent_matches_jax(setup):
    kwargs = dict(num_iterations=2, learning_rate=0.05)
    got = core.optimize_weights_gradient_descent(setup["ensemble"], setup["batches"], **kwargs)
    want = jax_core.optimize_weights_gradient_descent(setup["jax_ensemble"], setup["jax_batches"], **kwargs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_fast_mixing_script_gradient_descent_matches_jax(setup, tmp_path, monkeypatch):
    import pickle

    config = dataclasses.replace(torch_config.get_config("pi0_fast_libero"), model=pi0_fast.Pi0FASTConfig(**FAST))
    monkeypatch.setattr(torch_config, "get_config", lambda name: config)
    with open(tmp_path / "val.pkl", "wb") as f:
        pickle.dump([(setup["inputs"], setup["actions"])], f)
    got = torch_cli.main(["--checkpoints", *setup["paths"], "--output", str(tmp_path / "mixed"), "--optimize_method",
                          "gradient_descent", "--config", "pi0_fast_libero", "--data-path", str(tmp_path / "val.pkl"),
                          "--num_iterations", "2", "--device", "cpu"])
    want = jax_core.optimize_weights_gradient_descent(setup["jax_ensemble"], setup["jax_batches"], num_iterations=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (tmp_path / "mixed" / "model.safetensors").exists()
