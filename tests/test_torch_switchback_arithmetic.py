"""SwitchBack in the port's Model Arithmetic ensemble, against the JAX package's.

JAX's models read ``KAI0_INT8_SB_GEMMA`` when they trace, so its
``DeviceEnsemble`` runs the Gemma FFN by SwitchBack whenever the variable
selects it; the port's ``Ensemble`` installs ``ops/quant.switchback_tree``
from the environment. The variable is set with ``monkeypatch`` before either
package builds or traces.

Three ``debug_pi05`` checkpoints (f32 activations) as fine-tunes of one
numpy-seeded base (``_torch_ensembles``), one batch of 1, JAX's key-0 draws
handed to the port. Vertex losses and the loss at a non-vertex within 1e-5
relative (the bf16 ensemble's bar), dL/dw within 1e-3 x max (ten times the
bf16 bar: each SwitchBack product is bit-equal to JAX's, but an activation
code can flip on f32 rounding through the model; measured 2.1e-7 and 1.3e-5 x
max). Under SwitchBack the losses differ from the bf16 ensemble's.
"""

import jax
import numpy as np
import pytest

from _torch_ensembles import ensembles, key0_flow_draws
from _torch_parity import DEBUG, model_inputs
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.models import model as jax_model
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu_torch import knobs
from kai0_tpu_torch.arithmetic import core
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.ops import quant

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-3


@pytest.fixture(autouse=True)
def _sb_gemma_ffn(monkeypatch):
    for name in knobs.ENV.values():
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KAI0_INT8_SB_GEMMA", "ffn")


def test_switchback_ensemble_matches_jax(tmp_path, monkeypatch):
    paths, ensemble, jax_ensemble = ensembles(tmp_path, jax_pi0.Pi0Config(**DEBUG), torch_pi0.Pi0Config(**DEBUG),
                                              monkeypatch)
    assert sum(quant.is_switchback(m) for m in ensemble.model.modules()) == 2 * 4 * 3  # both experts' FFNs
    inputs = model_inputs(7, batch=1)
    actions = np.random.default_rng(8).standard_normal((1, 50, 32)).astype(np.float32)
    batches = ensemble.stage([(inputs, actions)], draws=[key0_flow_draws(actions.shape)])
    jax_batches = [(jax.tree.map(np.asarray, jax_model.Observation.from_dict(inputs)), actions)]
    got, want = ensemble.checkpoint_losses(batches), jax_ensemble.checkpoint_losses(jax_batches)
    weights = [0.2, 0.5, 0.3]
    loss, grad = ensemble.loss_and_weight_grad(weights, batches)
    jax_loss, jax_grad = jax_ensemble.loss_and_weight_grad(weights, jax_batches)
    vertex_err = max(abs(a - b) / abs(b) for a, b in zip(got, want, strict=True))
    grad_err = float(np.abs(grad - jax_grad).max() / np.abs(jax_grad).max())
    print(f"SwitchBack ensemble: vertex losses relative {vertex_err:.3e}, loss {abs(loss - jax_loss) / jax_loss:.3e}, "
          f"dL/dw {grad_err:.3e} x max (f32 activations, batch 1)")
    assert vertex_err <= LOSS_RTOL and abs(loss - jax_loss) <= LOSS_RTOL * abs(jax_loss)
    assert grad_err <= GRAD_TOL
    monkeypatch.setenv("KAI0_INT8_SB_GEMMA", "0")
    plain = core.Ensemble(paths, torch_pi0.Pi0Config(**DEBUG), device="cpu")
    plain_losses = plain.checkpoint_losses(plain.stage([(inputs, actions)], draws=[key0_flow_draws(actions.shape)]))
    assert not any(quant.is_switchback(m) for m in plain.model.modules())
    assert max(abs(a - b) for a, b in zip(got, plain_losses, strict=True)) > 1e-6

