"""The port's convergence probe against the JAX package's: the SwitchBack ``--full-ft`` arm.

``KAI0_INT8_SB_GEMMA=ffn`` (the Gemma FFN by the fused SwitchBack op in both
packages) on ``scripts/check_convergence_torch.py``'s configuration at a
constant learning rate of 1e-3, from JAX's initial weights and with JAX's
per-step draws (``_torch_convergence``), 10 steps at batch 1. The loss must
fall by over 10 times the tolerance, and every step's loss lie within 2e-2
relative of JAX's script's: bf16 activations round differently in XLA and
torch, and on top an activation code flips now and then on that rounding.
"""

import numpy as np

from _torch_convergence import trajectories
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu_torch import knobs

STEPS, BATCH, RTOL = 10, 1, 2e-2


def test_switchback_full_ft_trajectory_matches_the_jax_script(monkeypatch, capsys):
    for name in knobs.ENV.values():
        monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("KAI0_INT8", raising=False)
    monkeypatch.delenv("KAI0_OPT_STATE", raising=False)
    monkeypatch.setenv("KAI0_INT8_SB_GEMMA", "ffn")
    want, got = trajectories(monkeypatch, capsys, steps=STEPS, batch=BATCH)
    assert want["sb_gemma"] and not want["sb"]
    rel = np.abs(np.asarray(got) - want["losses"]) / np.abs(want["losses"])
    print(f"SwitchBack --full-ft: JAX {want['losses']}\n  port {got}\n  relative {rel.max():.3e} max, "
          f"{rel.mean():.3e} mean")
    assert len(got) == STEPS and np.isfinite(got).all()
    assert (want["losses"][0] - min(want["losses"])) / want["losses"][0] > 10 * RTOL, want["losses"]
    assert rel.max() <= RTOL, rel
