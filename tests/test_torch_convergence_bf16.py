"""The port's convergence probe against the JAX package's: the bf16 ``--full-ft`` arm, and ``--compare``.

``scripts/check_convergence_torch.py``'s configuration (``debug``'s π₀ at
``dummy`` size, bf16 activations, f32 parameters, AdamW, a fixed batch of
ones) at a constant learning rate of 1e-3 in both packages, from JAX's
initial weights and with JAX's per-step draws (``_torch_convergence``), 10
steps at batch 1 (JAX's script takes about 23 s for them, its jit included).
The loss must fall by over 10 times the tolerance, and every step's loss lie
within 1e-2 relative of JAX's script's: bf16 activations round differently in
XLA and torch, and the difference feeds the next step.

``--compare`` of the on-chip scripts on two fixed JSON files: the port's
output byte-equal to ``check_convergence_onchip.py``'s.
"""

import json

import numpy as np
import pytest

from _torch_convergence import load_script, trajectories
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu_torch import knobs

STEPS, BATCH, RTOL = 10, 1, 1e-2


def test_bf16_full_ft_trajectory_matches_the_jax_script(monkeypatch, capsys):
    for name in knobs.ENV.values():
        monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("KAI0_INT8", raising=False)
    monkeypatch.delenv("KAI0_OPT_STATE", raising=False)
    want, got = trajectories(monkeypatch, capsys, steps=STEPS, batch=BATCH)
    assert not want["sb_gemma"] and not want["int8"]
    rel = np.abs(np.asarray(got) - want["losses"]) / np.abs(want["losses"])
    print(f"bf16 --full-ft: JAX {want['losses']}\n  port {got}\n  relative {rel.max():.3e} max, {rel.mean():.3e} mean")
    assert len(got) == STEPS and np.isfinite(got).all()
    assert (want["losses"][0] - min(want["losses"])) / want["losses"][0] > 10 * RTOL, want["losses"]
    assert rel.max() <= RTOL, rel


@pytest.mark.parametrize("steps", [9, 30])
def test_compare_is_byte_equal_to_the_jax_script(tmp_path, capsys, steps):
    rng = np.random.default_rng(steps)
    paths = []
    for label in ("sb", "bf16"):
        losses = (3.0 - np.linspace(0, 1, steps) + 0.05 * rng.standard_normal(steps)).round(6).tolist()
        paths.append(tmp_path / f"{label}.json")
        paths[-1].write_text(json.dumps({"label": label, "losses": losses}))
    outputs = []
    for name in ("check_convergence_onchip", "check_convergence_onchip_torch"):
        assert load_script(name).compare(*map(str, paths)) == 0
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1]
    assert set(json.loads(outputs[1])) == {"a", "b", "steps", "max_rel_diff", "mean_rel_diff", "final_tail_mean",
                                           "rel_diff_by_third"}
