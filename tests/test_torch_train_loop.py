"""The port's training loop against the JAX package's ``main``: the steps it logs, and resume.

``train_lib.main(debug_pi05, device="cpu")`` runs 4 steps (saves at steps 2
and 3), then ``resume`` runs 2 more from step 3's checkpoint. Its
``metrics.jsonl`` has the step numbers and keys (``loss``, ``grad_norm``,
``param_norm``, ``steps_per_sec``, beside ``step`` and ``ts``, in JAX's
order) of JAX's ``main`` run for 6 steps on the same config (at batch 8,
which JAX's 8-device test mesh needs); every value is finite, retention
leaves steps 2 and 5, and the run id is kept. The weights differ (each
package draws its own init), so the values are not compared: the step is
held to JAX's by ``tests/test_torch_train_step.py``.
"""

import dataclasses
import json
import os
import pathlib

import numpy as np

from kai0_tpu.training import config as jax_config
from kai0_tpu.training import train_lib as jax_train_lib
from kai0_tpu_torch.training import config as torch_config
from kai0_tpu_torch.training import train_lib


def _metrics(checkpoint_dir) -> list[dict]:
    return [json.loads(line) for line in (pathlib.Path(checkpoint_dir) / "metrics.jsonl").read_text().splitlines()]


def test_main_and_resume_log_the_steps_and_keys_of_jax(tmp_path):
    def config(pkg, **kw):
        return dataclasses.replace(pkg.get_config("debug_pi05"), exp_name="loop", wandb_enabled=True,
                                   checkpoint_base_dir=str(tmp_path / pkg.__name__.split(".")[0]), **kw)

    # JAX's batch must divide over its 8 test devices; it saves only its last step, which the metrics do not see.
    jax_train_lib.main(config(jax_config, num_train_steps=6, batch_size=8, save_interval=100))
    ref = _metrics(config(jax_config).checkpoint_dir)

    cfg = config(torch_config)
    model, state = train_lib.main(cfg, device="cpu")
    assert state.step == 4 and sorted(os.listdir(cfg.checkpoint_dir / "3")) == [
        "model.safetensors", "train_state.json", "train_state.safetensors"]
    run_id = (cfg.checkpoint_dir / "run_id.txt").read_text()
    _, resumed = train_lib.main(dataclasses.replace(cfg, resume=True, num_train_steps=6), device="cpu")
    assert resumed.step == 6 and resumed.opt_state["count"] == 6
    got = _metrics(cfg.checkpoint_dir)
    assert [r["step"] for r in got] == [r["step"] for r in ref] == list(range(6))
    assert [list(r) for r in got] == [list(r) for r in ref]
    assert list(got[0]) == ["step", "ts", "grad_norm", "loss", "param_norm", "steps_per_sec"]
    assert all(np.isfinite(list(r.values())).all() for r in got)
    assert sorted(p.name for p in cfg.checkpoint_dir.iterdir() if p.is_dir()) == ["2", "5"]
    assert (cfg.checkpoint_dir / "run_id.txt").read_text() == run_id
