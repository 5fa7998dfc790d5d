"""Shared set-up of the convergence-probe tests: JAX's ``scripts/check_convergence.py`` against the port's.

JAX's script runs in this process (``main`` with its command line), its
``init_train_state`` wrapped to keep the initial weights. The port's
``scripts/check_convergence_torch.run`` gets those weights (through
``interop.state_from_jax``) and, for each step, the noise, time and
augmentation JAX's jitted step draws: the script steps with
``fold_in(key(seed + 1), i)`` and ``train_step`` folds in the step again.

Both packages' ``get_config("debug")`` are patched to a constant learning
rate, ``LR``: ``debug``'s own schedule warms up over 1,000 steps, so within a
test's few steps its rate stays under 2.5e-7, the parameters hardly move, and
the trajectories would hold the forward pass only. At ``LR`` the loss falls
by about two thirds in 10 steps at batch 1, so a wrong update shows.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys

import jax
import numpy as np

from _torch_parity import jax_loss_draws
from kai0_tpu.training import config as jax_config
from kai0_tpu.training import optimizer as jax_optimizer
from kai0_tpu.training import train_lib as jax_train_lib
from kai0_tpu.transforms import flatten_dict
from kai0_tpu_torch import interop
from kai0_tpu_torch.models import model as torch_model
from kai0_tpu_torch.training import config as torch_config
from kai0_tpu_torch.training import optimizer as torch_optimizer

REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = 0
LR = 1e-3


def constant_learning_rate(monkeypatch, lr: float = LR) -> None:
    """Both packages' configs with ``lr`` at every step: their cosine schedules with no warmup and ``decay_lr`` =
    ``peak_lr``."""
    for module, schedule in ((jax_config, jax_optimizer.CosineDecaySchedule),
                             (torch_config, torch_optimizer.CosineDecaySchedule)):
        def get_config(name, get=module.get_config, schedule=schedule):
            return dataclasses.replace(get(name), lr_schedule=schedule(peak_lr=lr, decay_lr=lr, warmup_steps=0))

        monkeypatch.setattr(module, "get_config", get_config)


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"convergence_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def trajectories(monkeypatch, capsys, *, steps: int, batch: int) -> tuple[list[float], list[float]]:
    """(JAX's losses, the port's) of the ``--full-ft`` arm at ``LR`` under the environment the caller set."""
    constant_learning_rate(monkeypatch)
    kept = {}
    init = jax_train_lib.init_train_state

    def keep(*args, **kwargs):
        out = init(*args, **kwargs)
        kept["params"] = out[0].params
        return out

    monkeypatch.setattr(jax_train_lib, "init_train_state", keep)
    monkeypatch.setattr(sys, "argv", ["check_convergence.py", "--steps", str(steps), "--batch-size", str(batch),
                                      "--seed", str(SEED), "--full-ft"])
    load_script("check_convergence").main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    port = load_script("check_convergence_torch")
    config = port.probe_config(full_ft=True, batch_size=batch, seed=SEED)
    flat = {k: np.asarray(v) for k, v in flatten_dict(kept["params"]).items()}
    state = interop.state_from_jax(flat, torch_model.model_class(config.model)(config.model, device="cpu"))
    shape = (batch, config.model.action_horizon, config.model.action_dim)
    draws = [jax_loss_draws(jax.random.fold_in(jax.random.fold_in(jax.random.key(SEED + 1), i), i), batch, shape)
             for i in range(steps)]
    got = port.run(config, steps, device="cpu", state=state, draws=draws)
    return want, got
