"""A/B convergence probe of the port: N train steps of the dummy-size ``debug`` model, the per-step losses as JSON.

The port's ``scripts/check_convergence.py``, with its arguments, environment
and output keys. Run it twice with different environments (``KAI0_INT8=1``,
``KAI0_INT8_SB=1``, ``KAI0_INT8_SB_GEMMA=ffn`` or ``KAI0_OPT_STATE=bfloat16``
against unset) and compare the trajectories:

    python3 scripts/check_convergence_torch.py --steps 30 --full-ft --device cpu
    KAI0_INT8_SB_GEMMA=ffn python3 scripts/check_convergence_torch.py --steps 30 --full-ft --device cpu

The configuration is ``debug``'s (π₀, ``mu/14`` SigLIP) with ``dummy_lora``
Gemma experts, or ``dummy`` under ``--full-ft`` (every parameter trains), bf16
activations, f32 parameters, AdamW, on one fixed batch of ones. The model's
weights are drawn from ``--seed``, each step's noise, time and augmentation
from ``--seed`` + 1 and the step. The card runs it unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from kai0_tpu_torch import interop as _interop  # noqa: E402
from kai0_tpu_torch import knobs as _knobs  # noqa: E402
from kai0_tpu_torch.models import model as _model  # noqa: E402
from kai0_tpu_torch.ops import quant as _quant  # noqa: E402
from kai0_tpu_torch.training import config as _config  # noqa: E402
from kai0_tpu_torch.training import optimizer as _optimizer  # noqa: E402
from kai0_tpu_torch.training import train_lib  # noqa: E402


def env_flag(name: str, default: str = "0") -> bool:
    """A boolean environment variable, as ``kai0_tpu.ops.quant.env_flag`` reads it."""
    return os.environ.get(name, default).lower() not in ("0", "false", "off", "no", "")


def probe_config(*, full_ft: bool, batch_size: int, seed: int = 0) -> _config.TrainConfig:
    """``debug`` at dummy size with bf16 activations, the int8 base under ``KAI0_INT8``, the AdamW moments' storage
    under ``KAI0_OPT_STATE``."""
    base = _config.get_config("debug")
    variant = "dummy" if full_ft else "dummy_lora"
    cfg = dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, paligemma_variant=variant, action_expert_variant=variant,
                                  dtype="bfloat16"),
        exp_name="convergence",
        batch_size=batch_size,
        seed=seed,
        quantize_frozen=env_flag("KAI0_INT8", "0"),
    )
    if os.environ.get("KAI0_OPT_STATE"):
        cfg = dataclasses.replace(
            cfg, optimizer=dataclasses.replace(cfg.optimizer, state_dtype=os.environ["KAI0_OPT_STATE"]))
    return cfg


def fixed_batch(model_config, batch_size: int, device) -> tuple[_model.Observation, torch.Tensor]:
    """The model's ``fake_obs`` (ones) and actions of ones, on ``device``."""
    obs = _model.Observation.from_dict(
        _tree(model_config.fake_obs(batch_size), lambda x: torch.from_numpy(x).to(device)))
    actions = torch.ones((batch_size, model_config.action_horizon, model_config.action_dim), device=device)
    return obs, actions


def _tree(tree, fn):
    return {k: _tree(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def start(config: _config.TrainConfig, *, device="cuda", state=None):
    """The model (drawn from ``config.seed``, or ``state``: a state dict of numpy arrays under the port's names) and
    its train state."""
    model = train_lib.create_model(config, device=device)
    if state is not None:
        _interop.load_jax_state(model, state)
    return model, train_lib.init_train_state(model, config, device=device)


def run(config: _config.TrainConfig, steps: int, *, device="cuda", state=None, draws=None) -> list[float]:
    """``steps`` train steps of ``config`` on one fixed batch; the losses, read once at the end.

    ``state``: initial weights as for ``start``. ``draws``: a list of per-step keyword arguments of
    ``train_step`` (``noise``, ``time``, ``augment_params``); without it step i draws from a generator seeded
    by (``config.seed`` + 1, i).
    """
    model, train_state = start(config, device=device, state=state)
    batch = fixed_batch(config.model, config.batch_size, model.device)
    losses = []
    for i in range(steps):
        kwargs = draws[i] if draws is not None else {
            "generator": _optimizer.step_generator(config.seed + 1, i, device=model.device)}
        train_state, info = train_lib.train_step(model, train_state, batch, config, **kwargs)
        losses.append(info["loss"])
    return [round(x, 6) for x in torch.stack(losses).float().tolist()] if losses else []


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full-ft", action="store_true",
                   help="the plain dummy variants (every parameter trains): the A/B bed of the full fine-tune's "
                        "paths (KAI0_INT8_SB_GEMMA)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    config = probe_config(full_ft=args.full_ft, batch_size=args.batch_size, seed=args.seed)
    losses = run(config, args.steps, device=args.device)
    knobs = _knobs.resolve(config.knobs)
    out = {
        "int8": config.quantize_frozen,
        "sb": any(_quant.switchback_on(knobs.int8_switchback, s) for s in _quant.SWITCHBACK_SITES["siglip"]),
        "sb_gemma": any(_quant.switchback_on(knobs.int8_sb_gemma, s) for s in ("ffn", "attn")),
        "losses": losses,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
