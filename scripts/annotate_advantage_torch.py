"""Annotate a LeRobot dataset with a trained advantage estimator, with the PyTorch port on a CUDA card.

The command line of ``stage_advantage/annotation/eval.py``:

    python3 scripts/annotate_advantage_torch.py <model_type> <model_name> <dataset_root> [--ckpt_dir=DIR]
        [--config_name=NAME] [--batch_size=N] [--relative_interval=K] [--overwrite]

e.g. ``Flatten-Fold KAI0 data/FlattenFold/base --ckpt_dir=<run>/30000``. The
registry maps (model_type, model_name) to an estimator config, its checkpoint,
the evaluator's mode, prompt and batch; the checkpoint directory holds the
estimator's ``model.safetensors`` (``scripts/train_torch.py ADVANTAGE_TORCH_*``
writes one at each save). Writes ``data_<name>_<steps>/`` parquets beside the
dataset's ``data/`` with the predicted advantage columns. ``--device=cpu``
evaluates on the host's CPU, slowly, for tests.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

# (model_type, model_name) → estimator config + checkpoint + inference mode.
MODELS_CONFIG_MAP: dict[str, dict[str, dict]] = {
    "Flatten-Fold": {
        "KAI0": {
            "name": "KAI0",
            "config_name": "ADVANTAGE_TORCH_KAI0_FLATTEN_FOLD",
            "ckpt_dir": "./checkpoints/ADVANTAGE_TORCH_KAI0_FLATTEN_FOLD/estimator",
            "ckpt_steps": 30000,
            "mode": "2timesteps",
            "prompt": "Flatten and fold the cloth.",
            "batch_size": 160,
        },
        "PI06": {
            "name": "PI06",
            "config_name": "ADVANTAGE_TORCH_PI06_FLATTEN_FOLD",
            "ckpt_dir": "./checkpoints/ADVANTAGE_TORCH_PI06_FLATTEN_FOLD/estimator",
            "ckpt_steps": 30000,
            "mode": "1timestep",
            "prompt": "Flatten and fold the cloth.",
            "batch_size": 400,
        },
    },
}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("model_type", choices=sorted(MODELS_CONFIG_MAP))
    parser.add_argument("model_name", choices=["PI06", "KAI0"])
    parser.add_argument("repo_id", help="Path to the LeRobot dataset root")
    parser.add_argument("--ckpt_dir", default=None, help="Override checkpoint directory")
    parser.add_argument("--config_name", default=None, help="Override train config name")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--relative_interval", type=int, default=50)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = parser.parse_args(argv)

    from kai0_tpu_torch.advantage import SimpleValueEvaluator, annotate_dataset

    cfg = MODELS_CONFIG_MAP[args.model_type][args.model_name]
    config_name = args.config_name or cfg["config_name"]
    ckpt_dir = args.ckpt_dir or f"{cfg['ckpt_dir']}/{cfg['ckpt_steps']}"

    evaluator = SimpleValueEvaluator(
        config_name, ckpt_dir, batch_size=args.batch_size or cfg["batch_size"], device=args.device
    )
    written = annotate_dataset(
        evaluator,
        args.repo_id,
        prompt=cfg["prompt"],
        output_tag=f"{cfg['name']}_{cfg['ckpt_steps']}",
        mode=cfg["mode"],
        relative_interval=args.relative_interval,
        batch_size=args.batch_size,
        overwrite=args.overwrite,
    )
    evaluator.shutdown()
    print(f"Annotated {len(written)} episodes")


if __name__ == "__main__":
    main()
