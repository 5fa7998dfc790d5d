"""Mix PyTorch-format checkpoints (``model.safetensors``) with the PyTorch port on a CUDA card.

The command line of ``model_arithmetic/arithmetic_torch.py``:

    python3 scripts/model_arithmetic_torch.py --checkpoints CKPT [CKPT ...] --output DIR
        [--weights W ...] [--losses L ...]
        [--optimize_method {average,inverse_loss,gradient_descent,adaptive_gradient_descent,greedy}]
        [--config NAME --data-path BATCHES.pkl] [--num_iterations N] [--learning_rate LR] [--device cuda|cpu]

Each checkpoint is a directory with ``model.safetensors`` (or its ``params``
alias). The weights are ``--weights``, the average, squared inverse
``--losses``, or chosen on validation batches by the loss of the mixed model
(``inverse_loss`` without ``--losses``, ``gradient_descent``,
``adaptive_gradient_descent``, ``greedy``), which needs ``--config`` (the
train config whose model the checkpoints hold: a π₀, π₀.₅, π₀-FAST
(``pi0_fast_*``) or advantage estimator (``ADVANTAGE_TORCH_*``) config) and
``--data-path``. Those modes hold all checkpoints on the card at once: 6.7 GB
each in bf16 for π₀.₅,
plus the f32 mixed model (13.4 GB) and, for the gradient modes, its gradient
(13.4 GB); the script raises with the bytes needed if they do not fit.

``--data-path`` is a pickle written by ``scripts/dump_data_torch.py`` (numpy
arrays only). The pickle of ``model_arithmetic/dump_data.py`` holds JAX
package objects, which this script cannot read: dump the batches again.

The mix is the key-wise f64 average of the checkpoints' tensors, cast back to
each tensor's dtype, on ``--device``. The output directory gets the mixed
``model.safetensors`` and, when every checkpoint has a ``norm_stats.json`` at
its root or under ``assets/``, their weighted-average ``norm_stats.json``.
``--device=cpu`` runs everything on the host's CPU, slowly, for tests.
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

logger = logging.getLogger("kai0_tpu_torch")

_OPT_METHODS = ("average", "inverse_loss", "gradient_descent", "adaptive_gradient_descent", "greedy")


def optimize_weights(args) -> list[float]:
    """Loss-driven weights: the checkpoints in one ``Ensemble`` on ``args.device``, the batches with seeded draws."""
    from kai0_tpu_torch.arithmetic import core
    from kai0_tpu_torch.training import config as _config

    if args.config is None or args.data_path is None:
        raise ValueError(f"--config and --data-path are required for {args.optimize_method}")
    config = _config.get_config(args.config)
    with open(args.data_path, "rb") as f:
        batches = pickle.load(f)

    ensemble = core.Ensemble(list(args.checkpoints), config.model, device=args.device)
    staged = ensemble.stage(batches)
    if args.optimize_method == "inverse_loss":
        losses = ensemble.checkpoint_losses(staged)
        logger.info(f"Per-checkpoint losses: {losses}")
        return core.compute_optimal_weights(losses)
    if args.optimize_method == "greedy":
        return core.optimize_weights_greedy(ensemble, staged)
    return core.optimize_weights_gradient_descent(
        ensemble,
        staged,
        num_iterations=args.num_iterations,
        learning_rate=args.learning_rate,
        adaptive=args.optimize_method == "adaptive_gradient_descent",
    )


def main(argv=None) -> list[float]:
    """Mix the checkpoints; returns the weights."""
    from kai0_tpu_torch import interop
    from kai0_tpu_torch.arithmetic import core

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoints", nargs="+", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--weights", nargs="+", type=float, default=None)
    parser.add_argument("--losses", nargs="+", type=float, default=None,
                        help="Per-checkpoint validation losses for inverse_loss weighting "
                             "(skips on-device evaluation)")
    parser.add_argument("--optimize_method", choices=_OPT_METHODS, default="average")
    parser.add_argument("--config", default=None, help="Train config name (loss-driven modes)")
    parser.add_argument("--data-path", default=None,
                        help="Validation batches pickle from scripts/dump_data_torch.py (loss-driven modes)")
    parser.add_argument("--num_iterations", type=int, default=50)
    parser.add_argument("--learning_rate", type=float, default=0.05)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    weights = args.weights
    if weights is None:
        if args.optimize_method == "average":
            weights = [1.0 / len(args.checkpoints)] * len(args.checkpoints)
        elif args.optimize_method == "inverse_loss" and args.losses is not None:
            if len(args.losses) != len(args.checkpoints):
                raise ValueError("--losses must have one value per checkpoint")
            weights = core.compute_optimal_weights(args.losses)
        else:
            weights = optimize_weights(args)
    if len(weights) != len(args.checkpoints):
        raise ValueError("Number of weights must match number of checkpoints")
    logger.info(f"Mixing weights: {weights}")

    states = [interop.read_safetensors(core.resolve_checkpoint_dir(p) / interop.CHECKPOINT_FILE)
              for p in args.checkpoints]
    mixed = core.mix_state_dicts(states, weights, device=args.device)
    del states
    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = interop.write_safetensors(mixed, out_dir / interop.CHECKPOINT_FILE)
    logger.info(f"Saved mixed checkpoint to {out}")

    # Weighted-average norm stats when every checkpoint carries one.
    stats_paths = [core.find_norm_stats(p) for p in args.checkpoints]
    if all(p is not None for p in stats_paths):
        stats = [core.load_norm_stats_json(p) for p in stats_paths]
        core.save_norm_stats_json(core.mix_norm_stats(stats, weights=weights), out_dir / "norm_stats.json")
        logger.info("Saved mixed norm_stats.json")
    return list(weights)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
