"""Train π₀.₅ with the PyTorch port on a CUDA card.

The command line of ``scripts/train.py``:

    python3 scripts/train_torch.py <config-name> --exp_name=<x> [--field.path=value ...]

e.g. ``pi05_flatten_fold_normal --exp_name=run1 --weight_loader.params_path=<dir>/model.safetensors``
or ``pi05_base --exp_name=smoke --batch_size=32 --param_dtype=bfloat16 --optimizer.state_dtype=int8
--ema_decay=none``. Checkpoints go to ``<checkpoint_base_dir>/<config>/<exp_name>/<step>/``
(``kai0_tpu_torch/training/checkpoints.py`` has the layout); ``--resume``
continues the newest step, ``--overwrite`` starts over. ``--device=cpu``
(this script's own flag) trains on the host's CPU, slowly, for tests; there
is no multi-card path yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def init_logging():
    level_mapping = {"DEBUG": "D", "INFO": "I", "WARNING": "W", "ERROR": "E", "CRITICAL": "C"}

    class CustomFormatter(logging.Formatter):
        def format(self, record):
            record.levelname = level_mapping.get(record.levelname, record.levelname)
            return super().format(record)

    formatter = CustomFormatter(
        fmt="%(asctime)s.%(msecs)03d [%(levelname)s] %(message)-80s (%(process)d:%(filename)s:%(lineno)s)",
        datefmt="%H:%M:%S",
    )
    logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)


def main(argv: list[str] | None = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for arg in [a for a in argv if a.startswith("--device=")]:
        device = arg.split("=", 1)[1]
        argv.remove(arg)
    init_logging()
    from kai0_tpu_torch.training import config as _config
    from kai0_tpu_torch.training import train_lib

    train_lib.main(_config.cli(argv), device=device)


if __name__ == "__main__":
    main()
