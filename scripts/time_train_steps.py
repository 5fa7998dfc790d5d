"""Run the training phases of ``chip_smoke.py`` alone, from one checkout, on one CUDA card.

    python3 scripts/time_train_steps.py [--root DIR] [--kind lora_int8|full]

``--kind lora_int8`` is phase 13 (the LoRA fine-tune over a frozen int8 base),
``--kind full`` phase 9 (the full fine-tune): 5 steps at batch 32, twice from
one seed, the second run's last step profiled, with every check of the phase.
``--root`` runs the ``chip_smoke.py`` and ``kai0_tpu_torch`` of another
checkout (for example the parent commit unpacked with ``git archive``), so the
step time of two trees can be compared in turns within one call, without the
other phases of a whole ``chip_smoke.py`` run between them.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    parser.add_argument("--kind", choices=("lora_int8", "full"), default="lora_int8")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_train_steps.py: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import chip_smoke  # the phases, from --root

    from kai0_tpu_torch.ops import _build

    _build.load()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; root {args.root}; kind {args.kind}")
    chip_smoke.train(args.kind)
    return 0


if __name__ == "__main__":
    sys.exit(main())
