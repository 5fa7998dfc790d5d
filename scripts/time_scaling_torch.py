"""Time-scaling augmentation of a LeRobot dataset (keep every Nth frame), without JAX.

The command line of ``train_deploy_alignment/data_augment/time_scaling.py``, on
``kai0_tpu_torch.augment.time_scaling``:

    python3 scripts/time_scaling_torch.py --src DS --dst OUT --extraction-factor 2
    python3 scripts/time_scaling_torch.py --src DS --dst OUT --extraction-factor 2 --split \\
        [--extract-fraction 0.5] [--seed 42]

The full mode scales every episode; ``--split`` scales a random fraction of them and merges them with the rest.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> None:
    from kai0_tpu_torch.augment import time_scaling

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--src", required=True, help="Source LeRobot dataset root")
    parser.add_argument("--dst", required=True, help="Output dataset root")
    parser.add_argument("--extraction-factor", type=int, default=2, help="Keep every Nth frame")
    parser.add_argument("--split", action="store_true", help="Scale only a fraction of episodes and merge with the rest")
    parser.add_argument("--extract-fraction", type=float, default=0.5)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    if args.split:
        meta = time_scaling.time_scaling_with_split(args.src, args.dst, args.extraction_factor,
                                                    extract_fraction=args.extract_fraction, seed=args.seed)
    else:
        meta = time_scaling.time_scale_dataset(args.src, args.dst, args.extraction_factor)
    print(f"wrote {meta.info['total_episodes']} episodes, {meta.info['total_frames']} frames → {args.dst}")


if __name__ == "__main__":
    main()
