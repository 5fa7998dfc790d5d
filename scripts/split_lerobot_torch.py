"""Split a LeRobot dataset into disjoint episode subsets ``split_0..N-1``, without JAX.

The command line of ``scripts/split_lerobot.py``, on ``kai0_tpu_torch.data.split_merge``:

    python3 scripts/split_lerobot_torch.py --source_path DS --dst_path OUT [--split_num 4] [--seed 42]

Each subset is a full dataset (episodes renumbered, frames re-indexed): train a checkpoint on each, then mix them
with ``scripts/model_arithmetic_torch.py``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> None:
    from kai0_tpu_torch.data import split_merge

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--source_path", required=True, help="Source LeRobot dataset root")
    parser.add_argument("--dst_path", required=True, help="Output dir for split_0..split_N")
    parser.add_argument("--split_num", type=int, default=4)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)
    for out in split_merge.split_dataset(args.source_path, args.dst_path, args.split_num, args.seed):
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
