"""Merge several LeRobot datasets into one, without JAX.

The command line of ``scripts/merge_lerobot.py``, on ``kai0_tpu_torch.data.split_merge``:

    python3 scripts/merge_lerobot_torch.py --sources A B [C ...] [--src_list_file LIST] --dst MERGED [--force]

Checks that fps and the features agree (``--force`` warns instead), renumbers episodes and frames, remaps the task
indices into the union of the task tables and copies the videos without re-encoding them.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> None:
    from kai0_tpu_torch.data import split_merge

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--sources", nargs="+", required=True, help="Source dataset roots")
    parser.add_argument("--src_list_file", default=None, help="Text file with one source root per line")
    parser.add_argument("--dst", required=True, help="Output dataset root")
    parser.add_argument("--force", action="store_true", help="Warn instead of failing on feature mismatches")
    args = parser.parse_args(argv)

    sources = list(args.sources)
    if args.src_list_file:
        with open(args.src_list_file) as f:
            sources += [line.strip() for line in f if line.strip() and not line.startswith("#")]

    merged = split_merge.merge_datasets(sources, args.dst, force=args.force)
    print(f"merged {merged.info['total_episodes']} episodes, {merged.info['total_frames']} frames → {args.dst}")


if __name__ == "__main__":
    main()
