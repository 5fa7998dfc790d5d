"""Space-mirroring augmentation of a dual-arm LeRobot dataset, without JAX.

The command line of ``train_deploy_alignment/data_augment/space_mirroring.py``, on
``kai0_tpu_torch.augment.space_mirroring``:

    python3 scripts/space_mirroring_torch.py create-mirror --src DS --dst MIRRORED [--left-dim 7 --right-dim 7]
    python3 scripts/space_mirroring_torch.py merge --sources DS MIRRORED --dst MERGED
    python3 scripts/space_mirroring_torch.py full --src DS --dst MERGED [--left-dim 7 --right-dim 7]

``create-mirror`` writes the mirrored twin (arm blocks swapped, videos flipped, wrist cameras swapped), ``merge``
concatenates datasets, ``full`` does both with the original first.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> None:
    from kai0_tpu_torch.augment import space_mirroring
    from kai0_tpu_torch.data import split_merge

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("create-mirror", help="Write the mirrored twin of a dataset")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--left-dim", type=int, default=7)
    p.add_argument("--right-dim", type=int, default=7)

    p = sub.add_parser("merge", help="Merge datasets (original + mirrored)")
    p.add_argument("--sources", nargs="+", required=True)
    p.add_argument("--dst", required=True)

    p = sub.add_parser("full", help="Mirror then merge with the original")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--left-dim", type=int, default=7)
    p.add_argument("--right-dim", type=int, default=7)

    args = parser.parse_args(argv)
    if args.cmd == "create-mirror":
        meta = space_mirroring.create_mirror_dataset(args.src, args.dst, left_dim=args.left_dim,
                                                     right_dim=args.right_dim)
    elif args.cmd == "merge":
        meta = split_merge.merge_datasets(args.sources, args.dst)
    else:
        meta = space_mirroring.create_mirror_and_merge(args.src, args.dst, left_dim=args.left_dim,
                                                       right_dim=args.right_dim)
    print(f"wrote {meta.info['total_episodes']} episodes, {meta.info['total_frames']} frames → {args.dst}")


if __name__ == "__main__":
    main()
