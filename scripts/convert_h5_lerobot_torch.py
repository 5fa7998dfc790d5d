"""Convert HDF5 episodes (with per-camera mp4s) to a LeRobot dataset, without JAX.

The command line of ``train_deploy_alignment/data_augment/convert_h5_lerobot.py``, on
``kai0_tpu_torch.augment.convert_h5`` (needs ``h5py``):

    python3 scripts/convert_h5_lerobot_torch.py --src H5_DIR --dst DS --task "Flatten and fold the cloth." \\
        [--cameras top_head hand_left hand_right] [--fps 30]

``H5_DIR`` holds ``episode_N.hdf5`` and ``video/<cam>/episode_N.mp4``, the DAgger collector's layout.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> None:
    from kai0_tpu_torch.augment import convert_h5

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--src", required=True, help="Directory with episode_*.hdf5 + video/<cam>/")
    parser.add_argument("--dst", required=True, help="Output LeRobot dataset root")
    parser.add_argument("--task", required=True, help="Task prompt string")
    parser.add_argument("--cameras", nargs="+", default=["top_head", "hand_left", "hand_right"])
    parser.add_argument("--fps", type=float, default=30.0)
    args = parser.parse_args(argv)

    meta = convert_h5.convert_h5_to_lerobot(args.src, args.dst, task=args.task, cameras=args.cameras, fps=args.fps)
    print(f"wrote {meta.info['total_episodes']} episodes, {meta.info['total_frames']} frames → {args.dst}")


if __name__ == "__main__":
    main()
