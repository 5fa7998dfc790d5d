"""Train-Deploy Alignment data augmentation: dataset-level LeRobot rewrites (the port's copy of
``kai0_tpu/augment``).

- :mod:`.time_scaling`: keep every Nth frame (parquet and video) at unchanged fps, so demonstrations play back
  faster; the split mode scales a fraction of the episodes and merges them with the rest.
- :mod:`.space_mirroring`: the mirrored twin of a dual-arm dataset (arm blocks of state and action swapped,
  videos flipped with the wrist cameras swapped, stats mirrored), merged with the original.
- :mod:`.convert_h5`: HDF5 episodes with per-camera mp4s (the DAgger collector's layout) to LeRobot.

The train-time counterparts of the first two are the views of ``kai0_tpu_torch.data.augment_views``.
"""
