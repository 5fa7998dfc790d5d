"""Dump validation batches from the training loader for ``scripts/model_arithmetic_torch.py``.

The command line of ``model_arithmetic/dump_data.py``:

    python3 scripts/dump_data_torch.py --config pi05_flatten_fold_normal \\
        --output val_batches.pkl --num-batches 50 --batch-size 8

Pickles a list of ``(observation, actions)`` pairs drawn (shuffled, the
config's seed) from the port's ``create_data_loader`` on the host: the
observation as the nested dict of numpy arrays that ``Observation.from_dict``
reads (``image``, ``image_mask``, ``state``, ``tokenized_prompt``, ...; images
in [-1, 1]), the actions a numpy array. Nothing in it needs torch or this
package to unpickle.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _numpy(tree):
    return {k: _numpy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


def main(argv=None) -> pathlib.Path:
    from kai0_tpu_torch.training import config as _config
    from kai0_tpu_torch.training import data_loader as _data_loader

    parser = argparse.ArgumentParser(description="Pickle validation batches for Model Arithmetic.")
    parser.add_argument("--config", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--num-batches", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=8)
    args = parser.parse_args(argv)

    config = dataclasses.replace(_config.get_config(args.config), batch_size=args.batch_size)
    loader = _data_loader.create_data_loader(config, device="cpu", shuffle=True, num_batches=args.num_batches)
    try:
        batches = [(_numpy(obs.to_dict()), actions.numpy()) for obs, actions in loader]
    finally:
        loader.close()

    output = pathlib.Path(args.output)
    output.parent.mkdir(parents=True, exist_ok=True)
    with open(output, "wb") as f:
        pickle.dump(batches, f)
    print(f"Dumped {len(batches)} batches to {output}")
    return output


if __name__ == "__main__":
    main()
