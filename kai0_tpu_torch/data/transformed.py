"""The transformed dataset and the entry points of the loader's worker processes.

Counterpart of ``kai0_tpu/data/transformed.py:14-45``. Spawn workers import
this module to unpickle the dataset; they read and transform items with
numpy (and cv2), and never initialise CUDA: ``worker_init`` hides the card
before the dataset is unpickled, and runs torch's CPU ops on one thread. Like
any spawn pool, the workers import the program's main module, which must keep
its work under ``if __name__ == "__main__":``.
"""

from __future__ import annotations

from collections.abc import Sequence


class TransformedDataset:
    """Applies a transform chain to each item of a random-access dataset."""

    def __init__(self, dataset, transforms: Sequence):
        self._dataset = dataset
        self._transforms = list(transforms)

    def __getitem__(self, index: int) -> dict:
        item = self._dataset[index]
        for transform in self._transforms:
            item = transform(item)
        return item

    def __len__(self) -> int:
        return len(self._dataset)


_WORKER_DATASET = None


def worker_init(pickled_dataset: bytes) -> None:
    """Process-pool initializer: hide the card, keep torch's CPU ops on one thread, then unpickle the dataset once
    per worker.

    The workers are the loader's parallelism: each reads one item at a time. With torch's default of a thread per
    core in every worker (the resizes of the transform chain run in torch), eight workers on eight cores left the
    training loop's own thread, which launches the step's kernels, waiting for a core.
    """
    import os
    import pickle

    import torch

    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # read when CUDA initialises, which nothing here has done yet
    torch.set_num_threads(1)
    global _WORKER_DATASET
    _WORKER_DATASET = pickle.loads(pickled_dataset)


def worker_get(index: int):
    return _WORKER_DATASET[int(index)]
