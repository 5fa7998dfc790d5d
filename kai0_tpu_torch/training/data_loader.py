"""The training data: datasets, the transform stack, batching and the feed to the card.

Counterpart of ``kai0_tpu/training/data_loader.py:52-428``:

- ``FakeDataset`` draws each item from ``np.random.default_rng(index)`` in the
  model's ``inputs_spec``, leaf by leaf in the order JAX's ``tree.map`` visits
  its ``Observation`` (fields in order, camera keys sorted), so its items are
  JAX's bit for bit.
- ``transform_stack``: repack -> robot data transforms -> Normalize -> model
  transforms; ``create_dataset``: fake data or a LeRobot dataset (episode
  subset, per-task split, the prompt from the task), for the advantage
  estimator wrapped in ``AdvantageLerobotDataset`` (each frame paired with a
  comparison frame of its episode), with ``augment_time_scale`` /
  ``augment_mirror`` wrapped in ``TimeScaledView`` then ``MirroredView``
  (``data/augment_views.py``).
- ``DataLoader`` walks JAX's index stream (a permutation seeded by
  ``seed + epoch`` per epoch, the last partial batch dropped with
  ``drop_last``) and collates items with ``np.stack`` (64-bit arrays then
  narrowed to 32 bits, as JAX's ``device_put`` narrows them). Items are read in
  ``num_workers`` spawn processes (which hide the card, so they never
  initialise CUDA) or, with 0, in the producer thread itself. One
  producer thread keeps a queue of 2 batches ahead. For a card it pins each
  batch in host memory and copies it on a side stream; the consumer's stream
  waits on the copy's event, and the tensors are recorded on that stream.
  Batches arrive as ``(Observation, actions)`` on the loader's device, uint8
  images mapped to [-1, 1] there.
- ``RLDSLoader``: the RLDS DROID stream (``droid_rlds_dataset.DroidRldsDataset``,
  built by ``create_rlds_dataset`` when the data config sets ``rlds_data_dir``)
  through the transform stack frame by frame, each batch's frames then stacked
  (the reference's ``IterableTransformedDataset(is_batched=True)``), on the
  same producer thread and pinned copy.
- ``create_data_loader`` returns the data config with the loader
  (``DataLoaderImpl``), for the checkpoint's norm-stats assets.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator
import dataclasses
import pickle
import queue
import threading

import numpy as np
import torch

from kai0_tpu_torch import transforms as _transforms
from kai0_tpu_torch.data.transformed import TransformedDataset, worker_get, worker_init
from kai0_tpu_torch.models import model as _model

_FAKE_SAMPLES = 1024


class FakeDataset:
    """Random items drawn from the model's ``inputs_spec`` (reference :100-128)."""

    def __init__(self, model_config, num_samples: int):
        self._num_samples = num_samples
        self._observation_spec, self._action_spec = model_config.inputs_spec()

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng(index)

        def make(spec) -> np.ndarray:
            shape, dtype = spec
            shape = shape[1:]  # items are unbatched
            if dtype == np.bool_:
                return rng.random(size=shape) > 0.5
            if np.issubdtype(dtype, np.integer):
                return rng.integers(0, 1000, size=shape).astype(dtype)
            return rng.standard_normal(size=shape).astype(dtype)

        item = {
            name: {key: make(spec[key]) for key in sorted(spec)} if isinstance(spec, dict) else make(spec)
            for name, spec in self._observation_spec.items()
        }
        item["actions"] = make(self._action_spec)
        return item

    def __len__(self) -> int:
        return self._num_samples


def transform_stack(data_config, model_config) -> list:
    """The input transforms in their order (reference :233-281): repack → robot data → Normalize → model."""
    return [
        *data_config.repack_transforms.inputs,
        *data_config.data_transforms.inputs,
        _transforms.Normalize(data_config.norm_stats, use_quantiles=data_config.use_quantile_norm),
        *data_config.model_transforms.inputs,
    ]


def create_dataset(data_config, model_config, *, advantage: bool = False, split: str = "all"):
    """Fake data, or a LeRobot dataset with action chunking (``episodes`` subset, per-task ``split``), time-scaled
    and then mirrored as ``augment_time_scale`` / ``augment_mirror`` say (``kai0_tpu/training/data_loader.py:124-138``);
    ``advantage`` pairs each frame with a comparison frame (``AdvantageLerobotDataset``)."""
    time_scale = data_config.augment_time_scale
    repo_id = data_config.repo_id
    if repo_id is None or repo_id == "fake":
        # As loud as the real path: a run that sets augmentation flags must not train unaugmented fake data.
        if time_scale != 1 or data_config.augment_mirror:
            raise ValueError("train-time augmentation requires a real LeRobot dataset, not fake data")
        return FakeDataset(model_config, num_samples=_FAKE_SAMPLES)

    from kai0_tpu_torch.data import lerobot_dataset

    def open_dataset(episodes):
        return lerobot_dataset.LeRobotDataset(
            repo_id,
            action_horizon=model_config.action_horizon,
            action_sequence_keys=tuple(data_config.action_sequence_keys),
            episodes=episodes,
        )

    dataset = open_dataset(list(data_config.episodes) if data_config.episodes is not None else None)
    if split != "all":
        dataset = open_dataset(lerobot_dataset.episodes_split_through_task(dataset, split))
    if time_scale < 1:
        raise ValueError(f"augment_time_scale must be >= 1, got {time_scale}")
    if time_scale > 1 or data_config.augment_mirror:
        if advantage:
            # Estimator training runs unaugmented (reference pi0_pytorch.py:487) on the raw episode structure.
            raise ValueError("train-time augmentation is not supported for advantage-estimator datasets")
        from kai0_tpu_torch.data.augment_views import MirroredView, TimeScaledView

        if time_scale > 1:  # over the raw dataset: it gathers strided chunk rows through get_frame
            dataset = TimeScaledView(dataset, time_scale)
        if data_config.augment_mirror:
            left_dim, right_dim = data_config.augment_mirror_dims
            dataset = MirroredView(dataset, left_dim=left_dim, right_dim=right_dim)
    if advantage:
        from kai0_tpu_torch.data import advantage_dataset

        dataset = advantage_dataset.AdvantageLerobotDataset(dataset)
    if data_config.prompt_from_task:
        return TransformedDataset(dataset, [_transforms.PromptFromLeRobotTask(dataset.tasks)])
    return dataset


def _stack(items: list):
    """Collate items (nested dicts of arrays) with ``np.stack``, leaf by leaf."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([item[k] for item in items]) for k in first}
    return np.stack(items)


def _map(fn: Callable, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# 64-bit arrays become 32-bit on the way to the model, as JAX's device_put (x64 off) makes them.
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32}


def _as_tensor(x):
    """A numeric numpy array as a tensor (64-bit types narrowed to 32); anything else as it is."""
    if not (isinstance(x, np.ndarray) and x.dtype.kind in "biuf"):
        return x
    return torch.from_numpy(x.astype(_NARROW[x.dtype]) if x.dtype in _NARROW else x)


class DataLoader:
    """Batches of a random-access dataset on ``device``, read ahead by a producer thread."""

    def __init__(
        self,
        dataset,
        *,
        batch_size: int,
        device: torch.device | str = "cuda",
        shuffle: bool = True,
        num_workers: int = 2,
        seed: int = 0,
        num_batches: int | None = None,
        drop_last: bool = True,
    ):
        if len(dataset) < batch_size:
            raise ValueError(f"Batch size ({batch_size}) is larger than the dataset ({len(dataset)}).")
        self._dataset = dataset
        self._batch_size = batch_size
        self._device = torch.device(device)
        self._shuffle = shuffle
        self._num_workers = max(0, num_workers)
        self._seed = seed
        self._num_batches = num_batches
        self._drop_last = drop_last
        self._pool = None

    def _process_pool(self):
        if self._pool is None:
            import multiprocessing

            # The workers read items with numpy and cv2; worker_init hides the card from them.
            self._pool = multiprocessing.get_context("spawn").Pool(
                self._num_workers, initializer=worker_init, initargs=(pickle.dumps(self._dataset),)
            )
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def _index_stream(self) -> Iterator[np.ndarray]:
        epoch = 0
        while True:
            order = np.arange(len(self._dataset))
            if self._shuffle:
                order = np.random.default_rng(self._seed + epoch).permutation(order)
            limit = (len(order) // self._batch_size) * self._batch_size if self._drop_last else len(order)
            for start in range(0, limit, self._batch_size):
                yield order[start : start + self._batch_size]
            epoch += 1

    def _collate(self, pool, batch_indices: np.ndarray):
        if pool is not None:
            chunk = max(1, len(batch_indices) // (self._num_workers * 2))
            items = pool.map(worker_get, [int(i) for i in batch_indices], chunksize=chunk)
        else:
            items = [self._dataset[int(i)] for i in batch_indices]
        return _stack(items)

    def _host_batches(self) -> Iterator[dict]:
        """Collated numpy batches, without end."""
        pool = self._process_pool() if self._num_workers > 0 else None
        for batch_indices in self._index_stream():
            yield self._collate(pool, batch_indices)

    def __iter__(self):
        device = self._device
        cuda = device.type == "cuda"
        batches = self._host_batches()
        copy_stream = torch.cuda.Stream(device) if cuda else None
        prefetch: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def pinned_copy(x):
            t = _as_tensor(x)
            return t.pin_memory().to(device, non_blocking=True) if isinstance(t, torch.Tensor) else t

        def to_device(batch):
            """(tensors on the device, the copy's event or None)."""
            if not cuda:
                return _map(_as_tensor, batch), None
            with torch.cuda.stream(copy_stream):
                moved = _map(pinned_copy, batch)
                event = torch.cuda.Event()
                event.record(copy_stream)
            return moved, event

        def put_until_stopped(item) -> bool:
            # A plain blocking put would pin this thread (and its device buffers) once the consumer stops reading.
            while not stop.is_set():
                try:
                    prefetch.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in batches:
                    if stop.is_set() or not put_until_stopped(to_device(batch)):
                        return
                put_until_stopped(StopIteration())
            except Exception as e:  # noqa: BLE001 — handed to the consumer, which raises it
                put_until_stopped(e)
            finally:
                batches.close()

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        produced = 0
        try:
            while self._num_batches is None or produced < self._num_batches:
                item = prefetch.get()
                if isinstance(item, StopIteration):  # a finite stream has ended
                    return
                if isinstance(item, Exception):
                    raise item
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(device)
                    current.wait_event(event)
                    for t in _leaves(batch):
                        if isinstance(t, torch.Tensor):
                            t.record_stream(current)
                actions = batch.pop("actions")
                yield _model.Observation.from_dict(batch), actions
                produced += 1
        finally:
            stop.set()
            # Unblock a producer waiting on a full queue, then reap it.
            while True:
                try:
                    prefetch.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=10)


class RLDSLoader(DataLoader):
    """Batches of the RLDS stream on ``device``, each frame through the transform stack (reference
    ``IterableTransformedDataset(is_batched=True)`` + ``RLDSDataLoader``)."""

    def __init__(self, rlds_dataset, transforms, *, device: torch.device | str = "cuda",
                 num_batches: int | None = None):
        super().__init__(rlds_dataset, batch_size=rlds_dataset.batch_size, device=device, num_workers=0,
                         num_batches=num_batches)
        self._transforms = list(transforms)

    def _transformed(self, frame: dict) -> dict:
        for transform in self._transforms:
            frame = transform(frame)
        return frame

    def _host_batches(self) -> Iterator[dict]:
        for batch in self._dataset:
            frames = [_map(lambda x, i=i: x[i], batch) for i in range(len(batch["actions"]))]
            yield _stack([self._transformed(frame) for frame in frames])


def create_rlds_dataset(data_config, action_horizon: int, batch_size: int, *, shuffle: bool = True, seed: int = 0):
    """The RLDS DROID stream of a data config (``kai0_tpu/training/data_loader.py:362-372``)."""
    from kai0_tpu_torch.training import droid_rlds_dataset as _rlds

    return _rlds.DroidRldsDataset(
        data_config.rlds_data_dir,
        batch_size,
        list(data_config.rlds_datasets),
        shuffle=shuffle,
        action_chunk_size=action_horizon,
        action_space=data_config.action_space or _rlds.DroidActionSpace.JOINT_POSITION,
        seed=seed,
    )


class DataLoaderImpl:
    """A loader bound to its data config (the checkpoint saves the config's norm stats, reference :597-607)."""

    def __init__(self, data_config, loader: DataLoader):
        self._data_config = data_config
        self._loader = loader

    def data_config(self):
        return self._data_config

    def __iter__(self):
        yield from self._loader

    def close(self):
        self._loader.close()


def create_data_loader(
    config,
    *,
    device: torch.device | str = "cuda",
    shuffle: bool = True,
    num_batches: int | None = None,
    skip_norm_stats: bool = False,
) -> DataLoaderImpl:
    """The training loader of a ``TrainConfig`` on ``device`` (reference :284-330)."""
    data_config = config.data.create(config.assets_dirs, config.model)
    if skip_norm_stats or config.skip_norm_stats:
        data_config = dataclasses.replace(data_config, norm_stats=None)
    if data_config.rlds_data_dir is not None:
        if data_config.augment_mirror or data_config.augment_time_scale != 1:
            # The augmentation views wrap random-access LeRobot datasets; the stream has none: fail loudly instead of
            # training unaugmented.
            raise ValueError("augment_mirror/augment_time_scale are not supported on the RLDS path")
        dataset = create_rlds_dataset(data_config, config.model.action_horizon, config.batch_size, shuffle=shuffle,
                                      seed=config.seed)
        loader = RLDSLoader(dataset, transform_stack(data_config, config.model), device=device,
                            num_batches=num_batches)
        return DataLoaderImpl(data_config, loader)
    dataset = create_dataset(data_config, config.model, advantage=config.advantage_estimator, split=config.split)
    dataset = TransformedDataset(dataset, transform_stack(data_config, config.model))
    loader = DataLoader(
        dataset,
        batch_size=config.batch_size,
        device=device,
        shuffle=shuffle,
        num_workers=config.num_workers,
        seed=config.seed,
        num_batches=num_batches,
        drop_last=config.drop_last,
    )
    return DataLoaderImpl(data_config, loader)
