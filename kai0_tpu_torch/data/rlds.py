"""tfds's RLDS layout on disk, read and written without TensorFlow.

A dataset ``name`` at ``version`` lives in
``{data_dir}/{name}/{version}/{name}-{split}.tfrecord-NNNNN-of-MMMMM``; each
record is one episode, a ``tf.train.Example`` (``data/tf_example.py``) whose
keys are tfds's flattened feature paths: ``steps/<path>`` holds every step's
values one after another (a float or int64 list of ``T × width`` values, a
bytes list of ``T`` encoded images or strings), ``episode_metadata/<path>`` one
value. ``decode_episode`` reshapes the keys of ``STEP_FEATURES`` (the keys of
DROID's RLDS schema that ``training/droid_rlds_dataset.restructure_trajectory``
reads, with their per-step shapes and dtypes) to ``[T, *shape]``; a value count
that the width does not divide raises, as tfds's ``FixedLenSequenceFeature``
parse does. Images stay encoded bytes. Floats are stored as float32 (tfds
writes float64 features as a float list) and come back as the schema's float64.

``episode_to_trajectory`` is dlimp's ``from_rlds``: the steps' keys go to the
top level and the episode's other keys (``episode_metadata``) are broadcast to
``T`` under ``traj_metadata``, with ``_len`` and ``_traj_index``.

``encode_episode`` / ``write_dataset`` write episodes in that layout (the tests
and ``chip_smoke.py`` make their shards with them); a camera given as a uint8
``[T, H, W, 3]`` RGB array is encoded as JPEG at quality 95 (TensorFlow's
``encode_jpeg`` default, which tfds's image feature uses) by ``cv2``.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator, Mapping
import pathlib

import numpy as np

from kai0_tpu_torch.data import tf_example, tfrecord

IMAGE = "image"  # an encoded image a step (JPEG in DROID), kept as bytes
TEXT = "text"  # a UTF-8 string a step, kept as bytes

# DROID's RLDS schema (droid 1.0.1, the PolaRiS co-training set shares it): the keys the frame pipeline reads.
STEP_FEATURES: dict[str, tuple | str] = {
    "action_dict/joint_position": ((7,), np.float64),
    "action_dict/joint_velocity": ((7,), np.float64),
    "action_dict/gripper_position": ((1,), np.float64),
    "observation/exterior_image_1_left": IMAGE,
    "observation/exterior_image_2_left": IMAGE,
    "observation/wrist_image_left": IMAGE,
    "observation/joint_position": ((7,), np.float64),
    "observation/gripper_position": ((1,), np.float64),
    "language_instruction": TEXT,
    "language_instruction_2": TEXT,
    "language_instruction_3": TEXT,
}
EPISODE_FEATURES = ("episode_metadata/file_path", "episode_metadata/recording_folderpath")  # one string each
_KEYS = frozenset((*(f"steps/{key}" for key in STEP_FEATURES), *EPISODE_FEATURES))  # the keys decoded; others skipped


def shard_paths(data_dir: str | pathlib.Path, name: str, version: str, split: str = "train") -> list[pathlib.Path]:
    """The shards of ``name``/``version``'s ``split``, in shard order; raises if there is none."""
    root = pathlib.Path(data_dir) / name / version
    paths = sorted(root.glob(f"{name}-{split}.tfrecord-*-of-*"))
    if not paths:
        raise FileNotFoundError(f"no RLDS shards {name}-{split}.tfrecord-*-of-* under {root}")
    return paths


def _nest(flat: Mapping[str, object]) -> dict:
    out: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _bytes_array(values: list) -> np.ndarray:
    out = np.empty(len(values), object)
    out[:] = values
    return out


def decode_episode(payload) -> dict:
    """One serialized episode as ``{"steps": {...}, "episode_metadata": {...}}``: each key of ``STEP_FEATURES`` as
    ``[T, *shape]`` (images and strings as object arrays of bytes), each metadata key as a one-element object
    array of bytes."""
    features = tf_example.decode_example(payload, _KEYS)
    steps, length = {}, None
    for key, spec in STEP_FEATURES.items():
        values = features.get(f"steps/{key}")
        if values is None:
            raise KeyError(f"the episode has no steps/{key}")
        if spec in (IMAGE, TEXT):
            if not isinstance(values, list):
                raise ValueError(f"steps/{key} is not a bytes list")
            value = _bytes_array(values)
        else:
            shape, dtype = spec
            width = int(np.prod(shape))
            if isinstance(values, list) or values.size % width:
                raise ValueError(f"steps/{key}: {len(values)} values, not a multiple of the step width {width}")
            value = values.reshape(-1, *shape).astype(dtype)
        if length is not None and len(value) != length:
            raise ValueError(f"steps/{key} has {len(value)} steps, the episode's other keys {length}")
        length = len(value)
        steps[key] = value
    metadata = {}
    for key in EPISODE_FEATURES:
        values = features.get(key)
        if not isinstance(values, list) or len(values) != 1:
            raise ValueError(f"{key} is not one string")
        metadata[key] = _bytes_array(values)
    return {"steps": _nest(steps), **_nest(metadata)}


def episode_to_trajectory(episode: Mapping, index: int = 0) -> dict:
    """dlimp's ``from_rlds``: the steps' keys at the top level, every other key broadcast to the episode's length
    under ``traj_metadata``, and ``_len`` / ``_traj_index`` a step."""
    steps = episode["steps"]
    length = len(next(iter(_flatten(steps).values())))
    metadata = {key: value for key, value in episode.items() if key != "steps"}
    broadcast = _nest({key: np.repeat(value, length) for key, value in _flatten(metadata).items()})
    if "traj_metadata" in steps:
        raise ValueError("the steps already hold a traj_metadata key")
    return {**steps, "traj_metadata": broadcast, "_len": np.full(length, length, np.int32),
            "_traj_index": np.full(length, index, np.int32)}


def read_episodes(paths: Iterable[pathlib.Path]) -> Iterator[dict]:
    """The decoded episodes of ``paths``, file after file."""
    for path in paths:
        for payload in tfrecord.read_records(path):
            yield decode_episode(payload)


def _jpeg(image: np.ndarray) -> bytes:
    import cv2

    ok, encoded = cv2.imencode(".jpg", np.ascontiguousarray(image[..., ::-1]), [cv2.IMWRITE_JPEG_QUALITY, 95])
    if not ok:
        raise ValueError(f"cv2 could not encode an image of shape {image.shape}")
    return encoded.tobytes()


def encode_episode(episode: Mapping) -> bytes:
    """One episode (``{"steps": {...}, "episode_metadata": {...}}``, nested or with ``/`` keys) serialized as tfds
    writes it: each step key's values one step after another; a sequence of bytes or str stays a bytes list, and a
    camera of ``STEP_FEATURES`` given as a uint8 array becomes a list of JPEGs."""
    flat = {}
    for key, value in _flatten(episode).items():
        if (STEP_FEATURES.get(key.removeprefix("steps/")) == IMAGE and isinstance(value, np.ndarray)
                and value.dtype == np.uint8):
            flat[key] = [_jpeg(image) for image in value]
        elif isinstance(value, np.ndarray) and value.dtype.kind in "biuf":
            flat[key] = value.reshape(-1)
        elif isinstance(value, (str, bytes)):
            flat[key] = [value]
        else:
            flat[key] = list(value)
    return tf_example.encode_example(flat)


def write_dataset(data_dir: str | pathlib.Path, name: str, version: str, episodes: Iterable[Mapping], *,
                  num_shards: int = 1, split: str = "train") -> list[pathlib.Path]:
    """Write ``episodes`` as ``num_shards`` TFRecord shards of tfds's layout (episode i in shard i % num_shards);
    returns their paths."""
    root = pathlib.Path(data_dir) / name / version
    root.mkdir(parents=True, exist_ok=True)
    payloads: list[list[bytes]] = [[] for _ in range(num_shards)]
    for i, episode in enumerate(episodes):
        payloads[i % num_shards].append(encode_episode(episode))
    paths = [root / f"{name}-{split}.tfrecord-{i:05d}-of-{num_shards:05d}" for i in range(num_shards)]
    for path, shard in zip(paths, payloads, strict=True):
        tfrecord.write_records(path, shard)
    return paths
