"""The port's RLDS reading (``kai0_tpu_torch/data/{tfrecord,tf_example,rlds}.py``) and its DROID stream
(``kai0_tpu_torch/training/droid_rlds_dataset.py``) against TensorFlow and the JAX package.

- TFRecord framing: records written by ``tf.io.TFRecordWriter`` read bit for
  bit; the port's records read by ``tf.data.TFRecordDataset``; a flipped byte
  anywhere in a record raises in both; the CRC-32C module builds or raises.
- ``tf.train.Example``: random Examples (bytes, float and int64 lists,
  negative int64s, empty lists) serialized by TensorFlow decode equal, the
  unpacked encodings too; the port's encoding parsed by
  ``tf.io.parse_single_example`` is equal.
- Episodes in tfds's layout written with TensorFlow's writer come back as the
  test's own numpy trajectories (bit for bit); a count the step width does not
  divide raises.
- The frame pipeline against JAX's ``build_frame_pipeline`` on the same
  trajectories (``tf.data.Dataset.from_generator``, as
  ``tests/test_rlds_pipeline.py`` feeds it): actions, the tail clamp,
  ``step_id`` and the idle filter bit-equal, prompts and cameras bit-equal
  where the candidates are equal; decoded pixels within ``PIXEL_TOL``
  (TensorFlow's JPEG decoder against cv2's: max abs 5 measured). With
  distinct candidates each choice is one of them and, over 1,200 frames, the
  shares are within 4.5 binomial standard deviations (both packages).
- The stream: the ``.*success.*`` filter and the idle filter counted exactly
  an epoch, the weighted mix's share within 4.5 binomial standard deviations,
  and the multiset of one epoch through the shuffle buffer equal to the
  unshuffled frames.
- JAX's ``prepare`` on episodes shaped as tfds stores them (a stand-in
  ``tensorflow_datasets`` in ``sys.modules``) fails on
  ``traj["traj_metadata"]`` (ROADMAP Queue 3); the port reads them.
"""

import collections
import json
import sys
import types

import numpy as np
import pytest
import tensorflow as tf

import _rlds_data
from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu.training import droid_rlds_dataset as jax_rlds
from kai0_tpu_torch import native
from kai0_tpu_torch.data import rlds, tf_example, tfrecord
from kai0_tpu_torch.training import droid_rlds_dataset as torch_rlds

# A decoded pixel, TensorFlow's decode_image against cv2.imdecode: TensorFlow's JPEG decoder runs the fast integer
# IDCT (its default dct_method), cv2's libjpeg the slow exact one. Measured in this sandbox on the test's 8x8, 24x32
# and 180x320 JPEGs: max abs 5, mean abs 0.88-1.19.
PIXEL_TOL = {"max": 8, "mean": 2.0}
SIGMAS = 4.5


def _within_binomial(count: int, n: int, p: float) -> bool:
    return abs(count - n * p) <= SIGMAS * np.sqrt(n * p * (1 - p))


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------


def _payloads():
    rng = np.random.default_rng(0)
    return [b"", b"x", rng.bytes(1000), rng.bytes(1 << 20), b"\x00" * 7]


def test_crc32c_and_its_mask():
    crc = native.load_crc32c()
    assert crc.crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value
    assert crc.crc32c(b"56789", crc.crc32c(b"1234")) == 0xE3069283
    c = crc.crc32c(b"abc")
    assert tfrecord.masked_crc32c(b"abc") == (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def test_records_written_by_tensorflow_read_bit_for_bit(tmp_path):
    path = str(tmp_path / "tf.tfrecord")
    with tf.io.TFRecordWriter(path) as writer:
        for payload in _payloads():
            writer.write(payload)
    assert [bytes(r) for r in tfrecord.read_records(path)] == _payloads()


def test_records_written_by_the_port_read_by_tensorflow(tmp_path):
    path = tmp_path / "port.tfrecord"
    tfrecord.write_records(path, _payloads())
    assert list(tf.data.TFRecordDataset(str(path)).as_numpy_iterator()) == _payloads()
    with tf.io.TFRecordWriter(str(tmp_path / "tf.tfrecord")) as writer:
        for payload in _payloads():
            writer.write(payload)
    assert path.read_bytes() == (tmp_path / "tf.tfrecord").read_bytes()


@pytest.mark.parametrize("where", ["length", "length_crc", "payload", "payload_crc"])
def test_a_flipped_byte_raises_in_both(tmp_path, where):
    payload = b"0123456789" * 10
    record = bytearray(tfrecord.encode_record(payload))
    at = {"length": 0, "length_crc": 9, "payload": 12 + 50, "payload_crc": len(record) - 2}[where]
    record[at] ^= 0x20
    path = tmp_path / "bad.tfrecord"
    path.write_bytes(tfrecord.encode_record(b"fine") + bytes(record))
    with pytest.raises(ValueError, match="corrupted|truncated"):
        list(tfrecord.read_records(path))
    with pytest.raises((tf.errors.DataLossError, tf.errors.OutOfRangeError)):
        list(tf.data.TFRecordDataset(str(path)).as_numpy_iterator())
    path.write_bytes(tfrecord.encode_record(payload)[:-3])  # truncated
    with pytest.raises(ValueError, match="truncated"):
        list(tfrecord.read_records(path))


def test_the_crc_module_builds_or_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_crc32c", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tfrecord.masked_crc32c(b"abc")
    monkeypatch.setenv("KAI0_DISABLE_NATIVE", "1")  # the buffers' switch: the CRC has no Python path to switch to
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed to build"):
        list(tfrecord.read_records(tmp_path / "any.tfrecord"))


# ---------------------------------------------------------------------------
# tf.train.Example
# ---------------------------------------------------------------------------


def _random_features(rng):
    features = {}
    for i in range(12):
        kind, n = i % 4, int(rng.integers(0, 9)) if i % 4 else 0
        if kind == 0 and i % 8 == 0:
            features[f"k{i}"] = ("bytes", [])
        elif kind in (0, 1):
            features[f"k{i}"] = ("bytes", [rng.bytes(int(rng.integers(0, 300))) for _ in range(n)])
        elif kind == 2:
            features[f"k{i}"] = ("float", (rng.normal(size=n) * 10.0 ** rng.integers(-30, 30)).astype(np.float32))
        else:
            values = rng.integers(-(2**63), 2**63 - 1, size=n, dtype=np.int64)
            features[f"k{i}"] = ("int64", np.concatenate([values, [-1, 0, 127, 128, -(2**63)]]).astype(np.int64))
    return features


def _tf_feature(kind, values):
    if kind == "bytes":
        return tf.train.Feature(bytes_list=tf.train.BytesList(value=values))
    if kind == "float":
        return tf.train.Feature(float_list=tf.train.FloatList(value=values))
    return tf.train.Feature(int64_list=tf.train.Int64List(value=values))


def _assert_decoded(decoded, features):
    assert set(decoded) == set(features)
    for key, (kind, values) in features.items():
        got = decoded[key]
        if kind == "bytes":
            assert got == list(values), key
        else:
            assert got.dtype == (np.float32 if kind == "float" else np.int64), key
            np.testing.assert_array_equal(got, np.asarray(values), err_msg=key)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_examples_serialized_by_tensorflow_decode_equal(seed):
    features = _random_features(np.random.default_rng(seed))
    example = tf.train.Example(features=tf.train.Features(
        feature={k: _tf_feature(kind, v) for k, (kind, v) in features.items()}))
    _assert_decoded(tf_example.decode_example(example.SerializeToString()), features)
    # A Feature with no list set decodes to None.
    empty = tf.train.Example(features=tf.train.Features(feature={"none": tf.train.Feature()}))
    assert tf_example.decode_example(empty.SerializeToString()) == {"none": None}


def test_unpacked_floats_and_int64s_decode_equal():
    def field(number, wire, payload=b""):
        return tf_example._varint(number << 3 | wire) + payload

    def message(number, body):
        return field(number, 2, tf_example._varint(len(body)) + body)

    floats = np.asarray([1.5, -2.25, 3e-30], np.float32)
    ints = [-5, 0, 2**62, -(2**63)]
    float_list = b"".join(field(1, 5, np.asarray([v], "<f4").tobytes()) for v in floats)
    int_list = b"".join(field(1, 0, tf_example._varint(v & 0xFFFFFFFFFFFFFFFF)) for v in ints)
    entries = (message(1, message(1, b"f") + message(2, message(2, float_list)))
               + message(1, message(1, b"i") + message(2, message(3, int_list))))
    data = message(1, entries)
    parsed = tf.train.Example.FromString(data)  # the hand-made bytes are a valid Example
    assert list(parsed.features.feature["i"].int64_list.value) == ints
    decoded = tf_example.decode_example(data)
    np.testing.assert_array_equal(decoded["f"], floats)
    np.testing.assert_array_equal(decoded["i"], np.asarray(ints, np.int64))


@pytest.mark.parametrize("seed", [3, 4])
def test_the_ports_encoding_parsed_by_tensorflow(seed):
    features = _random_features(np.random.default_rng(seed))
    data = tf_example.encode_example({k: v for k, (_, v) in features.items()})
    spec = {k: tf.io.VarLenFeature({"bytes": tf.string, "float": tf.float32, "int64": tf.int64}[kind])
            for k, (kind, _) in features.items()}
    parsed = tf.io.parse_single_example(data, spec)
    for key, (kind, values) in features.items():
        got = tf.sparse.to_dense(parsed[key]).numpy()
        if kind == "bytes":
            assert list(got) == list(values), key
        else:
            np.testing.assert_array_equal(got, np.asarray(values), err_msg=key)


# ---------------------------------------------------------------------------
# Episodes in tfds's layout
# ---------------------------------------------------------------------------


def _tf_example_of(episode) -> bytes:
    """The episode as tfds serializes it, built with TensorFlow's protos."""
    feature = {}
    for key, value in rlds._flatten(episode).items():
        if isinstance(value, np.ndarray):
            feature[key] = _tf_feature("float", value.reshape(-1))
        else:
            value = [value] if isinstance(value, str) else value
            feature[key] = _tf_feature("bytes", [v.encode() if isinstance(v, str) else v for v in value])
    return tf.train.Example(features=tf.train.Features(feature=feature)).SerializeToString()


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_episodes_written_by_tensorflow_come_back_as_trajectories(tmp_path):
    rng = np.random.default_rng(1)
    episodes = [_rlds_data.droid_episode(rng, length=n, file_path=f"/r/{i}/success/t.h5", recording=f"/rec/{i}")
                for i, n in enumerate((3, 1, 6, 4))]
    root = tmp_path / "droid" / "1.0.1"
    root.mkdir(parents=True)
    for shard in range(2):
        with tf.io.TFRecordWriter(str(root / f"droid-train.tfrecord-{shard:05d}-of-00002")) as writer:
            for episode in episodes[shard::2]:
                writer.write(_tf_example_of(episode))
    paths = rlds.shard_paths(tmp_path, "droid", "1.0.1")
    assert [p.name for p in paths] == ["droid-train.tfrecord-00000-of-00002", "droid-train.tfrecord-00001-of-00002"]
    read = list(rlds.read_episodes(paths))
    assert len(read) == 4
    for index, (episode, want) in enumerate(zip(read, [*episodes[0::2], *episodes[1::2]], strict=True)):
        traj = rlds.episode_to_trajectory(episode, index)
        length = len(want["steps"]["action_dict"]["joint_position"])
        np.testing.assert_array_equal(traj.pop("_len"), np.full(length, length, np.int32))
        np.testing.assert_array_equal(traj.pop("_traj_index"), np.full(length, index, np.int32))
        _assert_same_tree(_rlds_data.trajectory(want), traj)
    # A count that the step width does not divide raises.
    broken = dict(rlds._flatten(episodes[0]))
    broken["steps/observation/joint_position"] = broken["steps/observation/joint_position"].reshape(-1)[:-1]
    with pytest.raises(ValueError, match="not a multiple of the step width 7"):
        rlds.decode_episode(_tf_example_of(broken))


def test_the_writer_encodes_camera_arrays_as_jpeg(tmp_path):
    rng = np.random.default_rng(6)
    episode = _rlds_data.droid_episode(rng, length=3, file_path="/p/success", recording="/r")
    tint = np.asarray([-50, 0, 50])  # R darker than B: a swap of the channels would show
    frames = np.stack([np.clip(_rlds_data._image(rng, (24, 32)).astype(int) + tint, 0, 255) for _ in range(3)])
    frames = frames.astype(np.uint8)
    episode["steps"]["observation"]["wrist_image_left"] = frames
    rlds.write_dataset(tmp_path, "droid", "1.0.1", [episode])
    (read,) = rlds.read_episodes(rlds.shard_paths(tmp_path, "droid", "1.0.1"))
    stored = read["steps"]["observation"]["wrist_image_left"]
    # JPEG at quality 95 (tfds's encoding), as TensorFlow decodes it: the RGB frame within JPEG's loss.
    assert list(stored) == [_rlds_data.jpeg(f, quality=95) for f in frames]
    decoded = np.stack([tf.io.decode_jpeg(b).numpy() for b in stored])
    assert decoded.shape == frames.shape and np.abs(decoded.astype(int) - frames).mean() < 4


# ---------------------------------------------------------------------------
# The frame pipeline against JAX's
# ---------------------------------------------------------------------------


def _tf_trajectories(trajs):
    def to_tf(x):
        return tf.constant(list(x)) if x.dtype == object else tf.constant(x)

    tensors = [tf.nest.map_structure(to_tf, t) for t in trajs]
    spec = tf.nest.map_structure(lambda t: tf.TensorSpec([None, *t.shape[1:]], t.dtype), tensors[0])
    return tf.data.Dataset.from_generator(lambda: iter(tensors), output_signature=spec)


def _frame_key(frame) -> tuple:
    obs = frame["observation"]
    return (frame["step_id"], frame["prompt"], frame["actions"].tobytes(), obs["image"].tobytes(),
            obs["wrist_image"].tobytes(), obs["joint_position"].tobytes(), obs["gripper_position"].tobytes())


@pytest.mark.parametrize("space", ["JOINT_POSITION", "JOINT_VELOCITY"])
def test_frame_pipeline_matches_jax(tmp_path, space):
    rng = np.random.default_rng(2)
    episodes = [_rlds_data.droid_episode(rng, length=n, file_path=f"/p/{i}/success/t.h5", recording=f"/rec/{i}",
                                         distinct=False) for i, n in enumerate((5, 1, 9))]
    trajs = [_rlds_data.trajectory(e) for e in episodes]
    filter_path = tmp_path / "filter.json"
    filter_path.write_text(json.dumps({"/rec/0--/p/0/success/t.h5": [[1, 3]], "/rec/2--/p/2/success/t.h5": [[0, 2], [6, 20]]}))
    for path in (None, str(filter_path)):
        want = list(jax_rlds.build_frame_pipeline(
            _tf_trajectories(trajs), action_space=jax_rlds.DroidActionSpace[space], action_chunk_size=4,
            filter_table=jax_rlds.make_filter_table(path)).as_numpy_iterator())
        got = list(torch_rlds.build_frame_pipeline(
            trajs, action_space=torch_rlds.DroidActionSpace[space], action_chunk_size=4,
            filter_table=torch_rlds.make_filter_table(path), rng=np.random.default_rng(0)))
        assert len(got) == len(want) == (15 if path is None else 2 + 5)
        for g, w in zip(got, want, strict=True):
            assert g["step_id"] == w["step_id"] and g["prompt"] == w["prompt"]
            for key in ("actions",):
                assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape == (4, 8)
                np.testing.assert_array_equal(g[key], w[key])
            for key in ("joint_position", "gripper_position"):
                np.testing.assert_array_equal(g["observation"][key], w["observation"][key])
            for key in ("image", "wrist_image"):
                a, b = g["observation"][key], w["observation"][key]
                assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (24, 32, 3)
                diff = np.abs(a.astype(int) - b.astype(int))
                assert diff.max() <= PIXEL_TOL["max"] and diff.mean() <= PIXEL_TOL["mean"], (key, diff.max())
    # The tail clamps to the last action; a one-step episode repeats its action.
    last = [f for f in got if f["step_id"].endswith(b"--8")][0]
    np.testing.assert_array_equal(last["actions"], np.repeat(last["actions"][:1], 4, axis=0))


def test_distinct_cameras_and_instructions_are_drawn_uniformly():
    rng = np.random.default_rng(3)
    n = 1200
    base = _rlds_data.droid_episode(rng, length=1, file_path="/p/success", recording="/r", hw=(8, 8))
    trajs = []
    for i in range(n):
        traj = _rlds_data.trajectory(base)
        traj["traj_metadata"]["episode_metadata"]["file_path"] = np.asarray([f"/p/{i}/success".encode()], object)
        trajs.append(traj)
    candidates = {k: torch_rlds.decode_image(base["steps"]["observation"][k][0]).astype(int)
                  for k in _rlds_data.CAMERAS[:2]}

    def camera(image):  # the candidate it decodes to (within the decoders' difference), else None
        diffs = {k: np.abs(image.astype(int) - c).max() for k, c in candidates.items()}
        best = min(diffs, key=diffs.get)
        return best if diffs[best] <= PIXEL_TOL["max"] else None

    assert camera(candidates["exterior_image_1_left"] * 0 + 128) is None
    prompts = {t.encode(): k for k in _rlds_data.INSTRUCTIONS for t in base["steps"][k]}
    for name, frames in (
        ("port", torch_rlds.build_frame_pipeline(trajs, rng=np.random.default_rng(4), action_chunk_size=2)),
        ("jax", jax_rlds.build_frame_pipeline(_tf_trajectories(trajs[:n]), action_chunk_size=2).as_numpy_iterator()),
    ):
        counts = collections.Counter()
        for frame in frames:
            counts[camera(frame["observation"]["image"])] += 1
            counts[prompts[frame["prompt"]]] += 1  # a KeyError: not one of the candidates
        assert sum(counts[k] for k in _rlds_data.CAMERAS[:2]) == n, (name, counts)
        assert _within_binomial(counts["exterior_image_1_left"], n, 0.5), (name, counts)
        assert all(_within_binomial(counts[k], n, 1 / 3) for k in _rlds_data.INSTRUCTIONS), (name, counts)


# ---------------------------------------------------------------------------
# The stream
# ---------------------------------------------------------------------------

DROID_LENGTHS = (6, 3, 8, 5, 7, 4, 9, 2)
POLARIS_LENGTHS = (5, 6, 4, 7)


def _write(root, name, version, lengths, prefix):
    rng = np.random.default_rng(len(name))
    episodes = [_rlds_data.droid_episode(
        rng, length=n, recording=f"/{prefix}/{i}", distinct=False,
        file_path=f"/{prefix}/{i}/{'failure' if i % 4 == 3 else 'success'}/trajectory.h5") for i, n in enumerate(lengths)]
    rlds.write_dataset(root, name, version, episodes, num_shards=3)
    return episodes


@pytest.fixture(scope="module")
def rlds_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("rlds")
    droid = _write(root, "droid", "1.0.1", DROID_LENGTHS, "droid")
    _write(root, "polaris_droid_cotrain_dataset", "1.0.0", POLARIS_LENGTHS, "polaris")
    # The idle filter: every droid episode whole, but episode 2 keeps steps [0, 3) and [5, 8) only.
    keep = {f"/droid/{i}--{e['episode_metadata']['file_path']}": [[0, n]]
            for i, (e, n) in enumerate(zip(droid, DROID_LENGTHS))}
    keep["/droid/2--/droid/2/success/trajectory.h5"] = [[0, 3], [5, 8]]
    (root / "filter.json").write_text(json.dumps(keep))
    return root


def _unbatched(batch, i):
    return {k: _unbatched(v, i) for k, v in batch.items()} if isinstance(batch, dict) else batch[i]


def _success(lengths):
    return [n for i, n in enumerate(lengths) if i % 4 != 3]


@pytest.mark.parametrize("shuffle", [False, True])
def test_one_epoch_through_the_buffer_is_the_unshuffled_frames(rlds_root, shuffle):
    dataset = torch_rlds.DroidRldsDataset(str(rlds_root), 5, [torch_rlds.RLDSDataset("droid", "1.0.1", 1.0)],
                                          shuffle=shuffle, shuffle_buffer_size=7, action_chunk_size=3, repeat=False,
                                          seed=11)
    batches = list(dataset)
    frames = [_unbatched(b, i) for b in batches for i in range(len(b["actions"]))]
    assert [len(b["actions"]) for b in batches][:-1] == [5] * (len(batches) - 1)
    episodes = [rlds.episode_to_trajectory(e) for e in rlds.read_episodes(rlds.shard_paths(rlds_root, "droid", "1.0.1"))
                if b"success" in e["episode_metadata"]["file_path"][0]]
    want = list(torch_rlds.build_frame_pipeline(episodes, action_chunk_size=3, rng=np.random.default_rng(0)))
    assert len(frames) == len(want) == sum(_success(DROID_LENGTHS))
    assert sorted(map(_frame_key, frames)) == sorted(map(_frame_key, want))
    assert [_frame_key(f) for f in frames] != [_frame_key(f) for f in want]  # the buffer did shuffle
    (counts,) = dataset.sources[0].epochs
    assert counts == {"episodes": 8, "success_episodes": 6, "frames": sum(_success(DROID_LENGTHS)),
                      "kept_frames": sum(_success(DROID_LENGTHS))}


def test_the_success_and_idle_filters_count_exactly(rlds_root):
    config = torch_rlds.RLDSDataset("droid", "1.0.1", 1.0, filter_dict_path=str(rlds_root / "filter.json"))
    dataset = torch_rlds.DroidRldsDataset(str(rlds_root), 4, [config], shuffle_buffer_size=3, repeat=False)
    step_ids = [s for b in dataset for s in b["step_id"]]
    kept = sum(_success(DROID_LENGTHS)) - 2  # episode 2 drops steps 3 and 4
    assert len(step_ids) == kept and not any(b"failure" in s for s in step_ids)
    assert {s for s in step_ids if s.startswith(b"/droid/2--")} == {
        f"/droid/2--/droid/2/success/trajectory.h5--{t}".encode() for t in (0, 1, 2, 5, 6, 7)}
    assert dataset.sources[0].epochs == [{"episodes": 8, "success_episodes": 6,
                                          "frames": sum(_success(DROID_LENGTHS)), "kept_frames": kept}]


def test_the_weighted_mix_share(rlds_root):
    datasets = [torch_rlds.RLDSDataset("droid", "1.0.1", 0.9),
                torch_rlds.RLDSDataset("polaris_droid_cotrain_dataset", "1.0.0", 0.1)]
    dataset = torch_rlds.DroidRldsDataset(str(rlds_root), 50, datasets, shuffle_buffer_size=200, seed=5)
    batches = iter(dataset)
    step_ids = [s for _ in range(40) for s in next(batches)["step_id"]]
    polaris = sum(s.startswith(b"/polaris/") for s in step_ids)
    assert _within_binomial(polaris, len(step_ids), 0.1), polaris
    assert len(dataset) == 20_000_000
    # Both sources have gone round more than once, and every finished epoch counted the same.
    for source, lengths in zip(dataset.sources, (DROID_LENGTHS, POLARIS_LENGTHS), strict=True):
        assert source.epochs and all(e["kept_frames"] == sum(_success(lengths)) for e in source.epochs)


def test_weights_must_sum_to_one_and_cv2_is_required(rlds_root, monkeypatch):
    with pytest.raises(ValueError, match="sum to 1.0"):
        torch_rlds.DroidRldsDataset(str(rlds_root), 2, [torch_rlds.RLDSDataset("droid", "1.0.1", 0.5)])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        torch_rlds.DroidRldsDataset(str(rlds_root), 2, [torch_rlds.RLDSDataset("droid", "1.0.1", 1.0)])


def test_jax_prepare_fails_on_episodes_as_tfds_stores_them(rlds_root, monkeypatch):
    """ROADMAP Queue 3: JAX's ``prepare`` filters on ``traj["traj_metadata"]`` straight after ``as_dataset``, whose
    episodes hold ``steps`` and ``episode_metadata`` (dlimp's ``from_rlds`` made the trajectory view)."""
    episodes = list(rlds.read_episodes(rlds.shard_paths(rlds_root, "droid", "1.0.1")))

    def as_tf(tree):
        return tf.nest.map_structure(lambda x: tf.constant(list(x)) if x.dtype == object else tf.constant(x), tree)

    stored = [{"steps": as_tf(e["steps"]),
               "episode_metadata": {k: tf.constant(v[0]) for k, v in e["episode_metadata"].items()}}
              for e in episodes]
    spec = tf.nest.map_structure(lambda t: tf.TensorSpec([None, *t.shape[1:]] if t.shape.rank else [], t.dtype),
                                 stored[0])

    class Builder:
        def as_dataset(self, **kwargs):
            return tf.data.Dataset.from_generator(lambda: iter(stored), output_signature=spec)

    stand_in = types.SimpleNamespace(builder=lambda *args, **kwargs: Builder(), ReadConfig=lambda **kwargs: None,
                                     decode=types.SimpleNamespace(SkipDecoding=lambda: None))
    monkeypatch.setitem(sys.modules, "tensorflow_datasets", stand_in)
    with pytest.raises(KeyError, match="traj_metadata"):
        jax_rlds.DroidRldsDataset(str(rlds_root), 2, [jax_rlds.RLDSDataset("droid", "1.0.1", 1.0)])
    # The port reads the same episodes.
    dataset = torch_rlds.DroidRldsDataset(str(rlds_root), 2, [torch_rlds.RLDSDataset("droid", "1.0.1", 1.0)],
                                          shuffle_buffer_size=4, repeat=False)
    assert sum(len(b["actions"]) for b in dataset) == sum(_success(DROID_LENGTHS))
