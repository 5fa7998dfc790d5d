"""The port's robot edge against the JAX package's: buffers, the native build, DAgger and the client's loops.

- Buffers: the port's C++ buffers (``deploy/native_buffers.py`` over
  ``kai0_tpu_torch/native``), the JAX package's C++ buffers and the port's
  Python buffers run the same scripted chunk and pop schedules (smoothing,
  raw, fully stale chunks, the bridge from the last executed action,
  ensembling with explicit and cursor starts and the cleanup lag): every
  action within 1e-12 (``tests/test_deploy.py``'s bound), the same lengths,
  staleness and cursors; a producer and a consumer thread on each buffer.
- The native build has no fallback: a missing compiler raises with its name,
  ``make_*_buffer`` raise with it, ``KAI0_DISABLE_NATIVE`` gives the Python
  buffers.
- ``DAggerCollector`` of both packages on the same frames: the HDF5 datasets
  and attributes bit-equal, the mp4 frames decoded by ``cv2`` equal, the
  port's ``convert_h5`` reads the port's episodes; without ``h5py`` the save
  raises naming it and keeps the frames.
- ``DaggerStateMachine`` over a scripted key sequence, ``KalmanFilter``
  (f64, bit-equal) and ``MasterArmSwitcher`` on a recording bus (with the
  abort when no slave data comes): the same states and bus calls.
- The client scripts of both packages loaded by their file paths, driven by
  a deterministic stub policy: sync publishes the same actions bit for bit;
  rtc sends payloads of the same keys and shapes and publishes the same
  actions once one fake clock pins both ``rtc_client`` modules'
  ``time.monotonic`` (``RTCClient.infer_round`` times each call); every mode
  publishes exactly ``max_steps`` finite actions; the DAgger driver of both
  packages records the same episode.
"""

import importlib.util
import pathlib
import sys
import threading
import types

import numpy as np
import pytest

from _torch_parity import worker_share_of_torch_threads  # noqa: F401
from kai0_tpu import native as jax_native
from kai0_tpu.deploy import buffers as jax_buffers
from kai0_tpu.deploy import dagger as jax_dagger
from kai0_tpu.deploy import native_buffers as jax_native_buffers
from kai0_tpu.deploy import rtc_client as jax_rtc_client
from kai0_tpu_torch import deploy, native
from kai0_tpu_torch.augment import convert_h5
from kai0_tpu_torch.deploy import buffers, dagger, native_buffers, rtc_client

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_native_module(tmp_path_factory):
    """The JAX package's C++ module, built into a temporary cache (its ``load()`` returns None when it cannot)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KAI0_NATIVE_CACHE", str(tmp_path_factory.mktemp("jax_native")))
        mp.delenv("KAI0_DISABLE_NATIVE", raising=False)
        module = jax_native.load()
    assert module is not None, "the JAX package's native buffers did not build"
    return module


def _stream_buffers(jax_module, smooth_method="temporal"):
    return {"port native": native_buffers.NativeStreamActionBuffer(smooth_method=smooth_method),
            "jax native": jax_native_buffers.NativeStreamActionBuffer(smooth_method=smooth_method, _module=jax_module),
            "port python": buffers.StreamActionBuffer(smooth_method=smooth_method),
            "jax python": jax_buffers.StreamActionBuffer(smooth_method=smooth_method)}


def _same_actions(got: dict, what: str) -> None:
    want = got["jax python"]
    for name, action in got.items():
        if want is None:
            assert action is None, (what, name)
        else:
            assert action is not None and action.shape == want.shape, (what, name)
            np.testing.assert_allclose(action, want, rtol=0, atol=1e-12, err_msg=f"{what}: {name}")


# (chunk rows, max_k, min_m, pops after it): trims, a short old chunk padded to min_m, a fully stale chunk
# (dropped), a drained buffer bridged from the last executed action, an overlap of one
STREAM_SCHEDULE = [(10, 6, 3, 4), (10, 6, 3, 2), (6, 8, 8, 9), (5, 10, 4, 7), (12, 3, 5, 12), (8, 0, 1, 3),
                   (3, 5, 2, 1), (1, 0, 8, 2), (9, 2, 3, 20)]


@pytest.mark.parametrize("smooth_method", ["temporal", "raw"])
def test_stream_buffers_follow_one_schedule(jax_native_module, smooth_method):
    rng = np.random.default_rng(0)
    bufs = _stream_buffers(jax_native_module, smooth_method)
    assert deploy.make_stream_buffer(smooth_method=smooth_method).__class__ is native_buffers.NativeStreamActionBuffer
    for round_i, (rows, max_k, min_m, pops) in enumerate(STREAM_SCHEDULE):
        chunk = rng.normal(size=(rows, 4))
        for buf in bufs.values():
            buf.integrate_new_chunk(chunk, max_k=max_k, min_m=min_m)
        assert len({len(b) for b in bufs.values()}) == 1 and len({b.k for b in bufs.values()}) == 1, round_i
        for pop in range(pops):
            _same_actions({name: buf.pop_next_action() for name, buf in bufs.items()}, f"round {round_i} pop {pop}")
            assert len({(len(b), b.k, b.has_any()) for b in bufs.values()}) == 1, (round_i, pop)
    for buf in bufs.values():  # an empty chunk changes nothing
        buf.integrate_new_chunk(np.zeros((0, 4)), max_k=3)
    assert len({(len(b), b.k) for b in bufs.values()}) == 1


ENSEMBLE_SCHEDULE = [(0, 8, 2), (3, 8, 3), (None, 8, 1), (None, 5, 4), (20, 6, 0), (-2, 6, 14), (None, 4, 3)]


def test_ensembling_buffers_follow_one_schedule(jax_native_module):
    rng = np.random.default_rng(1)
    kwargs = dict(exp_weight_m=0.05, cleanup_lag=3)
    bufs = {"port native": native_buffers.NativeTemporalEnsemblingBuffer(**kwargs),
            "jax native": jax_native_buffers.NativeTemporalEnsemblingBuffer(**kwargs, _module=jax_native_module),
            "port python": buffers.TemporalEnsemblingBuffer(**kwargs),
            "jax python": jax_buffers.TemporalEnsemblingBuffer(**kwargs)}
    assert deploy.make_ensembling_buffer().__class__ is native_buffers.NativeTemporalEnsemblingBuffer
    _same_actions({name: buf.step() for name, buf in bufs.items()}, "before any chunk")
    for round_i, (start, rows, steps) in enumerate(ENSEMBLE_SCHEDULE):
        chunk = rng.normal(size=(rows, 3))
        for buf in bufs.values():
            buf.add_chunk(chunk, start_timestep=start)
        cursor = bufs["jax python"].current_t
        for t in (cursor, cursor + 2, max(cursor - 4, 0)):
            _same_actions({name: buf.get_action(t) for name, buf in bufs.items()}, f"round {round_i} t={t}")
        for step in range(steps):
            _same_actions({name: buf.step() for name, buf in bufs.items()}, f"round {round_i} step {step}")
        assert len({b.current_t for b in bufs.values()}) == 1


@pytest.mark.parametrize("kind", ["native", "python"])
def test_a_producer_and_a_consumer_thread_share_a_buffer(kind):
    buf = native_buffers.NativeStreamActionBuffer() if kind == "native" else buffers.StreamActionBuffer()
    stop, popped = threading.Event(), []

    def producer():
        rng = np.random.default_rng(2)
        for _ in range(50):
            buf.integrate_new_chunk(rng.normal(size=(20, 4)), max_k=10)

    def consumer():
        while not stop.is_set() or buf.has_any():
            action = buf.pop_next_action()
            if action is not None:
                popped.append(action)

    threads = [threading.Thread(target=consumer), threading.Thread(target=producer)]
    for t in threads:
        t.start()
    threads[1].join(timeout=30)
    stop.set()
    threads[0].join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert popped and all(a.shape == (4,) and np.isfinite(a).all() for a in popped) and not buf.has_any()


def test_the_native_build_has_no_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build()
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        deploy.make_stream_buffer()
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        deploy.make_ensembling_buffer()
    assert not list((tmp_path / "native").glob("*.so"))
    # a compiler that fails: its stderr in the error
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed to build"):
        native.build()
    assert isinstance(deploy.make_stream_buffer(prefer_native=False), buffers.StreamActionBuffer)
    monkeypatch.setenv("KAI0_DISABLE_NATIVE", "1")
    assert not native.enabled()
    assert isinstance(deploy.make_stream_buffer(), buffers.StreamActionBuffer)
    assert isinstance(deploy.make_ensembling_buffer(), buffers.TemporalEnsemblingBuffer)
    with pytest.raises(RuntimeError, match="KAI0_DISABLE_NATIVE"):
        native.load()


def test_the_build_lands_under_build_named_by_the_source():
    native.load()
    path = native.library_path()
    assert path.exists() and path.parent == REPO / "build" / "kai0_tpu_torch" / "native"
    assert path.name.startswith("_stream_buffer_") and len(path.name.split("_")[3].split(".")[0]) == 16


# ---------------------------------------------------------------------------
# DAgger
# ---------------------------------------------------------------------------

CAMERAS = ["top_head", "hand_left", "hand_right"]


def _frames(seed: int, n: int) -> list[tuple[dict, np.ndarray, bool]]:
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        images = {cam: rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for cam in CAMERAS}
        if i == 3:  # a float image in [0, 1], which the writer scales to uint8
            images["hand_left"] = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
        obs = {"qpos": rng.uniform(-1, 1, 14), "images": images}
        if i % 2:
            obs.update(qvel=rng.normal(size=14), effort=rng.normal(size=14), base_vel=rng.normal(size=2))
        frames.append((obs, rng.uniform(-1, 1, 14), i in (4, 5, 6)))
    return frames


def _h5_tree(path) -> dict:
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        out["attrs"] = dict(f.attrs)
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()]) if isinstance(obj, h5py.Dataset) else None)
    return out


def _video(path) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def test_the_collector_writes_jax_episodes_that_convert(tmp_path):
    episodes = [_frames(7, 9), _frames(8, 5)]
    for pkg, name in ((dagger, "port"), (jax_dagger, "jax")):
        collector = pkg.DAggerCollector(CAMERAS, tmp_path / name, task_name="fold", fps=10)
        assert collector.episode_idx == 0
        for frames in episodes:
            collector.add_frame(*frames[0][:2])  # not collecting: dropped
            collector.start_collection()
            for obs, action, intervention in frames:
                collector.add_frame(obs, action, intervention=intervention)
            assert collector.frame_count == len(frames)
            collector.save_episode()
        assert not collector.is_collecting and collector.save_episode() is None
        assert pkg.DAggerCollector(CAMERAS, tmp_path / name, task_name="fold").episode_idx == 2
    for idx in range(2):
        ours, ref = (_h5_tree(tmp_path / n / "fold" / f"episode_{idx}.hdf5") for n in ("port", "jax"))
        assert ours.keys() == ref.keys() and ours["attrs"] == ref["attrs"]
        for key in ref:
            if key != "attrs":
                assert ours[key].dtype == ref[key].dtype and ours[key].shape == ref[key].shape, key
                np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
        assert ours["intervention"].tolist() == [f[2] for f in episodes[idx]]
        for cam in CAMERAS:
            got, want = (_video(tmp_path / n / "fold" / "video" / cam / f"episode_{idx}.mp4") for n in ("port", "jax"))
            assert got.shape == (len(episodes[idx]), 48, 64, 3)
            np.testing.assert_array_equal(got, want)
    meta = convert_h5.convert_h5_to_lerobot(tmp_path / "port" / "fold", tmp_path / "lerobot", task="fold",
                                            cameras=CAMERAS, fps=10)
    assert meta.info["total_episodes"] == 2 and meta.info["total_frames"] == 14


def test_a_save_without_h5py_names_it_and_keeps_the_frames(tmp_path, monkeypatch):
    collector = dagger.DAggerCollector(CAMERAS, tmp_path)
    collector.start_collection()
    for obs, action, intervention in _frames(9, 3):
        collector.add_frame(obs, action, intervention=intervention)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="save_episode needs h5py"):
        collector.save_episode()
    assert collector.frame_count == 3 and collector.is_collecting and not list(tmp_path.iterdir())


KEYS = ["x", "enter", " ", "d", "D", " ", " ", "r", "s", "enter", "q", "enter"]


def test_the_state_machine_follows_the_same_keys():
    machines = [dagger.DaggerStateMachine(), jax_dagger.DaggerStateMachine()]
    modes = []
    for key in KEYS:
        states = []
        for sm in machines:
            mode = sm.on_key(key)
            states.append((mode, sm.mode, sm.recording, sm.save_requested, sm.intervening))
        assert states[0] == states[1], key
        modes.append(states[0][0])
        if key == "s":
            assert [sm.consume_save_request() for sm in machines] == [True, True]
            assert [sm.consume_save_request() for sm in machines] == [False, False]
    assert modes == ["idle", "infer", "infer", "dagger", "dagger", "dagger", "dagger", "infer", "infer", "infer", "quit",
                     "infer"]


def test_the_kalman_filter_is_bit_equal():
    rng = np.random.default_rng(3)
    filters = [dagger.KalmanFilter(), jax_dagger.KalmanFilter(process_variance=1e-6, measurement_variance=1e-7)]
    for step in range(40):
        if step == 25:
            for kf in filters:
                kf.reset()
        raw = rng.normal(size=14) * 0.01 + step * 0.02
        ours, ref = (kf.update(raw) for kf in filters)
        assert ours.dtype == ref.dtype == np.float64
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(filters[0].error_estimate, filters[1].error_estimate)


def _recording_bus(base, slaves):
    calls = []

    class Bus(base):
        def enable_masters(self, enabled):
            calls.append(("enable", enabled))

        def set_master_config(self, config):
            calls.append(("config", config))

        def set_teach_mode(self, mode):
            calls.append(("teach", mode))

        def command_master_joints(self, left, right):
            calls.append(("joints", list(left), list(right)))

        def slave_positions(self):
            calls.append(("slaves",))
            return slaves

    return Bus(), calls


@pytest.mark.parametrize("slaves", [([0.1] * 7, [0.2] * 7), None])
def test_the_master_arm_hand_off_makes_the_same_bus_calls(slaves):
    runs = []
    for pkg in (dagger, jax_dagger):
        bus, calls = _recording_bus(pkg.MasterArmBus, slaves)
        sleeps = []
        switcher = pkg.MasterArmSwitcher(bus, move_duration=0.4, hold_hz=10.0, repeats=2, sleep=sleeps.append)
        entered = switcher.enter_dagger_mode()
        state = switcher.in_teach_mode
        switcher.exit_dagger_mode()
        runs.append((entered, state, switcher.in_teach_mode, calls, sleeps))
    assert runs[0] == runs[1]
    assert runs[0][0] is (slaves is not None) and dagger.SAFE_MASTER_POSE == jax_dagger.SAFE_MASTER_POSE
    with pytest.raises(NotImplementedError):
        dagger.MasterArmBus().slave_positions()


# ---------------------------------------------------------------------------
# The client scripts' driver loops
# ---------------------------------------------------------------------------


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def clients():
    return {"port": _load(REPO / "scripts" / "inference_client_torch.py", "port_inference_client"),
            "jax": _load(REPO / "train_deploy_alignment" / "inference" / "inference_client.py", "jax_inference_client")}


class _StubPolicy:
    """A deterministic server: each chunk depends on the call count and on the observation's state and payload."""

    def __init__(self, horizon=10, dim=14):
        self.horizon, self.dim, self.payloads = horizon, dim, []

    def infer(self, obs):
        self.payloads.append(obs)
        n = len(self.payloads)
        base = np.asarray(obs["state"], np.float64)[None, : self.dim]
        steps = np.arange(self.horizon, dtype=np.float64)[:, None] * 0.01 * n
        chunk = base + steps + np.sin(np.arange(self.dim) + n)[None]
        if "prev_action_chunk" in obs:
            chunk = chunk + 0.001 * np.asarray(obs["prev_action_chunk"], np.float64)[:, : self.dim]
        return {"actions": chunk.astype(np.float32)}


class _Recorded:
    """Wraps a robot: keeps every published action."""

    def __init__(self, robot):
        self.robot, self.published = robot, []

    def get_observation(self):
        return self.robot.get_observation()

    def publish_action(self, action):
        self.published.append(np.array(action, copy=True))
        self.robot.publish_action(action)


def _drive(client, mode: str, max_steps: int = 12, **kwargs):
    robot, policy = _Recorded(client.SimRobot()), _StubPolicy()
    common = dict(policy=policy, robot=robot, prompt="fold", publish_rate=500.0, max_steps=max_steps)
    if mode == "sync":
        client.run_sync(**common)
    elif mode == "smooth":
        client.run_smooth(**common, infer_rate=200.0)
    elif mode == "ensemble":
        client.run_ensemble(**common, infer_rate=200.0)
    else:
        client.run_rtc(**common, execute_horizon=kwargs.get("execute_horizon", 4))
    return robot, policy


@pytest.mark.parametrize("mode", ["sync", "smooth", "ensemble", "rtc"])
def test_every_mode_publishes_max_steps_finite_actions(clients, mode):
    robot, policy = _drive(clients["port"], mode, max_steps=13)
    assert len(robot.published) == 13 and policy.payloads
    assert all(a.shape == (14,) and np.isfinite(a).all() for a in robot.published)


def test_sync_publishes_jax_actions(clients):
    runs = {name: _drive(client, "sync", max_steps=23) for name, client in clients.items()}
    got, want = (np.stack(runs[name][0].published) for name in ("port", "jax"))
    assert got.shape == (23, 14) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_rtc_payloads_and_actions_match_jax_with_the_clock_pinned(clients, monkeypatch):
    runs = {}
    for name, module in (("port", rtc_client), ("jax", jax_rtc_client)):
        ticks = iter(np.arange(1, 1000) * 0.004)  # every round trip 4 ms: 2 steps at 500 Hz
        monkeypatch.setattr(module, "time", types.SimpleNamespace(monotonic=lambda ticks=ticks: float(next(ticks))))
        runs[name] = _drive(clients[name], "rtc", max_steps=18, execute_horizon=4)
    (robot, policy), (ref_robot, ref_policy) = runs["port"], runs["jax"]
    assert len(policy.payloads) == len(ref_policy.payloads) == 5
    for ours, ref in zip(policy.payloads, ref_policy.payloads, strict=True):
        assert ours.keys() == ref.keys()
        for key in ref:
            a, b = np.asarray(ours[key]), np.asarray(ref[key])
            assert a.shape == b.shape and a.dtype == b.dtype, key
            if key != "images":
                np.testing.assert_array_equal(a, b, err_msg=key)
    assert ours["inference_delay"] == 2 and "prev_action_chunk" in ours
    np.testing.assert_array_equal(np.stack(robot.published), np.stack(ref_robot.published))


def test_the_kalman_robot_publishes_jax_actions(clients):
    published = {}
    for name, client in clients.items():
        robot = client.KalmanSmoothedRobot(_Recorded(client.SimRobot()))
        for i in range(5):
            robot.publish_action(np.sin(np.arange(14) + i))
        published[name] = np.stack(robot._robot.published)
    np.testing.assert_array_equal(published["port"], published["jax"])


def test_the_dagger_driver_records_the_jax_episode(tmp_path):
    ours = _load(REPO / "scripts" / "dagger_collect_torch.py", "port_dagger_collect")
    ref = _load(REPO / "train_deploy_alignment" / "dagger" / "dagger_collect.py", "jax_dagger_collect")
    keys = {1: " ", 4: "d", 7: "r", 10: "s", 12: "q"}  # by published action: record, take over, resume, save, quit
    for name, module, pkg, client in (("port", ours, dagger, ours._inference_client()),
                                      ("jax", ref, jax_dagger, None)):
        client = client or _load(REPO / "train_deploy_alignment" / "inference" / "inference_client.py", "jax_ic_d")
        sm = pkg.DaggerStateMachine()
        sm.on_key("enter")

        class Keyed(_Recorded):
            """Sends the keys as actions are published; its cameras are HWC, as the collector's mp4 writer takes
            them (``SimRobot`` sends CHW: see ``test_chw_cameras_fail_the_mp4_export_in_both_packages``)."""

            def get_observation(self):
                obs = super().get_observation()
                obs["images"] = {cam: np.ascontiguousarray(img.transpose(1, 2, 0)) for cam, img in obs["images"].items()}
                return obs

            def publish_action(self, action, sm=sm):
                super().publish_action(action)
                if len(self.published) in keys:
                    sm.on_key(keys[len(self.published)])

        robot, teleop = Keyed(client.SimRobot(cameras=CAMERAS)), client.SimRobot()
        collector = pkg.DAggerCollector(CAMERAS, tmp_path / name, fps=25)
        module.run(_StubPolicy(), robot, teleop, collector, sm, "fold", publish_rate=500.0, chunk_exec=5)
    got, want = (_h5_tree(tmp_path / n / "episode_0.hdf5") for n in ("port", "jax"))
    assert got.keys() == want.keys()
    for key in want:
        if key != "attrs":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["intervention"].any() and not got["intervention"].all()


def test_chw_cameras_fail_the_mp4_export_in_both_packages(tmp_path):
    """The client's robots send CHW cameras (``SimRobot``, ``ReplayHDF5Robot``, the ROS adapters) and the DAgger
    driver records them as sent, but the collector's mp4 writer takes HWC: at ``SimRobot``'s 3x224x224 both
    packages fail the same way, after the HDF5 file is written."""
    import cv2

    for pkg, name in ((dagger, "port"), (jax_dagger, "jax")):
        collector = pkg.DAggerCollector(["top"], tmp_path / name)
        collector.start_collection()
        collector.add_frame({"qpos": np.zeros(14), "images": {"top": np.zeros((3, 224, 224), np.uint8)}},
                             np.zeros(14))
        with pytest.raises(cv2.error):
            collector.save_episode()
        assert (tmp_path / name / "episode_0.hdf5").exists()
