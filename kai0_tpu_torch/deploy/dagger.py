"""DAgger episode collection: policy-in-the-loop data capture to HDF5 + mp4.

The port's copy of ``kai0_tpu/deploy/dagger.py``, the library form of the
reference's ROS collector
(``train_deploy_alignment/dagger/agilex/agilex_openpi_dagger_collect.py``):

- ``DAggerCollector`` (reference ``SimpleDAggerCollector`` :64-253 +
  ``collect_data.save_data`` :66-135): buffers per-frame observations/actions with
  intervention labels and writes ALOHA-style HDF5 episodes
  (``/observations/{qpos,qvel,effort}``, ``/action``, ``/base_action``) plus
  per-camera mp4 exports under ``video/<cam>/episode_N.mp4``. ``h5py`` and
  ``cv2`` are imported when an episode is saved; without ``h5py`` the save
  raises ``ImportError`` naming it (the frames stay buffered).
- ``DaggerStateMachine`` (reference ``keyboard_monitor_thread`` :255-346): the
  keyboard-driven mode logic (infer / dagger / record / save / resume), decoupled
  from any keyboard backend.
- ``KalmanFilter`` (reference ``SimpleKalmanFilter`` :478-498): per-dim scalar
  Kalman smoothing of executed actions (``--use_kalman_filter`` path :849-851),
  vectorized over the action vector.
- ``MasterArmSwitcher`` (reference ``enter_dagger_mode`` flow :1760-1795 +
  ``enable_master_arms``/``move_masters_to_*``/``switch_masters_to_teach_mode``
  :1592-1679): the master/slave arm hand-off when a human takes over (enable
  masters → safe pose → match slave pose → drag-teach mode) against an
  injectable arm-bus protocol instead of ROS publishers.

Episodes saved here convert to LeRobot format with
``kai0_tpu_torch.augment.convert_h5.convert_h5_to_lerobot``.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np


def _require(module: str, purpose: str):
    """``import module``, or ``ImportError`` naming the package ``DAggerCollector.save_episode`` needs."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"DAggerCollector.save_episode needs {module} to {purpose}, and it does not import here "
                          f"({e})") from e


@dataclasses.dataclass
class _Frame:
    qpos: np.ndarray
    qvel: np.ndarray
    effort: np.ndarray
    action: np.ndarray
    base_action: np.ndarray
    images: dict[str, np.ndarray]
    intervention: bool


class DAggerCollector:
    """Buffers frames during an episode; ``save_episode`` writes HDF5 (+mp4)."""

    def __init__(
        self,
        camera_names: list[str],
        dataset_dir: str | pathlib.Path,
        *,
        task_name: str | None = None,
        fps: float = 30.0,
    ):
        self.camera_names = list(camera_names)
        self.dataset_dir = pathlib.Path(dataset_dir)
        if task_name:
            self.dataset_dir = self.dataset_dir / task_name
        self.fps = fps
        self._frames: list[_Frame] = []
        self.is_collecting = False
        self.episode_idx = self._find_next_episode_idx()

    def _find_next_episode_idx(self) -> int:
        if not self.dataset_dir.exists():
            return 0
        existing = [
            int(p.stem.split("_")[-1])
            for p in self.dataset_dir.glob("episode_*.hdf5")
            if p.stem.split("_")[-1].isdigit()
        ]
        return max(existing, default=-1) + 1

    def start_collection(self) -> None:
        self._frames.clear()
        self.is_collecting = True

    def stop_collection(self) -> None:
        self.is_collecting = False

    @property
    def frame_count(self) -> int:
        return len(self._frames)

    def has_data(self) -> bool:
        return bool(self._frames)

    def add_frame(
        self,
        observation: dict,
        action: np.ndarray,
        *,
        intervention: bool = False,
    ) -> None:
        """Append one frame. ``observation`` needs qpos/qvel/effort/images (+base_vel)."""
        if not self.is_collecting:
            return
        qpos = np.asarray(observation["qpos"], dtype=np.float32)
        self._frames.append(
            _Frame(
                qpos=qpos,
                qvel=np.asarray(observation.get("qvel", np.zeros_like(qpos)), dtype=np.float32),
                effort=np.asarray(observation.get("effort", np.zeros_like(qpos)), dtype=np.float32),
                action=np.asarray(action, dtype=np.float32),
                base_action=np.asarray(observation.get("base_vel", np.zeros(2)), dtype=np.float32),
                images={cam: np.asarray(observation["images"][cam]) for cam in self.camera_names},
                intervention=bool(intervention),
            )
        )

    def discard_episode(self) -> None:
        self._frames.clear()
        self.is_collecting = False

    def save_episode(self, *, export_video: bool = True) -> pathlib.Path | None:
        """Write ``episode_<idx>.hdf5`` (+ per-camera mp4s); returns the HDF5 path."""
        h5py = _require("h5py", "write the episode's HDF5 file")

        if not self._frames:
            return None
        self.dataset_dir.mkdir(parents=True, exist_ok=True)
        path = self.dataset_dir / f"episode_{self.episode_idx}.hdf5"
        n = len(self._frames)
        dim = len(self._frames[0].qpos)

        with h5py.File(path, "w", rdcc_nbytes=1024**2 * 2) as root:
            root.attrs["sim"] = False
            root.attrs["compress"] = False
            obs = root.create_group("observations")
            obs.create_dataset("qpos", data=np.stack([f.qpos for f in self._frames]), shape=(n, dim))
            obs.create_dataset("qvel", data=np.stack([f.qvel for f in self._frames]), shape=(n, dim))
            obs.create_dataset("effort", data=np.stack([f.effort for f in self._frames]), shape=(n, dim))
            root.create_dataset("action", data=np.stack([f.action for f in self._frames]), shape=(n, dim))
            root.create_dataset(
                "base_action", data=np.stack([f.base_action for f in self._frames]), shape=(n, 2)
            )
            # Intervention labels (DAgger: which frames the human corrected).
            root.create_dataset(
                "intervention", data=np.asarray([f.intervention for f in self._frames], dtype=bool)
            )

        if export_video:
            cv2 = _require("cv2", "write the episode's mp4 files")

            video_dir = self.dataset_dir / "video"
            for cam in self.camera_names:
                cam_dir = video_dir / cam
                cam_dir.mkdir(parents=True, exist_ok=True)
                frames = [f.images[cam] for f in self._frames]
                h, w = frames[0].shape[:2]
                writer = cv2.VideoWriter(
                    str(cam_dir / f"episode_{self.episode_idx}.mp4"),
                    cv2.VideoWriter_fourcc(*"mp4v"),
                    self.fps,
                    (w, h),
                )
                for img in frames:
                    if img.dtype != np.uint8:
                        img = (img * 255).astype(np.uint8) if img.max() <= 1.0 else img.astype(np.uint8)
                    writer.write(np.ascontiguousarray(img[..., ::-1]))
                writer.release()

        self._frames.clear()
        self.is_collecting = False
        self.episode_idx += 1
        return path


class DaggerStateMachine:
    """Keyboard-driven DAgger mode logic, decoupled from the keyboard backend.

    States: ``idle`` → ``infer`` (policy executes) ⇄ ``dagger`` (human corrects,
    frames labeled interventions); ``record`` toggles collection; ``save`` ends the
    episode. Feed key events via :meth:`on_key`; poll :attr:`mode` /
    :attr:`recording` from the control loop.
    """

    KEYMAP = {
        "enter": "infer",
        "d": "dagger",
        " ": "toggle_record",
        "s": "save",
        "r": "resume",
        "q": "quit",
    }

    def __init__(self):
        self.mode = "idle"  # idle | infer | dagger | quit
        self.recording = False
        self.save_requested = False

    def on_key(self, key: str) -> str:
        action = self.KEYMAP.get(key.lower(), None)
        if action == "infer":
            self.mode = "infer"
        elif action == "dagger":
            # Human takes over — policy output ignored, frames marked intervention.
            self.mode = "dagger"
        elif action == "toggle_record":
            self.recording = not self.recording
        elif action == "save":
            self.save_requested = True
            self.recording = False
        elif action == "resume":
            self.mode = "infer"
        elif action == "quit":
            self.mode = "quit"
        return self.mode

    @property
    def intervening(self) -> bool:
        return self.mode == "dagger"

    def consume_save_request(self) -> bool:
        req, self.save_requested = self.save_requested, False
        return req


class KalmanFilter:
    """Per-dimension scalar Kalman smoothing of executed actions.

    Exact semantics of the reference ``SimpleKalmanFilter``
    (agilex_openpi_dagger_collect.py:478-498), vectorized over the action
    vector (the reference instantiates one scalar filter per state dim; the
    math is elementwise, so one vector filter is identical). Note the
    reference's idiosyncratic error-estimate update — it feeds back the
    *updated* estimate and scales the innovation by process_variance — which is
    preserved verbatim since it defines the smoothing the robot was tuned with.
    """

    def __init__(self, process_variance: float = 1e-6, measurement_variance: float = 1e-7):
        self.process_variance = process_variance
        self.measurement_variance = measurement_variance
        self.estimate: np.ndarray | None = None
        self.error_estimate: np.ndarray | float = 1.0

    def update(self, measurement: np.ndarray) -> np.ndarray:
        measurement = np.asarray(measurement, dtype=np.float64)
        if self.estimate is None:
            self.estimate = measurement.copy()
            return self.estimate
        gain = self.error_estimate / (self.error_estimate + self.measurement_variance)
        self.estimate = self.estimate + gain * (measurement - self.estimate)
        self.error_estimate = (
            (1 - gain) * self.error_estimate
            + np.abs(self.estimate - measurement) * self.process_variance
        )
        return self.estimate

    def reset(self) -> None:
        self.estimate = None
        self.error_estimate = 1.0


# Reference safe intermediate pose ("same as inference initial pose",
# agilex_openpi_dagger_collect.py:1686-1687).
SAFE_MASTER_POSE = (0.0, 0.32, -0.36, 0.0, 0.24, 0.0, 0.07)


class MasterArmBus:
    """What :class:`MasterArmSwitcher` needs from the robot stack.

    A ROS node implements these with publishers (reference RosOperator
    :1592-1679); tests/sims implement them directly.
    """

    def enable_masters(self, enabled: bool) -> None:  # /teach/master_enable_*
        raise NotImplementedError

    def set_master_config(self, config: str) -> None:  # /teach/master_config_*
        raise NotImplementedError

    def set_teach_mode(self, mode: int) -> None:  # /teach/master_teach_mode_*
        raise NotImplementedError

    def command_master_joints(self, left, right) -> None:  # joint command topics
        raise NotImplementedError

    def slave_positions(self):  # -> (left, right) current puppet joint positions
        raise NotImplementedError


class MasterArmSwitcher:
    """The DAgger hand-off: bring the master arms to the slaves, then free-drag.

    ``enter_dagger_mode`` mirrors the reference flow (:1769-1782): enable both
    masters, hold them at the safe intermediate pose, move them onto the current
    slave pose (so grabbing them causes no jump), then switch to drag-teach
    mode. Commands are re-published ``repeats`` times and poses held at
    ``hold_hz`` for ``move_duration`` — the reference's 3×-publish / 10 Hz / 3 s
    cadence — with an injectable ``sleep`` so tests run instantly.

    ``exit_dagger_mode`` (resume inference) leaves teach mode and disables the
    masters; the reference leaves this implicit in its node shutdown.
    """

    def __init__(
        self,
        bus: MasterArmBus,
        *,
        move_duration: float = 3.0,
        hold_hz: float = 10.0,
        repeats: int = 3,
        sleep=None,
    ):
        import time as _time

        self.bus = bus
        self.move_duration = move_duration
        self.hold_hz = hold_hz
        self.repeats = repeats
        self._sleep = sleep if sleep is not None else _time.sleep
        self.in_teach_mode = False

    def _hold_pose(self, left, right) -> None:
        ticks = max(int(self.move_duration * self.hold_hz), 1)
        for _ in range(ticks):
            self.bus.command_master_joints(left, right)
            self._sleep(1.0 / self.hold_hz)

    def enter_dagger_mode(self) -> bool:
        for _ in range(self.repeats):
            self.bus.enable_masters(True)
            self._sleep(0.05)

        self._hold_pose(list(SAFE_MASTER_POSE), list(SAFE_MASTER_POSE))

        slaves = self.bus.slave_positions()
        if slaves is None:
            return False  # reference aborts when no puppet data is available
        left, right = slaves
        self._hold_pose(list(left), list(right))

        for _ in range(self.repeats):
            self.bus.set_master_config("master")
            self._sleep(0.05)
        for _ in range(self.repeats):
            self.bus.set_teach_mode(1)
            self._sleep(0.05)
        self.in_teach_mode = True
        return True

    def exit_dagger_mode(self) -> None:
        for _ in range(self.repeats):
            self.bus.set_teach_mode(0)
            self._sleep(0.05)
        self.bus.enable_masters(False)
        self.in_teach_mode = False
