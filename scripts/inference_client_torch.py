"""Latency-compensated inference client (sync / smoothing / ensembling / RTC) over the PyTorch port.

The port's counterpart of ``train_deploy_alignment/inference/inference_client.py``,
with its four modes, its robots and its flags, over the port's standard-library
wire (``kai0_tpu_torch.serving.client.WebsocketClientPolicy``) and
``kai0_tpu_torch.deploy``; it needs numpy only (``h5py`` and ``cv2`` for
``--replay``) and drives a server started by ``scripts/serve_policy_torch.py``:

    python scripts/serve_policy_torch.py policy:checkpoint --policy.config=pi05_rtc_flatten_fold_inference \
        --policy.dir=<checkpoint> --warmup --port 8000
    python scripts/inference_client_torch.py --host <gpu-host> --port 8000 --mode rtc \
        --prompt "Flatten and fold the cloth." --publish-rate 25 --sim

Modes:
  sync       blocking infer → execute the whole chunk (reference *_sync.py)
  smooth     async infer + StreamActionBuffer crossfade (reference *_temporal_smoothing.py)
  ensemble   async infer + ACT-style TemporalEnsemblingBuffer (reference *_temporal_ensembling.py)
  rtc        async infer + server-side RTC guidance + chunk alignment (reference *_rtc.py)

``smooth`` and ``ensemble`` take the C++ buffers of ``kai0_tpu_torch/native``,
built at first use; a failed build raises, and ``KAI0_DISABLE_NATIVE=1``
selects the Python buffers. Hardware robots: ``train_deploy_alignment/inference/ros_robot.py``
(``Ros1Robot``, ``Ros2Robot``; numpy and ROS only) can be loaded by its file
path and passed to the ``run_*`` functions.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from typing import Protocol

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from kai0_tpu_torch.deploy import make_ensembling_buffer, make_stream_buffer  # noqa: E402
from kai0_tpu_torch.deploy.rtc_client import RTCClient  # noqa: E402


class RobotInterface(Protocol):
    """Hardware adapter: ROS topics, CAN bus, or simulation."""

    def get_observation(self) -> dict:
        """Returns {"images": {cam: uint8 CHW/HWC}, "state": float32[D]}."""
        ...

    def publish_action(self, action: np.ndarray) -> None: ...


class SimRobot:
    """Loopback robot for smoke tests: random cameras, echoes the last action."""

    def __init__(self, state_dim: int = 14, cameras=("top_head", "hand_left", "hand_right")):
        self._state = np.zeros(state_dim, dtype=np.float32)
        self._cameras = cameras
        self._rng = np.random.default_rng(0)

    def get_observation(self) -> dict:
        return {
            "images": {
                cam: self._rng.integers(0, 255, (3, 224, 224), dtype=np.uint8)
                for cam in self._cameras
            },
            "state": self._state.copy(),
        }

    def publish_action(self, action: np.ndarray) -> None:
        self._state = np.asarray(action, dtype=np.float32)[: len(self._state)]


class ReplayHDF5Robot:
    """Replay a recorded episode (ALOHA-style HDF5, the DAgger collector's format)
    as the robot: observations come from ``/observations/qpos`` + the per-camera
    mp4s next to the file, and published actions are logged for offline comparison
    against the recorded ``/action`` track.

    This proves the full client loop (transforms → websocket → chunk buffers →
    publish cadence) against REAL recorded data without hardware — the gap the
    reference fills with robot-specific ROS nodes
    (train_deploy_alignment/inference/agilex/..._rtc.py:853-1279).
    """

    def __init__(self, episode_path, cameras=("top_head", "hand_left", "hand_right"), loop=True):
        import pathlib

        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"ReplayHDF5Robot needs h5py to read {episode_path}, and it does not import here ({e})") from e

        path = pathlib.Path(episode_path)
        with h5py.File(path, "r") as f:
            self.qpos = np.asarray(f["observations/qpos"], dtype=np.float32)
            self.recorded_actions = np.asarray(f["action"], dtype=np.float32)
        self._frames = {cam: self._load_video(path, cam) for cam in cameras}
        self._cameras = cameras
        self._loop = loop
        self._t = 0
        self.published: list[np.ndarray] = []

    @staticmethod
    def _load_video(episode_path, cam):
        import cv2

        video = episode_path.parent / "video" / cam / f"{episode_path.stem}.mp4"
        if not video.exists():
            return None
        cap = cv2.VideoCapture(str(video))
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[..., ::-1].copy())  # BGR -> RGB
        cap.release()
        return frames

    @property
    def exhausted(self) -> bool:
        return not self._loop and self._t >= len(self.qpos)

    def get_observation(self) -> dict:
        t = self._t % len(self.qpos) if self._loop else min(self._t, len(self.qpos) - 1)
        images = {}
        for cam in self._cameras:
            frames = self._frames[cam]
            if frames:
                img = frames[min(t, len(frames) - 1)]
            else:  # episode saved without video export
                img = np.zeros((224, 224, 3), np.uint8)
            images[cam] = np.transpose(img, (2, 0, 1))  # CHW, like the ROS clients send
        return {"images": images, "state": self.qpos[t].copy()}

    def publish_action(self, action: np.ndarray) -> None:
        self.published.append(np.asarray(action, dtype=np.float32))
        self._t += 1

    def tracking_error(self) -> np.ndarray | None:
        """Per-step |published − recorded| over the overlap, for offline eval."""
        if not self.published:
            return None
        n = min(len(self.published), len(self.recorded_actions))
        pub = np.stack(self.published[:n])
        rec = self.recorded_actions[:n, : pub.shape[1]]
        return np.abs(pub[:, : rec.shape[1]] - rec)


class KalmanSmoothedRobot:
    """Wrap a RobotInterface so published actions are Kalman-smoothed.

    Reference ``--use_kalman_filter`` (agilex_openpi_dagger_collect.py:849-851):
    the raw policy action is filtered per dim before interpolation/publish.
    """

    def __init__(self, robot):
        from kai0_tpu_torch.deploy.dagger import KalmanFilter

        self._robot = robot
        self._kf = KalmanFilter()

    def get_observation(self) -> dict:
        return self._robot.get_observation()

    def publish_action(self, action: np.ndarray) -> None:
        self._robot.publish_action(np.asarray(self._kf.update(action), dtype=np.float32))


def run_sync(policy, robot, prompt: str, publish_rate: float, max_steps: int):
    """Blocking infer → execute loop (reference agilex_inference_openpi_sync.py)."""
    steps = 0
    while steps < max_steps:
        obs = robot.get_observation()
        obs["prompt"] = prompt
        actions = np.asarray(policy.infer(obs)["actions"])
        for action in actions:
            robot.publish_action(action)
            steps += 1
            if steps >= max_steps:
                break
            time.sleep(1.0 / publish_rate)


def run_smooth(policy, robot, prompt: str, publish_rate: float, infer_rate: float,
               max_steps: int, max_k: int = 10, min_m: int = 8):
    """Async inference thread + crossfade buffer (reference *_temporal_smoothing.py)."""
    buf = make_stream_buffer()  # C++ core when available (GIL-free publish loop)
    stop = threading.Event()

    def infer_loop():
        while not stop.is_set():
            obs = robot.get_observation()
            obs["prompt"] = prompt
            actions = np.asarray(policy.infer(obs)["actions"])
            buf.integrate_new_chunk(actions, max_k=max_k, min_m=min_m)
            time.sleep(1.0 / infer_rate)

    t = threading.Thread(target=infer_loop, daemon=True)
    t.start()
    steps = 0
    try:
        while steps < max_steps:
            action = buf.pop_next_action()
            if action is not None:
                robot.publish_action(action)
                steps += 1
            time.sleep(1.0 / publish_rate)
    finally:
        stop.set()
        t.join(timeout=5)


def run_ensemble(policy, robot, prompt: str, publish_rate: float, infer_rate: float,
                 max_steps: int, exp_weight_m: float = 0.01):
    """Async inference + ACT-style ensembling (reference *_temporal_ensembling.py)."""
    buf = make_ensembling_buffer(exp_weight_m=exp_weight_m)
    stop = threading.Event()

    def infer_loop():
        while not stop.is_set():
            obs = robot.get_observation()
            obs["prompt"] = prompt
            actions = np.asarray(policy.infer(obs)["actions"])
            buf.add_chunk(actions)
            time.sleep(1.0 / infer_rate)

    t = threading.Thread(target=infer_loop, daemon=True)
    t.start()
    steps = 0
    try:
        while steps < max_steps:
            action = buf.step()
            if action is not None:
                robot.publish_action(action)
                steps += 1
            time.sleep(1.0 / publish_rate)
    finally:
        stop.set()
        t.join(timeout=5)


def run_rtc(policy, robot, prompt: str, publish_rate: float, max_steps: int,
            execute_horizon: int = 25, max_guidance_weight: float = 5.0):
    """RTC rounds: guided inference + aligned execution (reference *_rtc.py)."""
    client = RTCClient(
        policy,
        execute_horizon=execute_horizon,
        publish_rate=publish_rate,
        max_guidance_weight=max_guidance_weight,
    )
    steps = 0
    while steps < max_steps:
        obs = robot.get_observation()
        obs["prompt"] = prompt
        to_execute = client.infer_round(obs)
        for action in to_execute:
            robot.publish_action(action)
            steps += 1
            if steps >= max_steps:
                break
            time.sleep(1.0 / publish_rate)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--mode", choices=["sync", "smooth", "ensemble", "rtc"], default="smooth")
    parser.add_argument("--prompt", default="fold the cloth")
    parser.add_argument("--publish-rate", type=float, default=25.0)
    parser.add_argument("--infer-rate", type=float, default=4.0)
    parser.add_argument("--max-steps", type=int, default=10_000)
    parser.add_argument("--execute-horizon", type=int, default=25)
    parser.add_argument("--max-guidance-weight", type=float, default=5.0)
    parser.add_argument("--sim", action="store_true", help="Use the loopback SimRobot")
    parser.add_argument("--replay", default=None, metavar="EPISODE_HDF5",
                        help="Use ReplayHDF5Robot on a recorded episode instead of hardware")
    parser.add_argument("--use-kalman-filter", action="store_true",
                        help="Kalman-smooth published actions (reference --use_kalman_filter)")
    args = parser.parse_args()

    from kai0_tpu_torch.serving.client import WebsocketClientPolicy

    policy = WebsocketClientPolicy(host=args.host, port=args.port)
    if args.replay:
        robot = ReplayHDF5Robot(args.replay)
    elif args.sim:
        robot = SimRobot()
    else:
        raise SystemExit(
            "No hardware RobotInterface configured. Implement RobotInterface for your "
            "robot (ROS topics → get_observation/publish_action), or pass --sim / "
            "--replay <episode.hdf5>."
        )
    if args.use_kalman_filter:
        robot = KalmanSmoothedRobot(robot)

    if args.mode == "sync":
        run_sync(policy, robot, args.prompt, args.publish_rate, args.max_steps)
    elif args.mode == "smooth":
        run_smooth(policy, robot, args.prompt, args.publish_rate, args.infer_rate, args.max_steps)
    elif args.mode == "ensemble":
        run_ensemble(policy, robot, args.prompt, args.publish_rate, args.infer_rate, args.max_steps)
    else:
        run_rtc(policy, robot, args.prompt, args.publish_rate, args.max_steps,
                args.execute_horizon, args.max_guidance_weight)


if __name__ == "__main__":
    main()
