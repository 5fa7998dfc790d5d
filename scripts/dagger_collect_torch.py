"""DAgger collection driver over the PyTorch port: policy-in-the-loop episode capture to HDF5.

The port's counterpart of ``train_deploy_alignment/dagger/dagger_collect.py``
(the reference's ``agilex_openpi_dagger_collect.py`` /
``arx_openpi_dagger_collect.py``: keyboard state machine :255-346, HDF5
episode saver), with its flags, over the port's standard-library wire and
``kai0_tpu_torch.deploy.dagger``; it drives a server started by
``scripts/serve_policy_torch.py``:

    python scripts/dagger_collect_torch.py --host <gpu-host> --port 8000 --sim --dataset-dir ./dagger_data

Keys (one a line on stdin): Enter=infer, d=dagger (human takeover; frames
labeled interventions), space=toggle record, s=save episode, r=resume
inference, q=quit. Saving an episode needs ``h5py`` (and ``cv2`` for its
mp4s); without it the save raises naming the package. Episodes convert to
LeRobot with ``scripts/convert_h5_lerobot_torch.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from kai0_tpu_torch.deploy.dagger import DAggerCollector, DaggerStateMachine  # noqa: E402


def _inference_client():
    """``scripts/inference_client_torch.py`` (its ``SimRobot``), loaded by its path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "inference_client_torch.py")
    spec = importlib.util.spec_from_file_location("inference_client_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(policy, robot, teleop, collector: DAggerCollector, sm: DaggerStateMachine,
        prompt: str, publish_rate: float, chunk_exec: int = 25) -> None:
    """Main loop. ``robot``/``teleop`` follow the RobotInterface protocol
    (see inference_client_torch.py); ``teleop`` supplies master-arm actions
    during interventions."""
    pending: list[np.ndarray] = []
    while sm.mode != "quit":
        if sm.consume_save_request():
            path = collector.save_episode()
            print(f"saved {path}" if path else "nothing to save")
            pending.clear()
            continue
        if sm.mode == "idle":
            time.sleep(0.05)
            continue

        obs = robot.get_observation()
        if sm.intervening:
            action = np.asarray(teleop.get_observation()["state"])
            pending.clear()
        else:
            if not pending:
                payload = dict(obs)
                payload["prompt"] = prompt
                pending = list(np.asarray(policy.infer(payload)["actions"])[:chunk_exec])
            action = pending.pop(0)
        robot.publish_action(action)
        if sm.recording and not collector.is_collecting:
            collector.start_collection()
        if collector.is_collecting:
            collector.add_frame(
                {"qpos": obs["state"], "images": obs["images"]},
                action,
                intervention=sm.intervening,
            )
        time.sleep(1.0 / publish_rate)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--prompt", default="fold the cloth")
    parser.add_argument("--dataset-dir", default="./dagger_data")
    parser.add_argument("--task-name", default=None)
    parser.add_argument("--cameras", nargs="+", default=["top_head", "hand_left", "hand_right"])
    parser.add_argument("--publish-rate", type=float, default=25.0)
    parser.add_argument("--sim", action="store_true")
    args = parser.parse_args()

    from kai0_tpu_torch.serving.client import WebsocketClientPolicy

    SimRobot = _inference_client().SimRobot
    policy = WebsocketClientPolicy(host=args.host, port=args.port)
    if not args.sim:
        raise SystemExit(
            "No hardware RobotInterface configured. Implement RobotInterface for your "
            "robot + master arms, or pass --sim."
        )
    robot, teleop = SimRobot(cameras=args.cameras), SimRobot()

    collector = DAggerCollector(args.cameras, args.dataset_dir, task_name=args.task_name)
    sm = DaggerStateMachine()

    # Keyboard thread (best effort: stdin line-based to avoid requiring pynput/root).
    import threading

    def key_loop():
        while sm.mode != "quit":
            try:
                line = input()
            except EOFError:
                sm.on_key("q")
                return
            sm.on_key(line.strip() or "enter")

    threading.Thread(target=key_loop, daemon=True).start()
    run(policy, robot, teleop, collector, sm, args.prompt, args.publish_rate)


if __name__ == "__main__":
    main()
