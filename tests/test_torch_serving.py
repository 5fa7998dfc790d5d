"""The port's websocket server and ``scripts/serve_policy_torch.py``: one request round-trips on the CPU.

A dummy π₀.₅ (``debug_pi05``) is written to ``model.safetensors`` by the port's
writer; ``serve_policy_torch.create_policy`` serves it through
``create_trained_policy`` on the CPU behind the port's
``WebsocketPolicyServer``, and the in-repo client gets the same actions as
the same policy called directly (both draw the noise from a generator seeded
with 0).
"""

import importlib.util
import pathlib
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from _torch_parity import model_inputs
from kai0_tpu_torch import interop
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.serving import websocket_policy_server
from kai0_tpu_torch.training import config as torch_config

REPO = pathlib.Path(__file__).resolve().parents[1]


def _script():
    spec = importlib.util.spec_from_file_location("serve_policy_torch", REPO / "scripts" / "serve_policy_torch.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model = torch_pi0.Pi0(torch_config.get_config("debug_pi05").model, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    ckpt = tmp_path_factory.mktemp("debug_pi05")
    interop.save_torch_checkpoint(model, ckpt)
    return ckpt


def _unbatched(inputs: dict) -> dict:
    return {k: ({n: x[0] for n, x in v.items()} if isinstance(v, dict) else v[0]) for k, v in inputs.items()}


def test_script_serves_a_checkpoint_over_the_websocket(checkpoint):
    script = _script()
    args = script.parse_args(["policy:checkpoint", "--policy.config=debug_pi05", f"--policy.dir={checkpoint}",
                              "--device=cpu", "--warmup"])
    policy = script.create_policy(args)
    port = _free_port()
    server = websocket_policy_server.WebsocketPolicyServer(policy, host="127.0.0.1", port=port,
                                                           metadata={"backend": "torch"})
    threading.Thread(target=server.serve_forever, daemon=True).start()
    time.sleep(0.3)

    import kai0_tpu.serving  # noqa: F401  (puts the in-repo client package on sys.path)
    from kai0_client.websocket_client_policy import WebsocketClientPolicy

    obs = _unbatched(model_inputs(9, prompt_len=200))
    client = WebsocketClientPolicy(host="127.0.0.1", port=port, retry_interval_s=0.2)
    try:
        assert client.get_server_metadata() == {"backend": "torch"}
        result = client.infer(obs)
        again = client.infer(obs)
    finally:
        client.close()
    direct = script.create_policy(args).infer(obs)  # a fresh generator seeded with 0: the same first noise
    np.testing.assert_array_equal(result["actions"], direct["actions"])
    assert result["actions"].shape == (50, 32) and np.isfinite(result["actions"]).all()
    assert not np.array_equal(again["actions"], result["actions"])  # the next draw of the generator
    timing = again["server_timing"]
    assert {"model_ms", "infer_ms", "transform_ms", "stage_ms", "prev_total_ms"} <= set(timing)


def test_script_refuses_what_is_not_ported(checkpoint):
    from kai0_tpu_torch.policies.policy import Policy
    from kai0_tpu_torch.serving.batching import BatchingPolicy

    script = _script()

    def args(flag):
        return script.parse_args(["policy:checkpoint", "--policy.config=debug_pi05", f"--policy.dir={checkpoint}",
                                  "--device=cpu", flag])

    with pytest.raises(NotImplementedError, match="item 10"):
        script.create_policy(args("--fsdp_devices=2"))
    batched = script.create_policy(args("--max_batch=4"))
    try:
        assert isinstance(batched, BatchingPolicy)
        obs = _unbatched(model_inputs(4, prompt_len=200))
        assert batched.infer(obs)["actions"].shape == (50, 32) and batched.batch_sizes == [1]
    finally:
        batched.close()
    assert isinstance(script.create_policy(args("--batch_wait_ms=5")), Policy)
    with pytest.raises(ValueError, match="--policy.config and --policy.dir"):
        script.create_policy(script.parse_args(["--env=droid", "--device=cpu"]))
    with pytest.raises(ValueError, match="local checkpoint directories only"):
        script.create_policy(script.parse_args(["policy:checkpoint", "--policy.config=debug_pi05",
                                                "--policy.dir=gs://bucket/checkpoint", "--device=cpu"]))


def test_recorder_writes_each_request_and_reply(checkpoint, tmp_path):
    from kai0_tpu_torch.policies.policy import PolicyRecorder

    script = _script()
    args = script.parse_args(["policy:checkpoint", "--policy.config=debug_pi05", f"--policy.dir={checkpoint}",
                              "--device=cpu"])
    recorder = PolicyRecorder(script.create_policy(args), str(tmp_path / "records"))
    obs = _unbatched(model_inputs(3, prompt_len=200))
    out = recorder.infer(obs)
    record = np.load(tmp_path / "records" / "step_0.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(record["outputs/actions"], out["actions"])
    np.testing.assert_array_equal(record["inputs/state"], obs["state"])
    assert recorder.metadata == {}
