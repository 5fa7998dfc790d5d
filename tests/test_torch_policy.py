"""``kai0_tpu_torch`` Policy against ``kai0_tpu`` Policy, the websocket server, and the no-JAX rule.

Same debug-size weights (zero-initialised leaves perturbed) and the same noise:
actions agree within 1e-3, the action-fidelity bar of BASELINE.md.
"""

import pathlib
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import kai0_tpu.serving  # noqa: F401  (adds the in-repo client package to sys.path)
from _torch_parity import debug_models, model_inputs
from kai0_client.websocket_client_policy import WebsocketClientPolicy
from kai0_tpu.policies import policy as jax_policy
from kai0_tpu.serving.websocket_policy_server import WebsocketPolicyServer
from kai0_tpu_torch.policies import policy as torch_policy

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    return debug_models(seed=0)


def _unbatched(inputs: dict) -> dict:
    return {k: ({n: x[0] for n, x in v.items()} if isinstance(v, dict) else v[0]) for k, v in inputs.items()}


def test_infer_matches_jax_policy(models):
    jax_config, params, torch_config, model = models
    obs = _unbatched(model_inputs(6))
    noise = np.random.default_rng(8).standard_normal((50, 32)).astype(np.float32)
    ref = jax_policy.Policy(jax_config, params).infer(obs, noise=noise)
    out = torch_policy.Policy(model, torch_config, device="cpu").infer(obs, noise=noise)
    assert set(out) == {"state", "actions", "policy_timing"}
    assert isinstance(out["actions"], np.ndarray) and out["actions"].shape == (50, 32)
    np.testing.assert_array_equal(out["state"], obs["state"])
    np.testing.assert_allclose(out["actions"], np.asarray(ref["actions"]), rtol=0, atol=1e-3)
    assert {"infer_ms", "transform_ms", "stage_ms"} <= set(out["policy_timing"])


def test_int8_infer_matches_jax_quantized_policy(models):
    """``quantize_inference_tree`` on both sides, the same weights and noise.

    Every int8 operation is bit-equal on equal inputs, but the two packages'
    activations differ by f32 rounding, which flips an activation code now and
    then (``test_torch_lora_int8_train.py``): measured max abs difference of
    the actions 1.8e-3, held to 5e-3; against the unquantized model the int8
    actions move by 6.3e-3.
    """
    import copy

    from kai0_tpu.ops import quant as jax_quant
    from kai0_tpu_torch.ops import quant

    jax_config, params, torch_config, model = models
    obs = _unbatched(model_inputs(6))
    noise = np.random.default_rng(8).standard_normal((50, 32)).astype(np.float32)
    ref = jax_policy.Policy(jax_config, jax_quant.quantize_inference_tree(params)).infer(obs, noise=noise)
    served = quant.quantize_inference_tree(copy.deepcopy(model))
    assert quant.has_quant(served) and not quant.has_quant(model)
    assert sum(quant.is_quant(m) for m in served.modules()) == 2 * 4 * 6  # every Gemma site of both experts
    out = torch_policy.Policy(served, torch_config, device="cpu").infer(obs, noise=noise)
    plain = torch_policy.Policy(model, torch_config, device="cpu").infer(obs, noise=noise)
    err = np.abs(out["actions"] - np.asarray(ref["actions"])).max()
    moved = np.abs(out["actions"] - plain["actions"]).max()
    assert np.isfinite(out["actions"]).all() and err <= 5e-3, err
    assert moved > 2 * err, (moved, err)  # int8 perturbs the actions by design, more than the packages differ


def test_transforms_run_around_the_model(models):
    _, _, torch_config, model = models
    seen = []

    def record_prompt_length(data):
        seen.append(int(np.asarray(data["tokenized_prompt_mask"]).sum()))
        return data

    def take_14(data):
        return {**data, "actions": data["actions"][:, :14]}

    policy = torch_policy.Policy(
        model, torch_config, device="cpu", transforms=[record_prompt_length], output_transforms=[take_14]
    )
    obs = _unbatched(model_inputs(6))
    noise = np.zeros((50, 32), np.float32)
    out = policy.infer(obs, noise=noise)
    assert seen == [20] and out["actions"].shape == (50, 14)
    # The caller's dict is not modified by the copy-then-transform.
    assert obs["state"].shape == (32,)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_websocket_roundtrip_serves_the_port(models):
    _, _, torch_config, model = models

    def make_policy():
        return torch_policy.Policy(model, torch_config, device="cpu", generator=torch.Generator().manual_seed(3))

    port = _free_port()
    server = WebsocketPolicyServer(make_policy(), host="127.0.0.1", port=port, metadata={"backend": "torch"})
    threading.Thread(target=server.serve_forever, daemon=True).start()
    time.sleep(0.3)

    obs = _unbatched(model_inputs(9))
    client = WebsocketClientPolicy(host="127.0.0.1", port=port, retry_interval_s=0.2)
    try:
        assert client.get_server_metadata() == {"backend": "torch"}
        result = client.infer(obs)
    finally:
        client.close()
    direct = make_policy().infer(obs)  # same generator seed -> same noise
    np.testing.assert_array_equal(result["actions"], direct["actions"])
    assert np.isfinite(result["actions"]).all()
    assert "model_ms" in result["server_timing"] and "infer_ms" in result["server_timing"]


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import kai0_tpu_torch\n"
        "for m in pkgutil.walk_packages(kai0_tpu_torch.__path__, 'kai0_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'kai0_tpu' or m.startswith('kai0_tpu.'))\n"
        "assert 'kai0_tpu_torch.policies.policy' in sys.modules\n"
        "assert 'kai0_tpu_torch.training.train_lib' in sys.modules\n"
        "print(bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_chip_smoke_needs_a_card_and_imports_no_jax(tmp_path):
    """``chip_smoke.py`` imports nothing of JAX, and without a card it fails and prints no result."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m for m in imported if m.split(".")[0] in ("jax", "kai0_tpu")}, imported
    assert any(m.startswith("kai0_tpu_torch.training") for m in imported)
    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout, (proc.returncode, proc.stdout)
