"""Batched requests: ``Policy.infer_batch`` against the JAX package's, and the port's ``BatchingPolicy``.

- ``infer_batch`` of both packages' ``create_trained_policy`` (dummy π₀.₅,
  bf16 weights as served, prompt buckets [64, 128]) on raw Agilex
  observations with the same noise: actions within 1e-3 (BASELINE.md:27),
  for a batch of two, and for three observations of two prompt buckets padded
  to 4 (one common bucket, row 0 repeated); ``policy_timing`` is
  ``{infer_ms, batch_size}``; RTC keys raise ``ValueError``.
- The three ``BatchingPolicy`` tests of ``tests/test_serving.py``, on the
  port's batcher, server and client: concurrent requests coalesce into
  power-of-two padded batches, RTC requests bypass the queue, errors reach the
  caller, and concurrent clients through the server each get their own
  actions. The port's ``warmup`` raises where a batch size fails.
"""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest

from _torch_parity import DEBUG, debug_models
from kai0_tpu import interop as jax_interop
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.policies import agilex_policy as jax_agilex
from kai0_tpu.policies import policy_config as jax_policy_config
from kai0_tpu.shared import normalize as jax_normalize
from kai0_tpu.training import config as jax_config_module
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.policies import policy_config
from kai0_tpu_torch.serving.batching import BatchingPolicy
from kai0_tpu_torch.serving.client import WebsocketClientPolicy
from kai0_tpu_torch.serving.websocket_policy_server import WebsocketPolicyServer
from kai0_tpu_torch.training import config as torch_config_module

CONFIG = "pi05_flatten_fold_normal"
ASSET_ID = "data/FlattenFold/base"


@pytest.fixture(scope="module")
def policies(tmp_path_factory):
    """(JAX policy, the port's policy) from one dummy π₀.₅ checkpoint with quantile norm stats."""
    jax_model_config, params, _, _ = debug_models(seed=2)
    ckpt = tmp_path_factory.mktemp("ckpt")
    jax_interop.save_torch_checkpoint(params, jax_model_config, ckpt)
    rng = np.random.default_rng(3)
    lo = rng.uniform(-1.5, -0.5, 32)
    stat = jax_normalize.NormStats(mean=np.zeros(32), std=np.ones(32), q01=lo, q99=lo + rng.uniform(1, 3, 32))
    jax_normalize.save(ckpt / "assets" / ASSET_ID, {"state": stat, "actions": stat})
    jax_cfg = dataclasses.replace(jax_config_module.get_config(CONFIG), model=jax_pi0.Pi0Config(**DEBUG))
    torch_cfg = dataclasses.replace(torch_config_module.get_config(CONFIG), model=torch_pi0.Pi0Config(**DEBUG))
    return (jax_policy_config.create_trained_policy(jax_cfg, ckpt, prompt_buckets=[64, 128]),
            policy_config.create_trained_policy(torch_cfg, ckpt, prompt_buckets=[64, 128], device="cpu"))


def _observations(n: int, long_prompt: tuple[int, ...] = ()) -> list[dict]:
    np.random.seed(21)
    out = []
    for i in range(n):
        obs = jax_agilex.make_agilex_example()
        obs["state"] = (obs["state"] * (1 + 0.2 * i)).astype(np.float32)
        if i in long_prompt:  # tokenizes past the 64 bucket
            obs["prompt"] = " ".join(["fold the cloth neatly along the seam"] * 12)
        out.append(obs)
    return out


@pytest.mark.parametrize("n, pad_to, long_prompt", [(2, None, ()), (3, 4, (1,))])
def test_infer_batch_matches_jax(policies, n, pad_to, long_prompt):
    jax_policy, torch_policy = policies
    obs = _observations(n, long_prompt)
    staged = [torch_policy.stage_inputs(o)["tokenized_prompt"].shape[-1] for o in obs]
    assert len(set(staged)) == (2 if long_prompt else 1), staged
    noise = np.random.default_rng(5).standard_normal((n, 50, 32)).astype(np.float32)
    ref = jax_policy.infer_batch(obs, noise=noise, pad_to=pad_to)
    got = torch_policy.infer_batch(obs, noise=noise, pad_to=pad_to)
    assert len(got) == len(ref) == n
    for i, (a, b) in enumerate(zip(got, ref, strict=True)):
        assert a["actions"].shape == np.asarray(b["actions"]).shape == (50, 14)
        err = float(np.abs(a["actions"] - np.asarray(b["actions"])).max())
        print(f"n={n} pad_to={pad_to} row {i}: max abs difference {err:.3e}")
        assert err <= 1e-3, (i, err)
        assert a["policy_timing"]["batch_size"] == n and set(a["policy_timing"]) == {"infer_ms", "batch_size"}
    # The rows are the observations' own: row 0 alone (its own bucket, the same noise row) is close to it.
    alone = torch_policy.infer(obs[0], noise=noise[0])["actions"]
    assert np.abs(alone - got[0]["actions"]).max() <= 1e-3
    with pytest.raises(ValueError, match="dispatch solo"):
        torch_policy.infer_batch([{**obs[0], "prev_action_chunk": np.zeros((50, 14), np.float32)}])


# ---------------------------------------------------------------------------
# BatchingPolicy (the tests of tests/test_serving.py on the port's batcher, server and client)
# ---------------------------------------------------------------------------


class _BatchRecordingPolicy:
    """Stub policy that records how requests were dispatched."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s
        self.solo_calls = 0
        self.batch_calls = []  # (n, pad_to)
        self.metadata = {"stub": True}
        self.model_config = None

    def infer(self, obs: dict) -> dict:
        time.sleep(self.delay_s)
        self.solo_calls += 1
        return {"actions": np.asarray(obs["state"]) * 2.0}

    def infer_batch(self, obs_list, *, noise=None, pad_to=None) -> list[dict]:
        time.sleep(self.delay_s)
        self.batch_calls.append((len(obs_list), pad_to))
        return [{"actions": np.asarray(obs["state"]) * 2.0} for obs in obs_list]

    def reset(self) -> None:
        pass

    def warmup(self, example=None) -> float:
        return 0.0


def test_batching_policy_coalesces_concurrent_requests():
    inner = _BatchRecordingPolicy(delay_s=0.05)
    batcher = BatchingPolicy(inner, max_batch=4, wait_ms=50)
    try:
        states = [np.full(3, i, np.float32) for i in range(6)]
        results = [None] * 6

        def call(i):
            results[i] = batcher.infer({"state": states[i]})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()

        for i in range(6):
            np.testing.assert_allclose(results[i]["actions"], states[i] * 2.0)
        assert inner.batch_calls, f"no batched dispatch (sizes: {batcher.batch_sizes})"
        assert all(n <= 4 for n in batcher.batch_sizes)
        assert sum(batcher.batch_sizes) == 6
        for n, pad_to in inner.batch_calls:
            assert pad_to >= n and (pad_to & (pad_to - 1)) == 0
    finally:
        batcher.close()


def test_batching_policy_rtc_bypass_errors_and_warmup():
    inner = _BatchRecordingPolicy()
    batcher = BatchingPolicy(inner, max_batch=4)
    try:
        out = batcher.infer({"state": np.ones(3, np.float32), "prev_action_chunk": np.zeros((5, 3))})
        np.testing.assert_allclose(out["actions"], 2.0)
        assert inner.solo_calls == 1 and not batcher.batch_sizes  # bypassed the queue

        batcher.warmup({"state": np.ones(3, np.float32)})
        assert inner.batch_calls == [(2, 2), (2, 4)]  # every padded size up to max_batch

        def boom(*args, **kwargs):
            raise RuntimeError("boom")

        inner.infer = boom
        with pytest.raises(RuntimeError, match="boom"):
            batcher.infer({"state": np.ones(3, np.float32)})
        inner.infer_batch = boom
        with pytest.raises(RuntimeError, match="boom"):  # the JAX package logs this and goes on
            batcher.warmup({"state": np.ones(3, np.float32)})
    finally:
        batcher.close()
    with pytest.raises(ValueError, match="max_batch"):
        BatchingPolicy(inner, max_batch=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_websocket_server_with_batching_policy():
    """Concurrent clients through the port's server get their own actions."""
    inner = _BatchRecordingPolicy(delay_s=0.02)
    batcher = BatchingPolicy(inner, max_batch=4, wait_ms=20)
    port = _free_port()
    server = WebsocketPolicyServer(batcher, host="127.0.0.1", port=port, metadata={"stub": True})
    threading.Thread(target=server.serve_forever, daemon=True).start()

    results = [None] * 4

    def call(i):
        client = WebsocketClientPolicy(host="127.0.0.1", port=port, retry_interval_s=0.1)
        for _ in range(3):
            results[i] = client.infer({"state": np.full(3, i, np.float32)})
        client.close()

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for i in range(4):
        np.testing.assert_allclose(results[i]["actions"], np.full(3, i) * 2.0)
    assert max(batcher.batch_sizes) > 1
    batcher.close()
