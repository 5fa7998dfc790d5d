"""The sampler as a CUDA graph (``policies/graphs.py``) against the eager sampler, on the card.

This file imports no JAX, so that the card's machine can run it without the
repository's conftest:

    python -m pytest tests/test_torch_graphs_cuda.py -m cuda --noconftest -q

The model is π₀.₅ at full width (the kernels take Gemma's head_dim 256 and
SigLIP's 72 only) cut to one layer of each tower, bf16, seeded weights. A
graph replays the kernels the eager ``sample_actions`` launches on the same
staged inputs and noise, so its actions are bit-equal; a capture counts one
request's launches and a replay none; the graph of a prompt bucket is
captured once and then reused; requests from several threads at once each get
their own actions. The RTC sampler (``Pi0RTC``) as a graph, its vjp captured
with it, gives the eager sampler's bits for any delay and horizon, which are
data; ``infer_batch`` replays one graph for each padded batch size.
"""

from concurrent import futures
import dataclasses
import threading

import numpy as np
import pytest
import torch

from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.models.pi0 import Pi0, Pi0Config
from kai0_tpu_torch.models.pi0_rtc import Pi0RTC
from kai0_tpu_torch.ops import quant
from kai0_tpu_torch.policies import graphs
from kai0_tpu_torch.policies.policy import Policy

DEPTH = 1


@dataclasses.dataclass(frozen=True)
class _OneLayer(Pi0Config):
    """Full width, every tower cut to ``DEPTH`` layers."""

    @property
    def paligemma_config(self):
        return dataclasses.replace(super().paligemma_config, depth=DEPTH)

    @property
    def action_expert_config(self):
        return dataclasses.replace(super().action_expert_config, depth=DEPTH)

    @property
    def vision_config(self):
        return dataclasses.replace(super().vision_config, depth=DEPTH)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    config = _OneLayer(pi05=True)
    return Pi0(config, device="cuda", param_dtype=torch.bfloat16).init_weights(
        torch.Generator(device="cuda").manual_seed(0)).eval()


def _request(seed: int, used: int) -> dict:
    """A model-facing request as the transform chain leaves it: 224×224 uint8 cameras, a prompt of ``used`` tokens."""
    rng = np.random.default_rng(seed)
    keys = _model.IMAGE_KEYS
    mask = np.zeros(200, bool)
    mask[:used] = True
    return {
        "image": {k: rng.integers(0, 256, (224, 224, 3), dtype=np.uint8) for k in keys},
        "image_mask": {k: np.bool_(k != "right_wrist_0_rgb") for k in keys},
        "state": rng.standard_normal(32).astype(np.float32),
        "tokenized_prompt": np.where(mask, rng.integers(0, 257_152, 200), 0).astype(np.int32),
        "tokenized_prompt_mask": mask,
    }


def _eager(model, policy: Policy, obs: dict, noise: np.ndarray) -> tuple[np.ndarray, dict]:
    """``model.sample_actions`` on the policy's staged inputs and the same noise, and its launches."""
    staged = policy.stage_inputs(obs)
    batched = {k: ({n: torch.from_numpy(x).cuda() for n, x in v.items()} if isinstance(v, dict)
                   else torch.from_numpy(v).cuda()) for k, v in staged.items()}
    before = graphs.launch_counts()
    actions = model.sample_actions(_model.Observation.from_dict(batched), noise=torch.from_numpy(noise[None]).cuda())
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in graphs.launch_counts().items()}
    return actions[0].cpu().numpy(), launches


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_graphed_sampler_is_bit_equal_to_eager(model, int8):
    if int8:
        model = quant.quantize_inference_tree(Pi0(model.config, device="cuda", param_dtype=torch.bfloat16).init_weights(
            torch.Generator(device="cuda").manual_seed(0)).eval())
    policy = Policy(model, model.config, device="cuda")
    obs, noise = _request(1, 20), np.random.default_rng(2).standard_normal((50, 32)).astype(np.float32)
    out = policy.infer(obs, noise=noise)
    (graph,) = policy.graphs.values()
    eager, launches = _eager(model, policy, obs, noise)
    assert out["actions"].shape == (50, 32) and np.isfinite(out["actions"]).all()
    assert np.array_equal(out["actions"], eager)
    want = {"flash_mha": DEPTH * 11, "flash_mhsa": DEPTH}
    if int8:
        want.update(row_quant=DEPTH * 11 * 5, int8_matmul=DEPTH * 11 * 6)  # per layer and pass: 5 and 6
    assert {k: v for k, v in graph.capture_launches.items() if v} == want
    assert launches == graph.capture_launches


@pytest.mark.cuda
def test_each_bucket_has_its_graph_and_replays_bit_equal(model):
    policy = Policy(model, model.config, device="cuda", prompt_buckets=[32, 64])
    noise = np.random.default_rng(3).standard_normal((50, 32)).astype(np.float32)
    for used, bucket in ((20, 32), (50, 64), (120, 200)):
        obs = _request(used, used)
        assert policy.stage_inputs(obs)["tokenized_prompt"].shape == (1, bucket)
        out = policy.infer(obs, noise=noise)
        assert np.array_equal(out["actions"], _eager(model, policy, obs, noise)[0]), bucket
    assert len(policy.graphs) == 3


@pytest.mark.cuda
def test_second_request_reuses_the_graph(model):
    policy = Policy(model, model.config, device="cuda", generator=torch.Generator(device="cuda").manual_seed(4))
    obs = _request(5, 30)
    noise = np.random.default_rng(6).standard_normal((50, 32)).astype(np.float32)
    first = policy.infer(obs, noise=noise)
    (graph,) = policy.graphs.values()
    before = graphs.launch_counts()
    again = policy.infer(obs, noise=noise)
    drawn = policy.infer(obs)  # noise from the generator, drawn outside the graph
    assert graphs.launch_counts() == before  # a replay calls no kernel wrapper
    assert list(policy.graphs.values()) == [graph]
    assert np.array_equal(first["actions"], again["actions"])
    assert not np.array_equal(drawn["actions"], first["actions"]) and np.isfinite(drawn["actions"]).all()
    assert policy.warmup() >= 0 and len(policy.graphs) == 1  # the full prompt length: the graph already there


@pytest.mark.cuda
def test_concurrent_requests_each_get_their_own_actions(model):
    """Threads share a bucket's graph buffers (the server runs ``infer`` in a thread pool); the first round also
    captures both buckets' graphs while the other threads wait."""
    policy = Policy(model, model.config, device="cuda", prompt_buckets=[32, 64])
    requests = [(_request(10 + i, used), np.random.default_rng(20 + i).standard_normal((50, 32)).astype(np.float32))
                for i, used in enumerate((20, 20, 50, 50))]
    want = [_eager(model, policy, obs, noise)[0] for obs, noise in requests]
    barrier = threading.Barrier(len(requests))

    def client(i: int) -> list[np.ndarray]:
        obs, noise = requests[i]
        out = []
        for _ in range(3):
            barrier.wait()
            out.append(policy.infer(obs, noise=noise)["actions"])
        return out

    with futures.ThreadPoolExecutor(len(requests)) as pool:
        results = list(pool.map(client, range(len(requests))))
    assert len(policy.graphs) == 2
    for i, actions in enumerate(results):
        for a in actions:
            assert np.array_equal(a, want[i]), i


def _rtc_model(int8: bool) -> Pi0RTC:
    model = Pi0RTC(_OneLayer(pi05=True), device="cuda", param_dtype=torch.bfloat16).init_weights(
        torch.Generator(device="cuda").manual_seed(0)).eval()
    return quant.quantize_inference_tree(model) if int8 else model


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_rtc_graph_is_bit_equal_to_eager(int8):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    model = _rtc_model(int8)
    policy = Policy(model, model.config, device="cuda")
    obs, noise = _request(1, 20), np.random.default_rng(2).standard_normal((50, 32)).astype(np.float32)
    chunk = np.random.default_rng(3).uniform(-1, 1, (50, 14)).astype(np.float32)
    staged = policy.stage_inputs(obs)
    batched = {k: ({n: torch.from_numpy(x).cuda() for n, x in v.items()} if isinstance(v, dict)
                   else torch.from_numpy(v).cuda()) for k, v in staged.items()}
    for delay, horizon in ((2, 25), (0, 50), (7, 12)):
        request = {**obs, "prev_action_chunk": chunk, "inference_delay": delay, "execute_horizon": horizon}
        out = policy.infer(request, noise=noise)["actions"]
        before = graphs.launch_counts()
        eager = model.sample_actions(_model.Observation.from_dict(batched), noise=torch.from_numpy(noise[None]).cuda(),
                                     prev_action_chunk=chunk, inference_delay=delay, execute_horizon=horizon)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in graphs.launch_counts().items()}
        assert np.array_equal(out, eager[0].cpu().numpy()), (delay, horizon)
    (graph,) = policy.graphs.values()  # one graph served every delay and horizon
    want = {"flash_mha": DEPTH * 11, "flash_mha_bwd": DEPTH * 10, "flash_mhsa": DEPTH}
    capture = {k: v for k, v in graph.capture_launches.items() if v}
    assert {k: capture[k] for k in want} == want and launches == graph.capture_launches
    if int8:
        assert capture["row_quant_colscale"] == DEPTH * 10 * 6 and capture["int8_matmul"] == DEPTH * (11 * 6 + 10 * 8)
    unguided = policy.infer(obs, noise=noise)["actions"]  # the scrubbed base step: a second graph
    assert len(policy.graphs) == 2 and not np.array_equal(unguided, out)


@pytest.mark.cuda
def test_infer_batch_replays_one_graph_per_padded_size(model):
    policy = Policy(model, model.config, device="cuda")
    requests = [_request(30 + i, 20) for i in range(3)]
    noise = np.random.default_rng(9).standard_normal((3, 50, 32)).astype(np.float32)
    first = policy.infer_batch(requests, noise=noise, pad_to=4)
    before = graphs.launch_counts()
    again = policy.infer_batch(requests, noise=noise, pad_to=4)
    assert graphs.launch_counts() == before and len(policy.graphs) == 1
    assert list(policy.graphs.values())[0].noise_shape[0] == 4
    for i, (a, b) in enumerate(zip(first, again, strict=True)):
        assert np.array_equal(a["actions"], b["actions"]) and a["policy_timing"]["batch_size"] == 3
        alone = policy.infer(requests[i], noise=noise[i])["actions"]
        scale = np.abs(alone).max()
        assert np.abs(alone - a["actions"]).max() <= 0.1 * scale, i  # other kernel shapes: bf16 rounding apart
