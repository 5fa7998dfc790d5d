"""The port's schedules, stochastic rounding, q8 codec, K3 plain version and AdamW against the JAX package.

Inputs come from numpy seeds. Tolerances: schedules within 1e-6 relative (JAX
computes them in f32, the port in f64); the q8 codec and ``adam_q8_leaf_plain``
on identical flat arrays with identical draws: codes equal, scales equal
(within one ulp against the Pallas kernel), decoded values within 1e-6
relative, the update within 1e-6 x its max abs (XLA's exp and fused
arithmetic differ from the port's by ulps, and m = b1·m + (1−b1)·g cancels on
some elements); AdamW with f32 moments within
1e-5 x max |update| (f32 sums of the global norm in another order), with bf16
moments mu equal and the update within 1e-2 x max (nu is rounded
stochastically with another stream: one bf16 ulp is 0.4%).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_torch
from kai0_tpu.ops import pallas_q8
from kai0_tpu.training import optimizer as jax_opt
from kai0_tpu_torch.ops import adam_q8
from kai0_tpu_torch.training import optimizer as opt

STEPS = (0, 1, 999, 1000, 15000, 30000, 40000)


@pytest.mark.parametrize("name", ["CosineDecaySchedule", "RsqrtDecaySchedule"])
def test_schedules_match(name):
    jax_fn = getattr(jax_opt, name)().create()
    port = getattr(opt, name)()
    for step in STEPS:
        np.testing.assert_allclose(port(step), float(jax_fn(jnp.int32(step))), rtol=1e-6, err_msg=str(step))
    assert port(0) == pytest.approx(2.5e-5 / 1001 if name == "CosineDecaySchedule" else 5e-5 / 1001)


def test_stochastic_round_bf16():
    x = torch.full((200_000,), 1.0 + 2**-10, dtype=torch.float32)  # 1/8 of the way from 1 to the next bf16
    a = opt._stochastic_round_bf16(x, torch.Generator().manual_seed(0))
    b = opt._stochastic_round_bf16(x, torch.Generator().manual_seed(0))
    assert a.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert set(a.float().unique().tolist()) == {1.0, 1.0 + 2**-7}
    # Unbiased: the mean of 200k draws is x within 5 standard errors (p = 1/8 of rounding up).
    se = 2**-7 * (0.125 * 0.875 / x.numel()) ** 0.5
    assert abs(a.float().mean().item() - x[0].item()) < 5 * se
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 3.0, -0.5, 0.0, 3.3895e38])
    out = opt._stochastic_round_bf16(special, torch.Generator().manual_seed(1)).float()
    assert torch.isnan(out[0]) and out[1] == float("inf") and out[2] == -float("inf")
    assert out[3:6].tolist() == [3.0, -0.5, 0.0]  # representable values are exact
    negative = opt._stochastic_round_bf16(-x[:1000], torch.Generator().manual_seed(2)).float()
    assert set(negative.unique().tolist()) == {-1.0, -(1.0 + 2**-7)}


def _jax_u(key, n):
    return np.array(jax.random.uniform(key, (adam_q8.num_blocks(n), adam_q8.QBLOCK), jnp.float32))


@pytest.mark.parametrize("shape", [(4096,), (3, 1000)])
@pytest.mark.parametrize("signed", [True, False])
def test_q8_codec_matches(shape, signed):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * np.exp(rng.uniform(-12, 0, shape))).astype(np.float32)
    if not signed:
        x = np.abs(x)
    x.reshape(-1)[::97] = 0.0
    key = jax.random.key(1)
    want = jax_opt._q8_encode(jnp.asarray(x), key, signed=signed)
    q, s = adam_q8.q8_encode(torch.from_numpy(x), torch.from_numpy(_jax_u(key, x.size)), signed=signed)
    assert q.dtype == (torch.int8 if signed else torch.uint8) and q.shape == shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want["s"]))
    decoded = adam_q8.q8_decode(q, s).numpy()
    np.testing.assert_allclose(decoded, np.asarray(jax_opt._q8_decode(want)), rtol=1e-6, atol=0)
    assert (decoded == 0).sum() >= (x == 0).sum()


@pytest.mark.parametrize("shape", [(2, 2048), (3, 1000)])
def test_adam_q8_leaf_plain_matches_the_pallas_kernel(shape):
    """Deterministic mode (u = 0.5) on identical arrays, moments from two earlier encodes."""
    rng = np.random.default_rng(2)
    g = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    m = jax_opt._q8_encode(jnp.asarray(rng.standard_normal(shape) * 1e-4, jnp.float32), jax.random.key(3), signed=True)
    v = jax_opt._q8_encode(jnp.asarray(rng.random(shape) * 1e-6, jnp.float32), jax.random.key(4), signed=False)
    a, b = np.float32(3.1622777), np.float32(2.236068e-8)
    out, nm, nv = pallas_q8.adam_q8_leaf(
        jnp.asarray(g), m["q"], m["s"], v["q"], v["s"], jnp.asarray([a, b]), jnp.asarray([7], jnp.int32),
        b1=0.9, b2=0.95, interpret=True, deterministic=True,
    )
    mq, ms, vq, vs = (torch.from_numpy(np.array(x)) for x in (m["q"], m["s"], v["q"], v["s"]))
    got = adam_q8.adam_q8_leaf(torch.from_numpy(g), mq, ms, vq, vs, float(a), float(b), 7, b1=0.9, b2=0.95,
                               deterministic=True)
    want = np.asarray(out)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(mq.numpy(), np.asarray(nm["q"]))
    np.testing.assert_array_equal(vq.numpy(), np.asarray(nv["q"]))
    np.testing.assert_array_max_ulp(ms.numpy(), np.asarray(nm["s"]), maxulp=1)
    np.testing.assert_array_max_ulp(vs.numpy(), np.asarray(nv["s"]), maxulp=1)


def test_adam_q8_draws_are_unbiased_and_follow_the_seed():
    """Stochastic mode: the same seed gives the same codes; the decoded moment is unbiased over seeds."""
    rng = np.random.default_rng(5)
    g = torch.from_numpy((rng.standard_normal(2048) * 1e-3).astype(np.float32))

    def run(seed):
        mq, vq = torch.zeros(2048, dtype=torch.int8), torch.zeros(2048, dtype=torch.uint8)
        ms, vs = torch.zeros(1), torch.zeros(1)
        adam_q8.adam_q8_leaf(g, mq, ms, vq, vs, 1.0, 1e-8, seed, b1=0.9, b2=0.95)
        return adam_q8.q8_decode(mq, ms), mq

    m0, q0 = run(11)
    assert torch.equal(run(11)[1], q0) and not torch.equal(run(12)[1], q0)
    mean = torch.stack([run(seed)[0] for seed in range(64)]).mean(0)
    exact = 0.1 * g  # m after one step from zero moments
    # One log-grid step is a ratio of exp(7 ln10 / 127) = 1.135; 64 draws bring the mean within ~3% of it.
    rel = ((mean - exact).abs() / exact.abs()).median().item()
    assert rel < 0.01, rel


def test_leaf_table_is_the_prefix_sums_of_the_block_counts():
    firsts, total = adam_q8.leaf_table([1, 2048, 2049, 5000, 4096])
    assert firsts == [0, 1, 2, 4, 7] and total == 9
    assert adam_q8.leaf_table([]) == ([], 0)
    with pytest.raises(ValueError):
        adam_q8.leaf_table([3, 0])


def _q8_tensors(shapes, dtypes, seed):
    """Gradients and q8 moments (codes and scales of seeded f32 moments) for tensors of ``shapes``."""
    rng = np.random.default_rng(seed)
    gs, states = [], []
    for shape, dtype in zip(shapes, dtypes, strict=True):
        gs.append(torch.from_numpy((rng.standard_normal(shape) * 1e-3).astype(np.float32)).to(dtype))
        mq, ms = adam_q8.q8_encode(torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 1e-4), 0.5, signed=True)
        vq, vs = adam_q8.q8_encode(torch.from_numpy(rng.random(shape).astype(np.float32) * 1e-6), 0.5, signed=False)
        states.append([mq, ms, vq, vs])
    return gs, states


@pytest.mark.parametrize("deterministic", [True, False])
def test_adam_q8_leaves_plain_is_the_leaf_plain_on_each_tensor(deterministic):
    """The all-tensors entry on CPU tensors, with and without ``out``, is ``adam_q8_leaf_plain`` tensor by tensor."""
    shapes = [(5,), (3, 1000), (2048,), (2, 2049)]
    gs, states = _q8_tensors(shapes, [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16], 9)
    seeds = [3, 4, 5, 2**31 - 2]
    ref_states = [[x.clone() for x in s] for s in states]
    refs = [adam_q8.adam_q8_leaf_plain(g, *s, 1.7, 2e-8, seed, b1=0.9, b2=0.95, deterministic=deterministic)
            for g, s, seed in zip(gs, ref_states, seeds)]
    for entry, out in ((adam_q8.adam_q8_leaves, None), (adam_q8.adam_q8_leaves_plain, [torch.empty_like(g) for g in gs])):
        got_states = [[x.clone() for x in s] for s in states]
        got = entry(gs, *([s[i] for s in got_states] for i in range(4)), 1.7, 2e-8, seeds, b1=0.9, b2=0.95,
                    deterministic=deterministic, out=out)
        for k, (u, ref) in enumerate(zip(got, refs, strict=True)):
            assert u.dtype == ref.dtype and torch.equal(u, ref)
            assert out is None or u is out[k]
        for a, b in zip(got_states, ref_states, strict=True):
            assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def test_adamw_int8_matches_the_jax_transform_deterministic(monkeypatch):
    """q8 AdamW over ragged tensors, three steps, both packages with u = 0.5: JAX's chain runs
    ``_scale_by_adam_q8`` through its Pallas kernel in interpret mode (tensors of 2048 elements or more take it), the
    port its one-launch kernel's plain version. The updates within 1e-5 x max, as for f32 moments (the global
    norm's f32 sums run in another order); those ulps reach the moments, so their block scales agree within 1e-6
    relative and a code that lies on a rounding boundary may land one step of the log grid away (the tolerance of
    ``tests/test_optimizer.py::test_adamw_q8_sharded_transform_on_mesh`` between JAX's own q8 paths)."""
    from kai0_tpu.parallel import sharding

    rng = np.random.default_rng(8)
    shapes = {"w": (64, 48), "r": (3, 1000), "t": (2048 + 5,), "b": (2, 2048)}
    params = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (0.3 if i == 1 else 0.01)).astype(np.float32) for k, s in shapes.items()}
             for i in range(3)]  # step 1 has a global norm above 1: the clip scales it
    schedule = dict(peak_lr=1e-3, decay_lr=1e-4, warmup_steps=2, decay_steps=10)
    jax_tx = jax_opt.AdamW(state_dtype="int8").create(jax_opt.CosineDecaySchedule(**schedule).create())
    port = opt.AdamW(state_dtype="int8")
    monkeypatch.setenv("KAI0_Q8_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(adam_q8, "adam_q8_leaves", functools.partial(adam_q8.adam_q8_leaves, deterministic=True))
    torch_params = to_torch(params)
    state = port.init(torch_params)
    with sharding.set_mesh(sharding.make_mesh(1, devices=jax.devices()[:1])):  # one device: the per-leaf kernel
        jax_state = jax_tx.init(params)
        for g in grads:
            jax_updates, jax_state = jax_tx.update(g, jax_state, params)
            updates, state = port.update(to_torch(g), state, torch_params, opt.CosineDecaySchedule(**schedule))
            adam_state = jax_state[1]
            for k in params:
                want = np.asarray(jax_updates[k])
                np.testing.assert_allclose(updates[k].numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=k)
                for key in ("mu", "nu"):
                    codes = state[key][k]["q"].numpy().astype(np.int32)
                    want_codes = np.asarray(getattr(adam_state, key)[k]["q"]).astype(np.int32)
                    assert np.abs(codes - want_codes).max() <= 1, (k, key)  # one step of the log grid
                    np.testing.assert_allclose(state[key][k]["s"].numpy(), np.asarray(getattr(adam_state, key)[k]["s"]),
                                               rtol=1e-6, atol=0)


def _adamw_pair(state_dtype):
    rng = np.random.default_rng(6)
    shapes = {"w": (64, 48), "b": (48,), "e": (3000,)}
    params = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (0.3 if i == 1 else 0.01)).astype(np.float32) for k, s in shapes.items()}
             for i in range(3)]  # step 1 has a global norm above 1: the clip scales it
    schedule = dict(peak_lr=1e-3, decay_lr=1e-4, warmup_steps=2, decay_steps=10)
    jax_tx = jax_opt.AdamW(state_dtype=state_dtype).create(jax_opt.CosineDecaySchedule(**schedule).create())
    port = opt.AdamW(state_dtype=state_dtype)
    return params, grads, jax_tx, port, opt.CosineDecaySchedule(**schedule)


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_adamw_matches_the_jax_transform(state_dtype):
    params, grads, jax_tx, port, schedule = _adamw_pair(state_dtype)
    jax_state = jax_tx.init(params)
    torch_params = to_torch(params)
    state = port.init(torch_params)
    for g in grads:
        jax_updates, jax_state = jax_tx.update(g, jax_state, params)
        updates, state = port.update(to_torch(g), state, torch_params, schedule)
        adam_state = jax_state[1]
        for k in params:
            want = np.asarray(jax_updates[k])
            tol = (1e-5 if state_dtype is None else 1e-2) * np.abs(want).max()
            np.testing.assert_allclose(updates[k].numpy(), want, rtol=0, atol=tol, err_msg=k)
            mu = state["mu"][k].float().numpy()
            if state_dtype is None:
                np.testing.assert_allclose(mu, np.asarray(adam_state.mu[k]), rtol=0,
                                           atol=1e-5 * np.abs(np.asarray(adam_state.mu[k])).max())
            else:
                np.testing.assert_array_equal(mu, np.asarray(adam_state.mu[k].astype(jnp.float32)))
        assert state["count"] == int(adam_state.count)


def test_adamw_int8_tracks_f32():
    """The 8-bit moments (kernel K3's plain version here) give updates close to the f32 moments."""
    params, grads, _, _, schedule = _adamw_pair(None)
    f32, q8 = opt.AdamW(), opt.AdamW(state_dtype="int8")
    p = to_torch(params)
    s32, s8 = f32.init(p), q8.init(p)
    assert s8["mu"]["e"]["q"].dtype == torch.int8 and s8["nu"]["e"]["s"].shape == (2,)
    for g in grads:
        u32, s32 = f32.update(to_torch(g), s32, p, schedule)
        u8, s8 = q8.update(to_torch(g), s8, p, schedule)
        for k in p:
            cos = torch.nn.functional.cosine_similarity(u32[k].flatten(), u8[k].flatten(), dim=0)
            assert cos > 0.99, (k, cos)
    assert all(s8["mu"][k]["q"].abs().max() > 0 for k in p)
