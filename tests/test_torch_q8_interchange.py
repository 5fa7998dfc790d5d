"""q8 AdamW state across the packages: JAX's blocks over stacked leaves, the port's over per-layer tensors.

Moments in JAX's layout are encoded and decoded with JAX's own codec
(``kai0_tpu/training/optimizer.py`` ``_q8_encode`` / ``_q8_decode``), mapped to
the port's parameter names with the JAX package's weight map
(``kai0_tpu.interop.torch_safetensors.jax_to_torch_state``: pure permutations,
so moments map like weights), encoded into the port's state with
``q8_state_from_moments`` and decoded with ``q8_moments``; and the other way
round through ``torch_state_to_jax`` and JAX's codec. The blocks and their
scales differ between the layouts, so each value is re-rounded to another log
grid: the two decodes agree within one step of the grid, a factor of
exp(7 ln 10 / levels) (JAX rounds stochastically, which moves a value by less
than one step; the port to the nearer code, by at most half), widened by 2e-5
relative for the codecs' f32 log and exp, which put a value that lies on a
grid point a few ulps to either side of it. The moments span
3.5 decades below their tensor's largest value, above either codec's floor of
1e-7 of a block's absmax, and include exact zeros.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DEBUG
from kai0_tpu.interop import torch_safetensors as tsf
from kai0_tpu.models import pi0 as jax_pi0
from kai0_tpu.training import optimizer as jax_opt
from kai0_tpu.transforms import flatten_dict, unflatten_dict
from kai0_tpu_torch.models import pi0 as torch_pi0
from kai0_tpu_torch.training import optimizer as opt

STEP = {True: 7 * np.log(10) / 127, False: 7 * np.log(10) / 255}  # log distance of two codes, mu (signed) and nu


@pytest.fixture(scope="module")
def config():
    return jax_pi0.Pi0Config(**DEBUG)


def _moments(rng, shape, signed: bool) -> np.ndarray:
    x = np.exp(rng.uniform(-8, 0, shape)) * (1e-3 if signed else 1e-6)
    if signed:
        x *= rng.choice([-1.0, 1.0], shape)
    x.reshape(-1)[::53] = 0.0
    return x.astype(np.float32)


@functools.partial(jax.jit, static_argnames="signed")
def _encode_decode(x, key, *, signed: bool):
    return jax_opt._q8_decode(jax_opt._q8_encode(x, key, signed=signed))


def _jax_codec(tree: dict, signed: bool, seed: int) -> dict:
    """JAX's view of a moment tree: every leaf through ``_q8_encode`` and ``_q8_decode``.

    Each leaf is padded with zeros to whole 2048-element blocks and the leaves
    go through the codec in one call (one compile): a block then holds what it
    holds in a call on its leaf alone, and zeros change no block's absmax.
    """
    flat = flatten_dict(tree)
    paths = sorted(flat)
    joined = np.concatenate([np.pad(np.ravel(flat[p]), (0, -np.size(flat[p]) % 2048)) for p in paths])
    decoded = np.array(_encode_decode(jnp.asarray(joined), jax.random.key(seed), signed=signed))
    out, start = {}, 0
    for p in paths:
        size = np.size(flat[p])
        out[p] = decoded[start:start + size].reshape(np.shape(flat[p]))
        start += size + (-size % 2048)
    return unflatten_dict(out)


def _within_one_step(got: np.ndarray, want: np.ndarray, signed: bool, name: str) -> None:
    assert got.shape == want.shape, name
    assert np.array_equal(got == 0, want == 0), f"{name}: zeros differ"
    # one step, and the codecs' f32 log and exp (a few ulps: a value on a grid point may land a step off)
    np.testing.assert_array_less(np.abs(got - want), (np.exp(STEP[signed]) * (1 + 2e-5) - 1) * np.abs(want) + 1e-30,
                                 err_msg=name)


def test_jax_q8_state_reads_into_the_port(config):
    rng = np.random.default_rng(0)
    shapes = {path: x.shape for path, x in flatten_dict(jax.eval_shape(config.init_params, jax.random.key(0))).items()}
    views = {}
    for i, (key, signed) in enumerate((("mu", True), ("nu", False))):
        tree = unflatten_dict({path: _moments(rng, shape, signed) for path, shape in shapes.items()})
        views[key] = tsf.jax_to_torch_state(_jax_codec(tree, signed, i), config)
    names = set(torch_pi0.Pi0(torch_pi0.Pi0Config(**DEBUG), device="cpu").state_dict())
    assert set(views["mu"]) == set(views["nu"]) and set(views["mu"]) <= names
    state = opt.q8_state_from_moments({k: {n: torch.from_numpy(np.array(v)) for n, v in views[k].items()} for k in views}, 7)
    assert state["count"] == 7
    for name, packed in state["mu"].items():
        assert packed["q"].dtype == torch.int8 and state["nu"][name]["q"].dtype == torch.uint8
        assert packed["s"].shape == (-(-packed["q"].numel() // 2048),)
    decoded = opt.q8_moments(state)
    for key, signed in (("mu", True), ("nu", False)):
        for name, want in views[key].items():
            _within_one_step(decoded[key][name].numpy(), want, signed, f"{key} {name}")


def test_port_q8_state_reads_into_jax(config):
    rng = np.random.default_rng(1)
    zeros = unflatten_dict({path: np.zeros(x.shape, np.float32)
                            for path, x in flatten_dict(jax.eval_shape(config.init_params, jax.random.key(0))).items()})
    shapes = {name: x.shape for name, x in tsf.jax_to_torch_state(zeros, config).items()}
    moments = {key: {name: torch.from_numpy(_moments(rng, shape, key == "mu")) for name, shape in shapes.items()}
               for key in ("mu", "nu")}
    port = opt.q8_moments(opt.q8_state_from_moments(moments, 3))
    for i, (key, signed) in enumerate((("mu", True), ("nu", False))):
        want = {name: x.numpy() for name, x in port[key].items()}
        jax_tree = tsf.torch_state_to_jax(want, config)
        got = tsf.jax_to_torch_state(_jax_codec(jax_tree, signed, 10 + i), config)
        assert set(got) == set(want)
        for name in want:
            _within_one_step(got[name], want[name], signed, f"{key} {name}")
