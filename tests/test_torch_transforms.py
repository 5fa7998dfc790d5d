"""``kai0_tpu_torch.transforms`` against ``kai0_tpu.transforms``: every ported transform bit-equal on seeded inputs.

Each case feeds both packages copies of one seeded numpy dict (transforms may
write in place) and asserts the outputs have the same keys, dtypes and bits.
"""

import copy

import numpy as np
import pytest

from _torch_parity import assert_same
from kai0_tpu import transforms as jt
from kai0_tpu.models import tokenizer as jax_tokenizer
from kai0_tpu.shared import normalize as jax_normalize
from kai0_tpu_torch import transforms as tt
from kai0_tpu_torch.models import tokenizer as torch_tokenizer
from kai0_tpu_torch.shared import normalize as torch_normalize


def sample(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "state": rng.standard_normal(14).astype(np.float32),
        "actions": rng.standard_normal((50, 14)).astype(np.float32),
        "image": {"cam": rng.integers(0, 256, (96, 128, 3), dtype=np.uint8),
                  "wrist": rng.uniform(-1, 1, (224, 224, 3)).astype(np.float32)},
        "prompt": np.asarray("Fold_the cloth\n"),
        "advantage": np.float32(rng.standard_normal()),
        "task_index": np.int64(1),
    }


def stats(seed: int, dim: int, *, quantiles: bool, module) -> dict:
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-2, 0, dim)
    return {
        "state": module.NormStats(mean=rng.standard_normal(dim), std=rng.uniform(0.1, 2, dim),
                                  q01=lo if quantiles else None, q99=lo + rng.uniform(0.5, 3, dim) if quantiles else None),
        "actions": module.NormStats(mean=rng.standard_normal(dim), std=rng.uniform(0.1, 2, dim),
                                    q01=lo if quantiles else None, q99=lo + 1.5 if quantiles else None),
    }


def both(make, data, seed=0):
    """Apply the JAX transform and the port's to copies of ``data``."""
    jax_fn, torch_fn = make(jt), make(tt)
    return jax_fn(copy.deepcopy(data)), torch_fn(copy.deepcopy(data))


CASES = {
    "repack": lambda m: m.RepackTransform({"images": {"top": "image/cam"}, "s": "state", "a": "actions"}),
    "inject_default_prompt": lambda m: m.InjectDefaultPrompt("do it"),
    "inject_default_prompt_none": lambda m: m.InjectDefaultPrompt(None),
    "insert_advantage": lambda m: m.InsertAdvantageIntoPrompt(),
    "prompt_from_task": lambda m: m.PromptFromLeRobotTask({0: "a", 1: "b"}),
    "delta": lambda m: m.DeltaActions(m.make_bool_mask(6, -1, 6, -1)),
    "absolute": lambda m: m.AbsoluteActions(m.make_bool_mask(6, -1, 6, -1)),
    "delta_none": lambda m: m.DeltaActions(None),
    "subsample": lambda m: m.SubsampleActions(3),
    "resize": lambda m: m.ResizeImages(224, 224),
    "pad": lambda m: m.PadStatesAndActions(32),
    "compose": lambda m: m.compose([m.DeltaActions(m.make_bool_mask(7, -7)), m.PadStatesAndActions(20)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_jax(name):
    data = sample(1)
    if name == "inject_default_prompt":
        del data["prompt"]
    ref, out = both(CASES[name], data)
    assert_same(ref, out)


@pytest.mark.parametrize("quantiles", [False, True])
@pytest.mark.parametrize("dim", [14, 32])
def test_normalize_and_unnormalize_match_jax(quantiles, dim):
    """Forward truncates ``dim``-wide stats to the 14-wide data; the inverse, on the model's 32-wide outputs, pads
    them (z-score) or passes the extra dims through (quantiles); both with the reference's epsilon."""
    data = {"state": sample(2)["state"], "actions": sample(2)["actions"]}
    js, ts = (stats(3, dim, quantiles=quantiles, module=m) for m in (jax_normalize, torch_normalize))
    for strict in (False, True):
        ref = jt.Normalize(js, use_quantiles=quantiles, strict=strict)(copy.deepcopy(data))
        out = tt.Normalize(ts, use_quantiles=quantiles, strict=strict)(copy.deepcopy(data))
        assert_same(ref, out)
    wide = {k: jt.pad_to_dim(v, 32) for k, v in ref.items()}
    assert_same(jt.Unnormalize(js, use_quantiles=quantiles)(copy.deepcopy(wide)),
                tt.Unnormalize(ts, use_quantiles=quantiles)(copy.deepcopy(wide)))
    assert tt.Normalize(None)(data) is data and tt.Unnormalize(None)(data) is data


def test_normalize_errors_match_jax():
    data = {"state": sample(2)["state"]}
    for m, norm in ((jt, jax_normalize), (tt, torch_normalize)):
        with pytest.raises(ValueError, match="quantile stats must be provided"):
            m.Normalize({"state": norm.NormStats(mean=np.zeros(14), std=np.ones(14))}, use_quantiles=True)
        with pytest.raises(ValueError, match="not found in tree"):
            m.Unnormalize({"actions": norm.NormStats(mean=np.zeros(14), std=np.ones(14))})(dict(data))


@pytest.mark.parametrize("discrete_state", [False, True])
def test_tokenize_prompt_matches_jax(discrete_state):
    data = sample(4)
    data["state"] = np.clip(data["state"], -1, 1)
    ref = jt.TokenizePrompt(jax_tokenizer.PaligemmaTokenizer(64, codec=jax_tokenizer.HashWordCodec()),
                            discrete_state_input=discrete_state)(copy.deepcopy(data))
    out = tt.TokenizePrompt(torch_tokenizer.PaligemmaTokenizer(64, codec=torch_tokenizer.HashWordCodec()),
                            discrete_state_input=discrete_state)(copy.deepcopy(data))
    assert_same(ref, out)


def test_dict_toolkit_matches_jax():
    data = sample(5)
    assert_same(jt.flatten_dict(data), tt.flatten_dict(data))
    flat = tt.flatten_dict(data)
    assert_same(jt.unflatten_dict(flat), tt.unflatten_dict(flat))
    patterns = {r"image/(.*)": r"images/\1_rgb", "advantage": None}
    assert_same(jt.transform_dict(patterns, data), tt.transform_dict(patterns, data))
    sel = {"state": 2.0}
    assert_same(jt.apply_tree(data, sel, lambda x, s: x * s), tt.apply_tree(data, sel, lambda x, s: x * s))
    for x, d, axis in ((data["actions"], 32, -1), (data["state"], 10, 0), (data["actions"], 60, 0)):
        assert_same(jt.pad_to_dim(x, d, axis=axis, value=-1.5), tt.pad_to_dim(x, d, axis=axis, value=-1.5))
    assert jt.make_bool_mask(2, -2, 3) == tt.make_bool_mask(2, -2, 3)
    g = tt.Group(inputs=[1], outputs=[2]).push(inputs=[3], outputs=[4])
    assert (tuple(g.inputs), tuple(g.outputs)) == (tuple(jt.Group(inputs=[1], outputs=[2]).push(inputs=[3], outputs=[4]).inputs), (4, 2))
    with pytest.raises(ValueError, match="already exists"):
        tt.transform_dict({"state": "actions"}, data)
