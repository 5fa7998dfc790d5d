"""The port's FAST action tokenizers and transforms against ``kai0_tpu.models.tokenizer`` / ``fsq_tokenizer``.

Bit-equal unless stated: ``DCTActionCodec``; ``FASTTokenizer.tokenize`` (ids,
validity, AR and loss masks, with and without actions, padded and
truncated) and ``extract_actions`` through the DCT region path and through
the text round trip (a toy action codec), with the synthetic SentencePiece
model of ``tests/_sp_model.py`` (read by each package's pure-Python reader)
and with the hash codec; ``BinningTokenizer``; ``TokenizeFASTInputs`` and
``ExtractFASTActions``. FSQ: JAX's params carried across by
``fsq_tokenizer.params_from_jax`` (and through a ``.safetensors`` file): the
token ids of ``encode`` bit-equal, ``decode`` and ``FSQTokenizer.extract_actions``
within 1e-6 x max(1, |x|) (two MLPs, whose matmuls sum in another order in
XLA and in torch); the port refuses an FSQ tokenizer without params.

The chain end to end: ``create_trained_policy`` of both packages on a raw
DROID observation, ``pi0_fast_droid`` with its model cut to dummy size
(numpy-seeded weights carried across by ``interop.state_from_jax``; the DCT
action codec, quantile stats, 256 decode steps): equal actions by ``infer``;
its ``infer_batch`` (8 decode steps) gives each row's ``infer``.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_parity import numpy_params
import _sp_model
from kai0_tpu import transforms as jax_transforms
from kai0_tpu.models import fsq_tokenizer as jax_fsq
from kai0_tpu.models import pi0_fast as jax_fast
from kai0_tpu.models import sentencepiece_codec as spc
from kai0_tpu.models import tokenizer as jax_tokenizer
from kai0_tpu.policies import droid_policy as jax_droid
from kai0_tpu.policies import policy_config as jax_policy_config
from kai0_tpu.shared import normalize as jax_normalize
from kai0_tpu.training import config as jax_config_module
from kai0_tpu_torch import interop, transforms
from kai0_tpu_torch.models import fsq_tokenizer
from kai0_tpu_torch.models import pi0_fast
from kai0_tpu_torch.models import tokenizer
from kai0_tpu_torch.policies import policy_config
from kai0_tpu_torch.training import config as torch_config_module

PROMPTS = ["pick up the red block", "Fold_the cloth\n", "  put the cup on the plate  "]


@pytest.fixture(scope="module", autouse=True)
def no_hf_processor():
    """``transformers`` does not import, so neither package asks the hub for a FAST processor."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)
        yield


@pytest.fixture(scope="module")
def sp_model(tmp_path_factory) -> str:
    """A small unigram model with the prompt's pieces, digits and byte fallback."""
    pieces = [("<pad>", 0.0, spc.CONTROL), ("<eos>", 0.0, spc.CONTROL), ("<bos>", 0.0, spc.CONTROL),
              ("<unk>", 0.0, spc.UNKNOWN), ("Task:", -2.0, None), ("▁State:", -2.0, None), (";", -2.5, None),
              ("\n", -2.5, None), ("Action:", -2.0, None), ("▁", -3.0, None), (",", -2.5, None), ("|", -2.5, None),
              ("▁pick", -3.0, None), ("▁up", -3.0, None), ("▁the", -3.0, None), ("▁cloth", -3.5, None)]
    pieces += [(f"▁{d}", -4.0, None) for d in range(256)]
    pieces += [(f"<0x{i:02X}>", -12.0, spc.BYTE) for i in range(256)]
    pieces += [(f"<fill{i}>", -20.0, spc.UNUSED) for i in range(2048 - len(pieces))]
    path = tmp_path_factory.mktemp("sp") / "small.model"
    path.write_bytes(_sp_model.build_model(pieces, unk_id=3, bos_id=2, eos_id=1, pad_id=0, byte_fallback=True,
                                           add_dummy_prefix=False, remove_extra_whitespaces=False))
    return str(path)


@pytest.fixture(params=["sentencepiece", "hash", "word"])
def text_codec(request, sp_model, monkeypatch):
    """The text codec both packages' ``FASTTokenizer`` read from the environment (``word``: the hash codec there,
    replaced by ``WordCodec`` after construction)."""
    if request.param == "sentencepiece":
        monkeypatch.setenv("KAI0_PALIGEMMA_TOKENIZER", sp_model)
        monkeypatch.setenv("KAI0_SP_BACKEND", "pure")
    else:
        monkeypatch.delenv("KAI0_PALIGEMMA_TOKENIZER", raising=False)
    return request.param


class WordCodec:
    """A text codec whose decode and encode invert each other on every id: id ↔ ``w<id>``."""

    def encode(self, text, *, add_bos=False, add_eos=False):
        words = text.replace("\n", " ").replace("|", " | ").split()
        ids = [{"Action:": 4, "|": 5}.get(w) or (int(w[1:]) if w[:1] == "w" and w[1:].isdigit() else 10 + sum(map(ord, w)))
               for w in words]
        return [2] * add_bos + ids + [1] * add_eos

    def decode(self, ids):
        return " ".join("Action:" if i == 4 else "|" if i == 5 else f"w{i}" for i in ids if i not in (0, 1, 2))

    def vocab_size(self):
        return 4096


class ToyFast:
    """An action codec that is not the DCT one, so that ``extract_actions`` takes the text round trip."""

    def __call__(self, actions_batched):
        return [np.clip(np.round((a[::2].reshape(-1) + 1) * 100), 0, 255).astype(np.int64) for a in actions_batched]

    def decode(self, tokens_batched, *, time_horizon, action_dim):
        out = np.zeros((len(tokens_batched), time_horizon, action_dim), np.float32)
        for i, tokens in enumerate(tokens_batched):
            flat = np.asarray(tokens, np.float32)[: time_horizon * action_dim] / 100 - 1
            out[i].reshape(-1)[: flat.size] = flat
        return out


def _chunks(seed: int, n: int = 3, horizon: int = 10, dim: int = 8) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [np.cumsum(rng.normal(0, 0.2, (horizon, dim)), axis=0).astype(np.float32) for _ in range(n)]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b, strict=True):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y)


def test_dct_codec_matches_jax():
    for kw in ({}, {"num_coeffs": 4, "bins": 64, "coeff_range": 2.0}):
        ref, codec = jax_tokenizer.DCTActionCodec(**kw), tokenizer.DCTActionCodec(**kw)
        chunks = np.stack(_chunks(1))
        tokens = codec(chunks)
        _equal(tokens, ref(chunks))
        lists = [t.tolist() for t in tokens] + [[3, 900, -4]]
        _equal(codec.decode(lists, time_horizon=10, action_dim=8), ref.decode(lists, time_horizon=10, action_dim=8))


@pytest.mark.parametrize("action_codec", ["dct", "toy"])
def test_fast_tokenizer_matches_jax(text_codec, action_codec):
    make = (lambda mod: mod.DCTActionCodec(num_coeffs=4)) if action_codec == "dct" else (lambda mod: ToyFast())
    for max_len in (180, 40):
        ref = jax_tokenizer.FASTTokenizer(max_len, codec=make(jax_tokenizer))
        tok = tokenizer.FASTTokenizer(max_len, codec=make(tokenizer))
        if text_codec == "word":
            ref._paligemma = tok._paligemma = WordCodec()
        for prompt, actions in zip(PROMPTS, _chunks(2), strict=True):
            state = np.random.default_rng(len(prompt)).uniform(-1.2, 1.2, 8)
            for acts in (actions, None):
                got = tok.tokenize(prompt, state, acts)
                _equal(got, ref.tokenize(prompt, state, acts))
            tokens = tok.tokenize(prompt, state, actions)[0]
            out = tok.extract_actions(tokens, 10, 8)
            _equal([out], [ref.extract_actions(tokens, 10, 8)])
            # The DCT path finds the action ids in the 257,152-token layout, the text path round-trips them.
            if max_len == 180 and (text_codec, action_codec) in (("hash", "dct"), ("word", "toy")):
                assert np.abs(out).max() > 0, (text_codec, action_codec)


def test_binning_tokenizer_matches_jax(text_codec):
    ref, tok = jax_tokenizer.BinningTokenizer(60), tokenizer.BinningTokenizer(60)
    state = np.linspace(-1, 1, 8)
    _equal(tok.tokenize(PROMPTS[0], state), ref.tokenize(PROMPTS[0], state))
    for t in (tok, ref):
        with pytest.raises(NotImplementedError, match="inference only"):
            t.tokenize(PROMPTS[0], state, np.zeros((10, 8)))
    codec = WordCodec()
    ref, tok = jax_tokenizer.BinningTokenizer(60, codec=codec), tokenizer.BinningTokenizer(60, codec=codec)
    action_ids = list(codec.vocab_size() - 1 - 128 - np.random.default_rng(0).integers(0, 256, 80))
    for tokens in ([2, 4, *action_ids, 5, 1], [2, 4, *action_ids[:30], 5], [2, 7, 8]):
        got = tok.extract_actions(np.asarray(tokens), 10, 8)
        _equal([got], [ref.extract_actions(np.asarray(tokens), 10, 8)])
    assert np.abs(tok.extract_actions(np.asarray([2, 4, *action_ids, 5, 1]), 10, 8)).max() > 0


@pytest.fixture(scope="module")
def fsq():
    config = dict(action_horizon=10, action_dim=8, num_tokens=4, target_codebook_size=2**8, hidden=32)
    jax_config = jax_fsq.FsqConfig(**config)
    params = jax_fsq.init_params(jax_config, jax.random.key(0))
    return jax_config, params, fsq_tokenizer.FsqConfig(**config), fsq_tokenizer.params_from_jax(params)


def test_fsq_encode_decode_match_jax(fsq, tmp_path):
    jax_config, params, config, port_params = fsq
    assert config.vocab_size == jax_config.vocab_size == 240 and config.bins_per_dim == jax_config.bins_per_dim
    actions = np.stack(_chunks(3, n=6)) * 3
    want = np.asarray(jax_fsq.encode(params, jax_config, actions))
    got = fsq_tokenizer.encode(port_params, config, torch.from_numpy(actions)).numpy()
    assert got.dtype == want.dtype == np.int32 and len(np.unique(got)) > 4
    np.testing.assert_array_equal(got, want)
    ids = np.random.default_rng(0).integers(0, 240, (5, 4)).astype(np.int32)
    ref = np.asarray(jax_fsq.decode(params, jax_config, ids))
    out = fsq_tokenizer.decode(port_params, config, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * max(1.0, np.abs(ref).max()))
    interop.write_safetensors(port_params, tmp_path / "fsq.safetensors")
    loaded = fsq_tokenizer.load_params(tmp_path / "fsq.safetensors")
    assert loaded.keys() == port_params.keys()
    for k, v in port_params.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)


def test_fsq_tokenizer_matches_jax(fsq, tmp_path):
    jax_config, params, config, port_params = fsq
    codec = WordCodec()
    ref = jax_tokenizer.FSQTokenizer(60, codec=codec, fsq_config=jax_config)
    tok = tokenizer.FSQTokenizer(60, codec=codec, fsq_config=config, params=fsq_tokenizer.params_from_jax(ref._params))
    interop.write_safetensors(port_params, tmp_path / "fsq.safetensors")
    from_file = tokenizer.FSQTokenizer(60, codec=codec, fsq_config=config, fsq_tokenizer_path=tmp_path / "fsq.safetensors")
    state = np.linspace(-1, 1, 8)
    _equal(tok.tokenize(PROMPTS[1], state), ref.tokenize(PROMPTS[1], state))
    ids = list(codec.vocab_size() - 1 - 128 - np.array([3, 77, 200, 239, 10]))
    for tokens in ([2, 4, *ids, 5, 1], [2, 4, *ids[:2], 5], [2, 9]):
        want = ref.extract_actions(np.asarray(tokens), 10, 8)
        for t in (tok, from_file):
            got = t.extract_actions(np.asarray(tokens), 10, 8)
            assert got.shape == want.shape == (10, 8) and got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))
    with pytest.raises(ValueError, match="params"):
        tokenizer.FSQTokenizer(60, codec=codec)


def test_fast_transforms_match_jax(text_codec):
    ref_tok = jax_tokenizer.FASTTokenizer(120, codec=jax_tokenizer.DCTActionCodec())
    tok = tokenizer.FASTTokenizer(120, codec=tokenizer.DCTActionCodec())
    actions = _chunks(4, n=1)[0]
    data = {"prompt": np.asarray("pick up the cloth"), "state": np.linspace(-1, 1, 8).astype(np.float32),
            "actions": actions}
    want = jax_transforms.TokenizeFASTInputs(ref_tok)(dict(data))
    got = transforms.TokenizeFASTInputs(tok)(dict(data))
    assert list(got) == list(want) and "prompt" not in got
    _equal([got[k] for k in want], [want[k] for k in want])
    with pytest.raises(ValueError, match="Prompt is required"):
        transforms.TokenizeFASTInputs(tok)({"state": data["state"]})
    out = transforms.ExtractFASTActions(tok, 10, 8)({"actions": got["tokenized_prompt"].astype(np.float32),
                                                    "state": data["state"]})
    ref = jax_transforms.ExtractFASTActions(ref_tok, 10, 8)({"actions": want["tokenized_prompt"].astype(np.float32),
                                                            "state": data["state"]})
    _equal([out["actions"], out["state"]], [ref["actions"], ref["state"]])
    assert transforms.ExtractFASTActions(tok, 10, 8)({"state": 1}) == {"state": 1}


TOKENS = 48
FAST = dict(paligemma_variant="dummy", vision_variant="mu/14", dtype="float32", action_dim=8, action_horizon=10,
            max_token_len=TOKENS)


@pytest.fixture(scope="module")
def models():
    jax_config = jax_fast.Pi0FASTConfig(**FAST)
    params = numpy_params(jax_config, seed=0)
    model = pi0_fast.Pi0FAST(pi0_fast.Pi0FASTConfig(**FAST), device="cpu")
    flat = {k: np.asarray(v) for k, v in jax_transforms.flatten_dict(params).items()}
    return jax_config, params, interop.load_jax_state(model, interop.state_from_jax(flat, model))


@pytest.fixture(scope="module")
def droid_checkpoint(models, tmp_path_factory):
    _, params, model = models
    ckpt = tmp_path_factory.mktemp("fast")
    interop.save_torch_checkpoint(model, ckpt)
    rng = np.random.default_rng(3)
    lo = rng.uniform(-1.5, -0.5, 8)
    stat = lambda: jax_normalize.NormStats(mean=np.zeros(8), std=np.ones(8), q01=lo, q99=lo + rng.uniform(1, 3, 8))  # noqa: E731
    jax_normalize.save(ckpt / "assets" / "lerobot" / "droid_100", {"state": stat(), "actions": stat()})
    return ckpt


def test_create_trained_policy_on_droid_gives_jax_actions(models, droid_checkpoint):
    jax_config, params, _ = models
    jax_cfg = dataclasses.replace(jax_config_module.get_config("pi0_fast_droid"), model=jax_config)
    torch_cfg = dataclasses.replace(torch_config_module.get_config("pi0_fast_droid"),
                                    model=pi0_fast.Pi0FASTConfig(**FAST))
    np.random.seed(11)
    observations = [jax_droid.make_droid_example() for _ in range(2)]
    ref_policy = jax_policy_config.create_trained_policy(jax_cfg, droid_checkpoint, params=params)
    policy = policy_config.create_trained_policy(torch_cfg, droid_checkpoint, device="cpu", prompt_buckets=[16])
    assert isinstance(policy.model, pi0_fast.Pi0FAST) and policy.graphs == {}
    assert policy.stage_inputs(observations[0])["tokenized_prompt"].shape == (1, TOKENS)  # no bucket for FAST
    want = np.asarray(ref_policy.infer(observations[0])["actions"])
    got = policy.infer(observations[0])
    assert got["actions"].shape == (10, 8) and np.abs(got["actions"]).max() > 0
    np.testing.assert_array_equal(got["actions"], want)
    # infer_batch through the same chain, 8 decode steps: each row as the request alone (no row emits EOS here, as
    # in JAX's infer_batch; test_greedy_tokens_equal_jax_and_the_batch_equals_each_row holds the batched tokens).
    short = policy_config.create_trained_policy(torch_cfg, droid_checkpoint, device="cpu",
                                                sample_kwargs={"max_decoding_steps": 8})
    for out, obs in zip(short.infer_batch(observations), observations, strict=True):
        np.testing.assert_array_equal(out["actions"], short.infer(obs)["actions"])
        assert out["policy_timing"]["batch_size"] == 2
    with pytest.raises(TypeError):
        policy.infer(observations[0], noise=np.zeros((10, 8), np.float32))  # FAST samples no noise, as in JAX
