"""``kai0_tpu_torch.models.tokenizer`` against ``kai0_tpu.models.tokenizer``: ids and masks bit-equal.

Three codecs: a synthetic unigram ``.model`` of the full PaliGemma vocabulary
size (``tests/_sp_model.py``, byte fallback, the π₀.₅ prompt pieces), a
synthetic PaliGemma-shaped BPE model, both read by each package's pure-Python
reader, and the hash codec that stands in when no model file exists. Prompts
with the π₀.₅ state in the string, the π₀ form, padding and truncation.
"""

import numpy as np
import pytest

import _sp_model
from kai0_tpu.models import sentencepiece_codec as spc
from kai0_tpu.models import tokenizer as jax_tokenizer
from kai0_tpu_torch.models import tokenizer as torch_tokenizer

PROMPTS = ["pick up the red block", "Flatten_and fold\nthe cloth.", "  Fetch the clothes, fold the tee shirts  "]


def _unigram_model() -> bytes:
    pieces = [("<pad>", 0.0, spc.CONTROL), ("<eos>", 0.0, spc.CONTROL), ("<bos>", 0.0, spc.CONTROL),
              ("<unk>", 0.0, spc.UNKNOWN), ("Task:", -2.0, None), ("▁State:", -2.0, None), (";", -2.5, None),
              ("\n", -2.5, None), ("Action:", -2.0, None), ("▁Action:", -2.0, None), ("▁", -3.0, None),
              (",", -2.5, None), ("▁pick", -3.0, None), ("▁up", -3.0, None), ("▁the", -3.0, None),
              ("▁fold", -3.0, None), ("▁cloth", -3.5, None)]
    pieces += [(f"▁{d}", -4.0, None) for d in range(256)]
    pieces += [(f"<0x{i:02X}>", -12.0, spc.BYTE) for i in range(256)]
    pieces += [(f"<fill{i}>", -20.0, spc.UNUSED) for i in range(jax_tokenizer.PALIGEMMA_VOCAB_SIZE - len(pieces))]
    return _sp_model.build_model(pieces, unk_id=3, bos_id=2, eos_id=1, pad_id=0, byte_fallback=True,
                                 add_dummy_prefix=False, remove_extra_whitespaces=False)


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    (root / "unigram.model").write_bytes(_unigram_model())
    (root / "bpe.model").write_bytes(_sp_model.build_paligemma_like_bpe(jax_tokenizer.PALIGEMMA_VOCAB_SIZE)[0])
    return root


@pytest.fixture(scope="module")
def codecs(model_files):
    """(JAX codec, port codec) by kind, each model file read once by each package."""
    out = {"hash": (jax_tokenizer.HashWordCodec(), torch_tokenizer.HashWordCodec())}
    for kind in ("unigram", "bpe"):
        path = str(model_files / f"{kind}.model")
        out[kind] = (jax_tokenizer.SentencePieceCodec(path, backend="pure"),
                     torch_tokenizer.SentencePieceCodec(path, backend="pure"))
    return out


@pytest.mark.parametrize("kind", ["unigram", "bpe", "hash"])
@pytest.mark.parametrize("max_len", [200, 48, 12])
@pytest.mark.parametrize("with_state", [True, False])
def test_paligemma_tokenizer_matches_jax(codecs, kind, max_len, with_state):
    jax_codec, torch_codec = codecs[kind]
    ref_tok = jax_tokenizer.PaligemmaTokenizer(max_len, codec=jax_codec)
    tok = torch_tokenizer.PaligemmaTokenizer(max_len, codec=torch_codec)
    rng = np.random.default_rng(max_len)
    for prompt in PROMPTS:
        state = rng.uniform(-1.2, 1.2, 32).astype(np.float32) if with_state else None
        ids, mask = tok.tokenize(prompt, state)
        ref_ids, ref_mask = ref_tok.tokenize(prompt, state)
        assert ids.dtype == ref_ids.dtype == np.int32 and mask.dtype == ref_mask.dtype == bool
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(mask, ref_mask)
        assert ids.shape == (max_len,)
        if with_state and max_len != 48:  # 32 state bins and the prompt: truncated at 12, padded at 200
            assert bool(mask.all()) == (max_len == 12)


def test_default_codec_reads_the_asset_path_and_falls_back_to_hash(model_files, monkeypatch):
    monkeypatch.setenv("KAI0_PALIGEMMA_TOKENIZER", str(model_files / "unigram.model"))
    monkeypatch.setenv("KAI0_SP_BACKEND", "pure")
    codec = torch_tokenizer.PaligemmaTokenizer(64)._codec
    assert isinstance(codec, torch_tokenizer.SentencePieceCodec) and codec.backend == "pure-python"
    monkeypatch.setenv("KAI0_SP_BACKEND", "typo")
    with pytest.raises(torch_tokenizer.UnknownBackendError):
        torch_tokenizer.PaligemmaTokenizer(64)
    monkeypatch.delenv("KAI0_SP_BACKEND")
    monkeypatch.setenv("KAI0_PALIGEMMA_TOKENIZER", str(model_files / "missing.model"))
    assert isinstance(torch_tokenizer.PaligemmaTokenizer(64)._codec, torch_tokenizer.HashWordCodec)
