"""The PaliGemma prompt tokenizer, without JAX.

Counterpart of the PaliGemma half of ``kai0_tpu/models/tokenizer.py``
(``:28-245``): ``PaligemmaTokenizer`` (BOS + sentencepiece ids; π₀.₅ puts the
state, discretized into 256 bins over [-1, 1], into the prompt string
``"Task: {prompt}, State: {s0 s1 ...};\\nAction: "``; right-padded with 0 to
``max_len`` with a validity mask), the real codec ``SentencePieceCodec`` (the
``sentencepiece`` wheel when importable, else the pure-Python reader in
``sentencepiece_codec.py``) and the hash codec that stands in, with a loud
one-time warning, when the model file is absent. The asset path comes from
``KAI0_PALIGEMMA_TOKENIZER`` and the backend from ``KAI0_SP_BACKEND``
(``auto``, ``sentencepiece`` or ``pure``). The FAST codecs wait for the FAST
model.
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np

PALIGEMMA_VOCAB_SIZE = 257_152
_BOS_ID = 2
_EOS_ID = 1
_NEWLINE_ID = 108  # "\n" in the Gemma vocab

logger = logging.getLogger("kai0_tpu_torch")

_WARNED_FALLBACKS: set[str] = set()


def _warn_fallback(name: str, detail: str) -> None:
    """Loud one-time warning when an offline stand-in codec activates.

    The fallback codecs keep the pipeline runnable with zero network access, but
    they are NOT the codecs a real openpi checkpoint was trained with — serving
    one through them produces garbage prompts/actions. Suppressed under pytest
    (the tests exercise the fallbacks on purpose).
    """
    if name in _WARNED_FALLBACKS or "PYTEST_CURRENT_TEST" in os.environ:
        return
    _WARNED_FALLBACKS.add(name)
    logger.warning(
        "=" * 78 + f"\nTOKENIZER FALLBACK ACTIVE: {name}. {detail}\n"
        "Outputs are deterministic stand-ins, NOT compatible with checkpoints "
        "trained on the real codec. Verify the real path with "
        "scripts/validate_tokenizer.py once assets are available.\n" + "=" * 78
    )


# --------------------------------------------------------------------------------------
# Text codecs
# --------------------------------------------------------------------------------------


class UnknownBackendError(ValueError):
    """Invalid ``KAI0_SP_BACKEND`` value — a configuration error that must
    hard-fail, never degrade to a fallback codec."""


class SentencePieceCodec:
    """Real PaliGemma sentencepiece codec, from the raw ``.model`` file.

    Prefers the ``sentencepiece`` wheel when importable; without it, the
    pure-Python unigram implementation (``sentencepiece_codec.py``)
    reads the same file and produces the same ids — so the real tokenizer runs
    on hosts without the wheel too.
    """

    def __init__(self, model_path: str, backend: str | None = None):
        with open(model_path, "rb") as f:
            data = f.read()
        # KAI0_SP_BACKEND=pure forces the pure-Python path even where the wheel exists.
        if backend is None:
            backend = os.environ.get("KAI0_SP_BACKEND", "auto")
        if backend not in ("auto", "sentencepiece", "pure"):
            # A typo'd KAI0_SP_BACKEND must not silently select the pure codec.
            # Dedicated type: _default_text_codec re-raises it instead of
            # swallowing it as an asset-load failure.
            raise UnknownBackendError(
                f"unknown sentencepiece backend {backend!r} (expected auto|sentencepiece|pure)"
            )
        self._sp = None
        if backend in ("auto", "sentencepiece"):
            try:
                import sentencepiece

                self._sp = sentencepiece.SentencePieceProcessor(model_proto=data)
                self.backend = "sentencepiece"
            except ImportError:
                if backend == "sentencepiece":
                    raise
        if self._sp is None:
            from kai0_tpu_torch.models import sentencepiece_codec

            self._sp = sentencepiece_codec.SentencePieceModel(data)
            self.backend = "pure-python"

    def encode(self, text: str, *, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids = list(self._sp.encode(text))
        if add_bos:
            ids = [self._sp.bos_id()] + ids
        if add_eos:
            ids = ids + [self._sp.eos_id()]
        return ids

    def decode(self, ids: list[int]) -> str:
        return self._sp.decode(ids)

    def vocab_size(self) -> int:
        return self._sp.vocab_size()


class HashWordCodec:
    """Deterministic fallback codec: stable word -> id hashing into the PaliGemma vocab.

    Word pieces hash (md5) into [1000, 255_000) — clear of control tokens at the bottom
    and the special/action-token region at the top of the vocab. Digit strings map to a
    dedicated contiguous range so state discretizations stay compact and decodable.
    Not a linguistic tokenizer; a stable stand-in so the full pipeline runs without
    network access. Decoding is supported for ids produced by this codec.
    """

    _DIGIT_BASE = 255_000  # 255_000 .. 255_255 reserved for byte/digit values

    def __init__(self):
        self._decode_table: dict[int, str] = {}

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:8], "little")
        wid = 1000 + (h % (self._DIGIT_BASE - 1000 - 1))
        self._decode_table[wid] = word
        return wid

    def encode(self, text: str, *, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids: list[int] = [_BOS_ID] if add_bos else []
        for word in text.replace("\n", " \n ").split(" "):
            if not word:
                continue
            if word == "\n":
                ids.append(_NEWLINE_ID)
            elif word.lstrip("-").isdigit() and 0 <= int(word) < 256:
                ids.append(self._DIGIT_BASE + int(word))
            else:
                ids.append(self._word_id(word))
        if add_eos:
            ids.append(_EOS_ID)
        return ids

    def decode(self, ids: list[int]) -> str:
        words = []
        for i in ids:
            if i in (_BOS_ID, _EOS_ID, 0):
                continue
            if i == _NEWLINE_ID:
                words.append("\n")
            elif self._DIGIT_BASE <= i < self._DIGIT_BASE + 256:
                words.append(str(i - self._DIGIT_BASE))
            else:
                words.append(self._decode_table.get(i, "<unk>"))
        return " ".join(words)

    def vocab_size(self) -> int:
        return PALIGEMMA_VOCAB_SIZE


def _default_text_codec():
    path = os.environ.get("KAI0_PALIGEMMA_TOKENIZER")
    if path and os.path.exists(path):
        try:
            return SentencePieceCodec(path)
        except UnknownBackendError:
            raise  # config error, not an asset-load failure: never degrade
        except Exception as e:  # noqa: BLE001
            logger.warning(f"Failed to load sentencepiece model from {path}: {e}; using hash codec")
    _warn_fallback(
        "HashWordCodec (text)",
        "No PaliGemma sentencepiece model (set KAI0_PALIGEMMA_TOKENIZER to the "
        "paligemma_tokenizer.model path).",
    )
    return HashWordCodec()


# --------------------------------------------------------------------------------------
# Prompt tokenizer (π₀ / π₀.₅)
# --------------------------------------------------------------------------------------


class PaligemmaTokenizer:
    def __init__(self, max_len: int = 48, codec=None):
        self._max_len = max_len
        self._codec = codec if codec is not None else _default_text_codec()

    def tokenize(self, prompt: str, state: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
        cleaned_text = prompt.strip().replace("_", " ").replace("\n", " ")
        if state is not None:
            # π₀.₅ format: state discretized to 256 bins over [-1, 1], embedded in the prompt.
            discretized_state = np.digitize(state, bins=np.linspace(-1, 1, 256 + 1)[:-1]) - 1
            state_str = " ".join(map(str, discretized_state))
            full_prompt = f"Task: {cleaned_text}, State: {state_str};\nAction: "
            tokens = self._codec.encode(full_prompt, add_bos=True)
        else:
            # π₀ format: "\n" tokenized separately as the start-of-answer token.
            tokens = self._codec.encode(cleaned_text, add_bos=True) + self._codec.encode("\n")
        tokens_len = len(tokens)
        if tokens_len < self._max_len:
            padding = [False] * (self._max_len - tokens_len)
            mask = [True] * tokens_len + padding
            tokens = tokens + padding
        else:
            if tokens_len > self._max_len:
                logger.warning(
                    f"Token length ({tokens_len}) exceeds max length ({self._max_len}), truncating. "
                    "Consider increasing `max_token_len` in the model config if this happens frequently."
                )
            tokens = tokens[: self._max_len]
            mask = [True] * self._max_len
        # int32: matches the model input spec; int64 would silently compile a second
        # program variant at serve time (first-request latency).
        return np.asarray(tokens, dtype=np.int32), np.asarray(mask, dtype=bool)
