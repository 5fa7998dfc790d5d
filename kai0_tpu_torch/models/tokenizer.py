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
(``auto``, ``sentencepiece`` or ``pure``).

The rest of the JAX module (``:253-531``): the action tokenizers of π₀-FAST
and its baselines. ``FASTTokenizer`` puts the prompt and the discretized state
in a bidirectional prefix and ``"Action: "`` + the action tokens (mapped into
the top of the PaliGemma vocab) + ``"|"`` + EOS in a causal postfix, with
per-token AR and loss masks. Its action codec is the HF
``physical-intelligence/fast`` processor when ``transformers`` and a local copy
of it are present (a directory, or the hub id's snapshot in the local HF
cache), else the invertible ``DCTActionCodec`` with a loud one-time warning
(the port downloads nothing; the JAX package fetches from the hub only when
``KAI0_ALLOW_HUB=1``). ``BinningTokenizer`` and ``FSQTokenizer`` are the
inference-only RoboArena baselines; ``FSQTokenizer`` decodes through
``fsq_tokenizer.py`` with params handed in or read from a ``.safetensors``
file, and raises without either.
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


# --------------------------------------------------------------------------------------
# FAST action codecs + tokenizer
# --------------------------------------------------------------------------------------


class DCTActionCodec:
    """Invertible DCT + uniform-quantization action codec (FAST-style, no learned BPE).

    Encodes an ``[ah, ad]`` action chunk by a type-II DCT along time, keeping the first
    ``num_coeffs`` coefficients per dimension and quantizing each into ``bins`` levels
    over [-``coeff_range``, ``coeff_range``]. Deterministic, invertible stand-in for the
    HF ``physical-intelligence/fast`` processor when that is unavailable offline.
    """

    def __init__(self, num_coeffs: int = 8, bins: int = 256, coeff_range: float = 5.0):
        self.num_coeffs = num_coeffs
        self.bins = bins
        self.coeff_range = coeff_range

    def __call__(self, actions_batched: np.ndarray) -> list[np.ndarray]:
        import scipy.fft

        out = []
        for actions in actions_batched:
            coeffs = scipy.fft.dct(actions, axis=0, norm="ortho")[: self.num_coeffs]  # [nc, ad]
            q = np.clip(
                np.round((coeffs / self.coeff_range + 1.0) / 2.0 * (self.bins - 1)), 0, self.bins - 1
            ).astype(np.int64)
            out.append(q.reshape(-1))
        return out

    def decode(self, tokens_batched: list[list[int]], *, time_horizon: int, action_dim: int) -> np.ndarray:
        import scipy.fft

        out = []
        for tokens in tokens_batched:
            n = self.num_coeffs * action_dim
            toks = np.zeros(n, dtype=np.int64)
            valid = np.asarray(tokens, dtype=np.int64)[:n]
            toks[: len(valid)] = np.clip(valid, 0, self.bins - 1)
            q = toks.reshape(self.num_coeffs, action_dim).astype(np.float64)
            coeffs = (q / (self.bins - 1) * 2.0 - 1.0) * self.coeff_range
            full = np.zeros((time_horizon, action_dim))
            full[: self.num_coeffs] = coeffs
            out.append(scipy.fft.idct(full, axis=0, norm="ortho").astype(np.float32))
        return np.stack(out)


def _local_processor_dir(path: str) -> str | None:
    """A directory on this machine that holds the processor: ``path`` itself, or the snapshot of the hub id ``path``
    in the local HF cache (``HF_HUB_CACHE``, else ``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``); else None."""
    if os.path.isdir(path):
        return path
    hub = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache", "huggingface"), "hub")
    repo = os.path.join(hub, "models--" + path.replace("/", "--"))
    try:
        with open(os.path.join(repo, "refs", "main")) as f:
            snapshot = os.path.join(repo, "snapshots", f.read().strip())
    except OSError:
        return None
    return snapshot if os.path.isdir(snapshot) else None


def _default_fast_codec(fast_tokenizer_path: str):
    """The HF processor from a local directory or the local HF cache when ``transformers`` is installed, else the
    DCT codec (with a warning). Only a directory on this machine is handed to ``transformers``: given a hub id,
    ``from_pretrained`` queries the hub for optional files even with ``local_files_only``."""
    local = _local_processor_dir(fast_tokenizer_path)
    if local is not None:
        try:
            from transformers import AutoProcessor

            return AutoProcessor.from_pretrained(local, trust_remote_code=True, local_files_only=True)
        except Exception as e:  # noqa: BLE001 — no transformers, or an unreadable copy: the offline stand-in
            logger.warning(f"Could not load the FAST processor from {local}: {e}")
    _warn_fallback(
        "DCTActionCodec (FAST actions)",
        f"HF processor {fast_tokenizer_path!r} unavailable offline (pre-download it into the HF cache).",
    )
    return DCTActionCodec()


def _discretized_prefix(prompt: str, state: np.ndarray) -> str:
    cleaned_text = prompt.lower().strip().replace("_", " ")
    discretized_state = np.digitize(state, bins=np.linspace(-1, 1, 256 + 1)[:-1]) - 1
    state_str = " ".join(map(str, discretized_state))
    return f"Task: {cleaned_text}, State: {state_str};\n"


def _pad_or_truncate(max_len: int, tokens: list, token_mask: list, ar_mask: list, loss_mask: list):
    """Right-pad the four lists with 0/False to ``max_len``, or truncate them (with a warning); as arrays."""
    if len(tokens) < max_len:
        padding = [False] * (max_len - len(tokens))
        tokens, token_mask, ar_mask, loss_mask = (x + padding for x in (tokens, token_mask, ar_mask, loss_mask))
    else:
        if len(tokens) > max_len:
            logger.warning(f"Token length ({len(tokens)}) exceeds max length ({max_len}), truncating.")
        tokens, token_mask, ar_mask, loss_mask = (x[:max_len] for x in (tokens, token_mask, ar_mask, loss_mask))
    return (
        np.asarray(tokens, dtype=np.int32),
        np.asarray(token_mask, dtype=bool),
        np.asarray(ar_mask, dtype=np.int32),
        np.asarray(loss_mask, dtype=bool),
    )


class FASTTokenizer:
    def __init__(self, max_len: int = 256, fast_tokenizer_path: str = "physical-intelligence/fast", codec=None):
        self._max_len = max_len
        self._paligemma = _default_text_codec()
        self._fast = codec if codec is not None else _default_fast_codec(fast_tokenizer_path)
        self._fast_skip_tokens = 128  # skip final 128 PaliGemma special tokens

    def tokenize(
        self, prompt: str, state: np.ndarray, actions: np.ndarray | None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        prefix_tokens = self._paligemma.encode(_discretized_prefix(prompt, state), add_bos=True)
        if actions is not None:
            action_tokens = self._fast(actions[None])[0]
            action_tokens_in_pg = self._act_tokens_to_paligemma_tokens(action_tokens)
            postfix_tokens = (
                self._paligemma.encode("Action: ")
                + action_tokens_in_pg.tolist()
                + self._paligemma.encode("|", add_eos=True)
            )
        else:
            postfix_tokens = []
        # AR mask: 0 on prefix (bidirectional), 1 on postfix (causal); loss on postfix only.
        return _pad_or_truncate(
            self._max_len,
            prefix_tokens + postfix_tokens,
            [True] * (len(prefix_tokens) + len(postfix_tokens)),
            [0] * len(prefix_tokens) + [1] * len(postfix_tokens),
            [False] * len(prefix_tokens) + [True] * len(postfix_tokens),
        )

    def extract_actions(self, tokens: np.ndarray, action_horizon: int, action_dim: int) -> np.ndarray:
        """Parse decoded model tokens back into an action chunk (``kai0_tpu/models/tokenizer.py:395-413``)."""
        if isinstance(self._fast, DCTActionCodec):
            # Offline path: find the mapped action-token region directly (no text roundtrip).
            in_region = (tokens > 0) & (tokens < PALIGEMMA_VOCAB_SIZE - self._fast_skip_tokens) & (
                tokens >= PALIGEMMA_VOCAB_SIZE - 1 - self._fast_skip_tokens - self._fast.bins
            )
            act_tokens = self._act_tokens_to_paligemma_tokens(tokens[in_region])
            if act_tokens.size == 0:
                return np.zeros((action_horizon, action_dim), dtype=np.float32)
            return self._fast.decode([act_tokens.tolist()], time_horizon=action_horizon, action_dim=action_dim)[0]

        decoded_tokens = self._paligemma.decode(tokens.tolist())
        if "Action: " not in decoded_tokens:
            return np.zeros((action_horizon, action_dim), dtype=np.float32)
        raw_action_tokens = np.array(
            self._paligemma.encode(decoded_tokens.split("Action: ")[1].split("|")[0].strip())
        )
        action_tokens = self._act_tokens_to_paligemma_tokens(raw_action_tokens)
        return self._fast.decode([action_tokens.tolist()], time_horizon=action_horizon, action_dim=action_dim)[0]

    def _act_tokens_to_paligemma_tokens(self, tokens: np.ndarray | list[int]) -> np.ndarray:
        if isinstance(tokens, list):
            tokens = np.array(tokens)
        return self._paligemma.vocab_size() - 1 - self._fast_skip_tokens - tokens


# --------------------------------------------------------------------------------------
# RoboArena baseline tokenizers (``kai0_tpu/models/tokenizer.py:421-531``)
# --------------------------------------------------------------------------------------


def _prefix_only_tokenize(codec, prompt: str, state: np.ndarray, max_len: int):
    """Shared prefix assembly for the inference-only baseline tokenizers."""
    tokens = codec.encode(_discretized_prefix(prompt, state), add_bos=True)
    return _pad_or_truncate(max_len, tokens, [True] * len(tokens), [0] * len(tokens), [False] * len(tokens))


class _ActionTokenBaseline:
    """Prompt-only tokenization and the text round trip to the action tokens of the baselines."""

    def __init__(self, max_len: int, codec):
        self._max_len = max_len
        self._paligemma = codec if codec is not None else _default_text_codec()
        self._fast_skip_tokens = 128

    def tokenize(self, prompt: str, state: np.ndarray, actions: np.ndarray | None = None):
        if actions is not None:
            raise NotImplementedError(f"{type(self).__name__} does not support encoding actions (inference only)")
        return _prefix_only_tokenize(self._paligemma, prompt, state, self._max_len)

    def _action_tokens(self, tokens: np.ndarray) -> np.ndarray | None:
        """The action tokens after ``"Action: "`` of the decoded text, or None without one."""
        decoded = self._paligemma.decode(tokens.tolist())
        if "Action: " not in decoded:
            return None
        raw = np.array(self._paligemma.encode(decoded.split("Action: ")[1].split("|")[0].strip()))
        return self._act_tokens_to_paligemma_tokens(raw)

    def _act_tokens_to_paligemma_tokens(self, tokens: np.ndarray | list[int]) -> np.ndarray:
        if isinstance(tokens, list):
            tokens = np.array(tokens)
        return self._paligemma.vocab_size() - 1 - self._fast_skip_tokens - tokens


class BinningTokenizer(_ActionTokenBaseline):
    """RT-2 / OpenVLA-style per-dim binning tokenizer: action tokens decode as ``token / n_bins * 2 - 1``."""

    def __init__(self, max_len: int = 256, n_bins: int = 256, codec=None):
        super().__init__(max_len, codec)
        self._n_bins = n_bins

    def extract_actions(self, tokens: np.ndarray, action_horizon: int, action_dim: int) -> np.ndarray:
        action_tokens = self._action_tokens(tokens)
        if action_tokens is None or len(action_tokens) < action_horizon * action_dim:
            return np.zeros((action_horizon, action_dim), dtype=np.float32)
        action_tokens = action_tokens[: action_horizon * action_dim].reshape(action_horizon, action_dim)
        return action_tokens / self._n_bins * 2 - 1


class FSQTokenizer(_ActionTokenBaseline):
    """FSQ-autoencoder action tokenizer, the FAST paper's baseline: decodes through ``fsq_tokenizer.decode``.

    ``params`` (``fsq_tokenizer.params_from_jax`` of a JAX tree) or
    ``fsq_tokenizer_path`` (those tensors in a ``.safetensors`` file) give the
    codebook's weights; without either it raises (the JAX package
    draws fresh weights from ``jax.random.key(0)``, which the port cannot).
    """

    def __init__(self, max_len: int = 256, fsq_tokenizer_path: str | None = None, codec=None, fsq_config=None,
                 params=None):
        from kai0_tpu_torch.models import fsq_tokenizer as _fsq

        super().__init__(max_len, codec)
        self._fsq = _fsq
        self._fsq_config = fsq_config if fsq_config is not None else _fsq.FsqConfig()
        if params is None and fsq_tokenizer_path is None:
            raise ValueError("FSQTokenizer needs trained params or a .safetensors path (fsq_tokenizer_path): the port "
                             "does not draw untrained ones")
        self._params = params if params is not None else _fsq.load_params(fsq_tokenizer_path)

    def extract_actions(self, tokens: np.ndarray, action_horizon: int, action_dim: int) -> np.ndarray:
        import torch

        action_tokens = self._action_tokens(tokens)
        if action_tokens is None:
            return np.zeros((action_horizon, action_dim), dtype=np.float32)
        try:
            n = self._fsq_config.num_tokens
            if len(action_tokens) < n:
                return np.zeros((action_horizon, action_dim), dtype=np.float32)
            ids = np.clip(action_tokens[:n], 0, self._fsq_config.vocab_size - 1)
            with torch.no_grad():
                detok = self._fsq.decode(self._params, self._fsq_config, torch.from_numpy(ids[None].astype(np.int32)))
            return detok[0].numpy()[:action_horizon, :action_dim]
        except Exception as e:  # noqa: BLE001 — as the JAX package: zeros on a decode failure
            logger.warning(f"Error decoding FSQ: {e}")
            return np.zeros((action_horizon, action_dim), dtype=np.float32)
