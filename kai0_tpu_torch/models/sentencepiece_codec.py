"""Pure-Python SentencePiece codec (unigram + BPE).

The reference tokenizes prompts with the PaliGemma sentencepiece model through
the ``sentencepiece`` wheel (reference ``src/openpi/models/tokenizer.py:18-29``).
That wheel is a C++ extension that is not always installable (and is absent in
this build environment), but the ``.model`` file itself is just a protobuf
(``sentencepiece_model.proto``: unigram pieces + scores + normalizer flags) —
so this module reads the raw file and implements the encode/decode directly:

- a minimal protobuf wire-format reader for ``ModelProto`` (no generated code,
  no protobuf runtime): pieces ``(text, score, type)``, trainer ids
  (unk/bos/eos/pad), byte-fallback flag, normalizer flags;
- SentencePiece normalization: precompiled-charsmap rule application
  (darts-clone double-array longest-match, e.g. nmt_nfkc), optional
  extra-whitespace collapse, optional dummy-" " prefix, whitespace → ``▁``
  (U+2581) escaping;
- unigram **Viterbi** segmentation: maximize the sum of piece log-probs over
  all segmentations, matching only NORMAL/USER_DEFINED pieces, with the
  standard unknown-character penalty (``min_score - 10``) and UTF-8
  byte-fallback expansion of unknown segments;
- **BPE** segmentation (``model_type=2`` — the Gemma/PaliGemma family):
  seed symbols as USER_DEFINED pieces (longest-prefix match, frozen — never
  merged or split; PaliGemma's 1024 ``<locXXXX>`` + 128 ``<segXXX>`` pieces
  are this type) or single characters, then repeatedly merge the adjacent
  non-frozen pair whose concatenation is the best-scoring vocab piece (score
  desc, then leftmost — sentencepiece ``bpe_model.cc`` semantics), UNUSED
  merge targets re-split into their parts at emission (``rev_merge``),
  unknown leftovers → byte fallback;
- piece decode: byte-piece runs → UTF-8, control pieces skipped, ``▁`` →
  space, dummy prefix stripped.

Scope: unigram and BPE models, with or without a precompiled charsmap
(``CharsMap`` reads the darts-clone trie the wheel ships for nmt_nfkc-style
rule normalization). Only WORD/CHAR model types still need the wheel.

Validated two ways: tests/test_sentencepiece_codec.py builds synthetic
``.model`` files and pins segmentation/normalization/byte-fallback behavior,
and cross-checks ids against the real ``sentencepiece`` wheel whenever that is
importable (asset-equipped hosts; see scripts/validate_tokenizer.py).
"""

from __future__ import annotations

import dataclasses

# SentencePiece piece types (sentencepiece_model.proto: SentencePiece.Type).
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6

_WS = "▁"  # ▁, SentencePiece's escaped whitespace
_UNK_PENALTY = 10.0  # unigram_model.cc kUnkPenalty


# --------------------------------------------------------------------------------------
# Protobuf wire-format reader (just enough for ModelProto)
# --------------------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long (corrupt .model file)")


def _iter_fields(buf: bytes, pos: int = 0, end: int | None = None):
    """Yield ``(field_number, wire_type, value)`` over a message's wire bytes.

    Wire 0 → int, wire 1/5 → raw 8/4 bytes, wire 2 → raw bytes (submessage or
    string). Unknown field numbers are skipped by callers, which is what makes
    this reader robust to proto additions.
    """
    end = len(buf) if end is None else end
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos : pos + 8], pos + 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos : pos + ln], pos + ln
        elif wire == 5:
            val, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire} (corrupt .model file)")
        yield field, wire, val


def _f32(raw: bytes) -> float:
    import struct

    return struct.unpack("<f", raw)[0]


@dataclasses.dataclass
class SpModel:
    """The slice of ``ModelProto`` the codec needs."""

    pieces: list[tuple[str, float, int]]  # (text, score, type)
    model_type: int = 1  # 1 = UNIGRAM, 2 = BPE
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    byte_fallback: bool = False
    unk_surface: str = " ⁇ "  # " ⁇ ", trainer_spec default
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    has_charsmap: bool = False
    charsmap: bytes = b""
    normalizer_name: str = ""


def parse_model(data: bytes) -> SpModel:
    """Parse a raw ``.model`` file (ModelProto wire bytes)."""
    pieces: list[tuple[str, float, int]] = []
    m = SpModel(pieces=pieces)
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:  # repeated SentencePiece pieces
            text, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    text = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = _f32(v2)
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append((text, score, ptype))
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 3 and w2 == 0:
                    m.model_type = v2
                elif f2 == 35 and w2 == 0:
                    m.byte_fallback = bool(v2)
                elif f2 == 40 and w2 == 0:
                    m.unk_id = _signed(v2)
                elif f2 == 41 and w2 == 0:
                    m.bos_id = _signed(v2)
                elif f2 == 42 and w2 == 0:
                    m.eos_id = _signed(v2)
                elif f2 == 43 and w2 == 0:
                    m.pad_id = _signed(v2)
                elif f2 == 44 and w2 == 2:
                    m.unk_surface = v2.decode("utf-8")
        elif field == 3 and wire == 2:  # NormalizerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    m.normalizer_name = v2.decode("utf-8")
                elif f2 == 2 and w2 == 2:
                    m.has_charsmap = len(v2) > 0
                    m.charsmap = bytes(v2)
                elif f2 == 3 and w2 == 0:
                    m.add_dummy_prefix = bool(v2)
                elif f2 == 4 and w2 == 0:
                    m.remove_extra_whitespaces = bool(v2)
                elif f2 == 5 and w2 == 0:
                    m.escape_whitespaces = bool(v2)
    return m


def _signed(v: int) -> int:
    """proto int32 negatives arrive as 64-bit two's-complement varints."""
    return v - (1 << 64) if v >= (1 << 63) else v


# --------------------------------------------------------------------------------------
# Precompiled charsmap (rule-based normalization, e.g. nmt_nfkc)
# --------------------------------------------------------------------------------------


def _utf8_len(lead: int) -> int:
    if lead < 0x80:
        return 1
    if 0xC0 <= lead < 0xE0:
        return 2
    if 0xE0 <= lead < 0xF0:
        return 3
    if 0xF0 <= lead < 0xF8:
        return 4
    return 1  # invalid lead byte: copy it through (decoded with errors="replace")


class CharsMap:
    """``NormalizerSpec.precompiled_charsmap`` reader: a darts-clone
    double-array trie over UTF-8 source sequences plus a NUL-terminated
    replacement-string blob (normalizer.cc ``DecodePrecompiledCharsMap`` /
    darts.h unit encoding). Normalization = repeated longest-prefix match →
    replacement, unmatched characters copied through — which is how the wheel
    applies nmt_nfkc-style rules without any Unicode tables at runtime.
    """

    def __init__(self, blob: bytes):
        import struct

        if len(blob) < 4:
            raise ValueError("precompiled charsmap too short")
        (trie_size,) = struct.unpack("<I", blob[:4])
        if 4 + trie_size > len(blob):
            raise ValueError("precompiled charsmap trie overruns the blob")
        self._units = memoryview(blob)[4 : 4 + trie_size].cast("I")
        self._norm = bytes(blob[4 + trie_size :])

    @staticmethod
    def _offset(unit: int) -> int:
        # darts.h: (unit >> 10) << ((unit & (1 << 9)) >> 6)
        return (unit >> 10) << ((unit & 0x200) >> 6)

    def longest_match(self, data: bytes, pos: int) -> tuple[int, bytes] | None:
        """Longest key match at ``data[pos:]`` → (matched byte length, replacement)."""
        units = self._units
        n_units = len(units)
        node = self._offset(units[0])
        best = None
        for i in range(pos, len(data)):
            c = data[i]
            nxt = node ^ c
            if nxt >= n_units:
                break
            unit = units[nxt]
            # label() = unit & (bit31 | 0xFF): value units (bit31 set) never match a byte
            if (unit & 0x800000FF) != c:
                break
            node = nxt ^ self._offset(unit)
            if unit & 0x100:  # has_leaf
                value = units[node] & 0x7FFFFFFF
                end = self._norm.index(0, value)
                best = (i + 1 - pos, self._norm[value:end])
        return best

    def normalize(self, text: str) -> str:
        data = text.encode("utf-8")
        out = bytearray()
        i = 0
        n = len(data)
        while i < n:
            match = self.longest_match(data, i)
            if match is not None:
                length, replacement = match
                out += replacement
                i += length
            else:
                length = _utf8_len(data[i])
                out += data[i : i + length]
                i += length
        return out.decode("utf-8", errors="replace")


# --------------------------------------------------------------------------------------
# Unigram codec
# --------------------------------------------------------------------------------------


class SentencePieceModel:
    """SentencePieceProcessor-shaped pure-Python unigram/BPE encoder-decoder.

    API mirrors the wheel's surface used by ``tokenizer.SentencePieceCodec``:
    ``encode(text) -> list[int]``, ``decode(ids) -> str``, ``vocab_size()``,
    ``bos_id()``, ``eos_id()``, plus ``piece_to_id``/``id_to_piece``.
    """

    def __init__(self, data: bytes):
        m = parse_model(data)
        if not m.pieces:
            raise ValueError("no pieces in .model file (not a sentencepiece model?)")
        if m.model_type not in (1, 2):
            raise NotImplementedError(
                f"pure-Python codec supports unigram/BPE models only (model_type={m.model_type}); "
                "install the `sentencepiece` wheel for word/char models"
            )
        self._charsmap = CharsMap(m.charsmap) if m.has_charsmap else None
        self._m = m
        # Matchable surface vocabulary: NORMAL + USER_DEFINED pieces. The
        # user-defined subset is also kept separately: BPE pre-segments the
        # input with a longest-prefix match over it (bpe_model.cc seeds those
        # as frozen whole symbols), and unigram scores its lattice nodes
        # specially (see _encode_unigram).
        self._vocab: dict[str, tuple[int, float, bool]] = {}  # text -> (id, score, is_ud)
        self._user_defined: dict[str, int] = {}
        # UNUSED pieces join BPE merge candidates (the wheel's ``pieces_`` map
        # includes them) but are re-split into their parts at emission
        # (bpe_model.cc ``rev_merge_``); unigram skips them entirely.
        self._unused: dict[str, tuple[int, float]] = {}
        self._byte_id: dict[int, int] = {}
        max_len = 1
        max_ud_len = 0
        # min score feeds the unk penalty; max score feeds the user-defined
        # lattice bonus. Both span the matchable pieces (NORMAL +
        # USER_DEFINED, the wheel's ``pieces_`` map): unigram log-prob scores
        # are negative while USER_DEFINED pieces conventionally carry 0.0, so
        # with any UD piece present max_score is 0 and the UD node score below
        # collapses to −0.1 — "always selected".
        min_score = 0.0
        max_score = 0.0
        for i, (text, score, ptype) in enumerate(m.pieces):
            if ptype in (NORMAL, USER_DEFINED):
                self._vocab[text] = (i, score, ptype == USER_DEFINED)
                max_len = max(max_len, len(text))
                min_score = min(min_score, score)
                max_score = max(max_score, score)
                if ptype == USER_DEFINED:
                    self._user_defined[text] = i
                    max_ud_len = max(max_ud_len, len(text))
            elif ptype == UNUSED:
                self._unused[text] = (i, score)
            elif ptype == BYTE:
                # "<0xNN>" → byte value NN
                self._byte_id[int(text[1:-1], 16)] = i
        self._max_piece_len = max_len
        self._max_ud_len = max_ud_len
        self._max_score = max_score
        self._unk_score = min_score - _UNK_PENALTY
        if m.byte_fallback and len(self._byte_id) < 256:
            raise ValueError("byte_fallback model without a full set of 256 byte pieces")

    # -- SentencePieceProcessor surface ------------------------------------------------

    def vocab_size(self) -> int:
        return len(self._m.pieces)

    def bos_id(self) -> int:
        return self._m.bos_id

    def eos_id(self) -> int:
        return self._m.eos_id

    def unk_id(self) -> int:
        return self._m.unk_id

    def pad_id(self) -> int:
        return self._m.pad_id

    def id_to_piece(self, i: int) -> str:
        return self._m.pieces[i][0]

    def piece_to_id(self, piece: str) -> int:
        entry = self._vocab.get(piece)
        if entry is not None:
            return entry[0]
        for i, (text, _, _) in enumerate(self._m.pieces):
            if text == piece:
                return i
        return self._m.unk_id

    # -- normalization -----------------------------------------------------------------

    def _normalize(self, text: str) -> str:
        m = self._m
        if self._charsmap is not None:
            # Rule-based normalization (e.g. nmt_nfkc) runs BEFORE the
            # whitespace steps, exactly like normalizer.cc.
            text = self._charsmap.normalize(text)
        if m.remove_extra_whitespaces:
            # leading/trailing ' ' stripped, internal runs collapsed (only the
            # ASCII space takes part — matches the SP normalizer).
            text = " ".join(p for p in text.split(" ") if p)
        if not text:
            return ""
        if m.add_dummy_prefix:
            text = " " + text
        if m.escape_whitespaces:
            text = text.replace(" ", _WS)
        return text

    # -- encode ------------------------------------------------------------------------

    def encode(self, text: str, out_type=int) -> list[int]:
        del out_type  # ids only (the wheel's default)
        s = self._normalize(text)
        if not s:
            return []
        if self._m.model_type == 2:
            return self._encode_bpe(s)
        return self._encode_unigram(s)

    def _emit(self, ids: list[int], surface: str) -> None:
        """Append the out-of-vocab surface as byte pieces (or unk)."""
        if self._m.byte_fallback:
            ids.extend(self._byte_id[b] for b in surface.encode("utf-8"))
        else:
            ids.append(self._m.unk_id)

    def _split_user_defined(self, s: str) -> tuple[list[str], list[bool]]:
        """Seed symbols for BPE: a longest-prefix match over USER_DEFINED
        pieces at each position (bpe_model.cc's ``PrefixMatcher``), single
        characters elsewhere. Matched symbols come back *frozen* — the wheel
        never merges them with neighbours nor splits them further, which is
        what keeps e.g. PaliGemma's ``<locXXXX>``/``<segXXX>`` pieces atomic."""
        syms: list[str] = []
        frozen: list[bool] = []
        ud = self._user_defined
        max_ud = self._max_ud_len
        n = len(s)
        i = 0
        while i < n:
            matched = 0
            for ln in range(min(max_ud, n - i), 0, -1):
                if s[i : i + ln] in ud:
                    matched = ln
                    break
            if matched:
                syms.append(s[i : i + matched])
                frozen.append(True)
                i += matched
            else:
                syms.append(s[i])
                frozen.append(False)
                i += 1
        return syms, frozen

    def _encode_bpe(self, s: str) -> list[int]:
        """sentencepiece BPE (``bpe_model.cc``): seed symbols as user-defined
        pieces (frozen, via longest-prefix match) or single characters, then
        keep merging the adjacent non-frozen pair whose concatenation is in
        the vocab — NORMAL, USER_DEFINED or UNUSED — with the HIGHEST score
        (ties → leftmost pair, then insertion order) until no merge applies.
        Merges whose target is an UNUSED piece are recorded in ``rev_merge``
        and re-split into their parts at emission (the wheel's hierarchical
        merge trick); leftover out-of-vocab symbols byte-fallback."""
        import heapq

        syms, frozen = self._split_user_defined(s)
        n = len(syms)
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        alive = [True] * n
        vocab = self._vocab
        unused = self._unused
        rev_merge: dict[str, tuple[str, str]] = {}
        heap: list = []
        serial = 0

        def push(left: int, right: int) -> None:
            nonlocal serial
            if left < 0 or right < 0 or frozen[left] or frozen[right]:
                return
            piece = syms[left] + syms[right]
            entry = vocab.get(piece)
            if entry is None:
                entry = unused.get(piece)
                if entry is None:
                    return
                # recorded at candidate time, later pushes overwrite — matches
                # bpe_model.cc's rev_merge_ insertion in MaybeAddNewSymbolPair
                rev_merge[piece] = (syms[left], syms[right])
            heapq.heappush(heap, (-entry[1], left, serial, len(piece), right))
            serial += 1

        for i in range(n - 1):
            push(i, i + 1)
        while heap:
            _, left, _, size, right = heapq.heappop(heap)
            # stale entries: either symbol already merged away or re-merged
            if (
                not alive[left]
                or not alive[right]
                or nxt[left] != right
                or len(syms[left]) + len(syms[right]) != size
            ):
                continue
            syms[left] = syms[left] + syms[right]
            alive[right] = False
            nxt[left] = nxt[right]
            if nxt[right] != -1:
                prv[nxt[right]] = left
            push(prv[left], left)
            push(left, nxt[left])

        ids: list[int] = []

        def resegment(piece: str) -> None:
            entry = vocab.get(piece)
            if entry is not None:
                ids.append(entry[0])
                return
            parts = rev_merge.get(piece)
            if parts is None:
                ue = unused.get(piece)
                if ue is not None:
                    # bpe_model.cc resegment: an UNUSED symbol with NO recorded
                    # merge (it was seeded directly, e.g. a single-char UNUSED
                    # piece) emits its own id rather than byte-fallback
                    ids.append(ue[0])
                else:
                    self._emit(ids, piece)
                return
            resegment(parts[0])
            resegment(parts[1])

        idx = 0
        while idx != -1:
            resegment(syms[idx])
            idx = nxt[idx]
        return ids

    def _encode_unigram(self, s: str) -> list[int]:
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        best[0] = 0.0
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        vocab = self._vocab
        max_len = self._max_piece_len
        for i in range(n):
            base = best[i]
            if base == NEG:
                continue
            covered_single = False
            for j in range(i + 1, min(n, i + max_len) + 1):
                entry = vocab.get(s[i:j])
                if entry is None:
                    continue
                if j == i + 1:
                    covered_single = True
                pid, score, is_ud = entry
                if is_ud:
                    # unigram_model.cc PopulateNodes: "User defined symbol
                    # receives extra bonus to always be selected" — its lattice
                    # score is char_len·max_score − 0.1 (max over NORMAL
                    # pieces), not the proto score.
                    score = (j - i) * self._max_score - 0.1
                cand = base + score
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (i, pid)
            if not covered_single:
                # Unknown character: unigram's per-char unk node with the
                # min_score-10 penalty (expanded to bytes at emission below).
                cand = base + self._unk_score
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = (i, self._m.unk_id)
        ids: list[int] = []
        j = n
        unk = self._m.unk_id
        while j > 0:
            i, pid = back[j]  # type: ignore[misc] — every position is reachable via unk
            if pid == unk and self._m.byte_fallback:
                for b in reversed(s[i:j].encode("utf-8")):
                    ids.append(self._byte_id[b])
            elif pid == unk and ids and ids[-1] == unk:
                # the wheel merges contiguous unknown characters into ONE unk
                # token (unigram_model.cc) — match it (reversed order here, so
                # dropping the later duplicate merges the run)
                pass
            else:
                ids.append(pid)
            j = i
        ids.reverse()
        return ids

    # -- decode ------------------------------------------------------------------------

    def decode(self, ids: list[int]) -> str:
        pieces = self._m.pieces
        parts: list[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if not 0 <= int(i) < len(pieces):
                continue
            text, _, ptype = pieces[int(i)]
            if ptype == BYTE:
                byte_buf.append(int(text[1:-1], 16))
                continue
            flush()
            if ptype in (CONTROL, UNUSED):
                continue  # bos/eos/pad render as nothing
            if ptype == UNKNOWN:
                parts.append(self._m.unk_surface)
                continue
            parts.append(text)
        flush()
        out = "".join(parts).replace(_WS, " ")
        if self._m.add_dummy_prefix and out.startswith(" "):
            out = out[1:]
        return out


# Back-compat alias (the class predates BPE support).
UnigramSentencePiece = SentencePieceModel
