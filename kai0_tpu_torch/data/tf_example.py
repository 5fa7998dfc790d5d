"""``tf.train.Example`` decoded and encoded by hand (protobuf wire format, no TensorFlow).

The nesting: ``Example.features`` (field 1) → ``Features.feature`` (field 1),
a map whose entries hold the key (1) and a ``Feature`` (2) → one of
``bytes_list`` (1), ``float_list`` (2) or ``int64_list`` (3) → ``value`` (1).
Floats and int64s are read packed or unpacked; int64s are two's-complement
varints (not zigzag). ``decode_example`` returns, per key, a list of ``bytes``
for a bytes list, a float32 array for a float list, an int64 array for an int64
list, and ``None`` for a ``Feature`` with no list set. ``encode_example`` writes
floats and int64s packed, as TensorFlow does.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np

_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5


def _read_varint(buf, pos: int) -> tuple[int, int]:
    b = buf[pos]
    if b < 0x80:
        return b, pos + 1
    result, shift = b & 0x7F, 7
    pos += 1
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("a varint longer than 10 bytes")


def _fields(buf, pos: int, end: int):
    """(field number, wire type, value) of each field in ``buf[pos:end]``: an int for a varint, ``(start, stop)``
    for a length-delimited field, the raw offset for fixed-width ones."""
    while pos < end:
        key, pos = _read_varint(buf, pos)
        wire = key & 7
        if wire == _VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _LEN:
            length, pos = _read_varint(buf, pos)
            value = (pos, pos + length)
            pos += length
        elif wire == _FIXED32:
            value = pos
            pos += 4
        elif wire == _FIXED64:
            value = pos
            pos += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        if pos > end:
            raise ValueError("a protobuf field runs past its message")
        yield key >> 3, wire, value


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _packed_varints(buf, start: int, stop: int) -> list[int]:
    out, pos = [], start
    while pos < stop:
        v, pos = _read_varint(buf, pos)
        out.append(_signed(v))
    if pos != stop:
        raise ValueError("a packed varint runs past its field")
    return out


def _bytes_values(buf, pos: int, stop: int) -> list[bytes] | None:
    """The values of a bytes list whose every field is ``value`` (the form writers give); None for any other."""
    values = []
    while pos < stop:
        if buf[pos] != 0x0A:  # field 1, length-delimited
            return None
        length, pos = _read_varint(buf, pos + 1)
        values.append(buf[pos:pos + length])
        pos += length
    return values if pos == stop else None


def _decode_feature(buf, start: int, stop: int):
    # A feature that is one bytes list (an episode's images and strings): read without the generic field loop.
    if stop - start >= 2 and buf[start] == 0x0A:
        length, pos = _read_varint(buf, start + 1)
        if pos + length == stop and (values := _bytes_values(buf, pos, stop)) is not None:
            return values
    kind = None
    values: list = []
    for number, _, (lo, hi) in ((n, w, v) for n, w, v in _fields(buf, start, stop) if w == _LEN):
        if number not in (1, 2, 3):
            continue
        kind, values = number, []  # the last list set wins, as protobuf's oneof
        for field, wire, value in _fields(buf, lo, hi):
            if field != 1:
                continue
            if number == 1 and wire == _LEN:
                values.append(buf[value[0]:value[1]])
            elif number == 2 and wire == _LEN:
                a, b = value
                if (b - a) % 4:
                    raise ValueError("a packed float list whose length is not a multiple of 4")
                values.append(np.frombuffer(buf, "<f4", (b - a) // 4, a))
            elif number == 2 and wire == _FIXED32:
                values.append(np.frombuffer(buf, "<f4", 1, value))
            elif number == 3 and wire == _LEN:
                a, b = value
                raw = np.frombuffer(buf, np.uint8, b - a, a)
                # Every value under 128 (one byte each, the common case of flags and small counts): no loop.
                values.append(raw.astype(np.int64) if not (raw & 0x80).any() else
                              np.asarray(_packed_varints(buf, a, b), np.int64))
            elif number == 3 and wire == _VARINT:
                values.append(np.asarray([_signed(value)], np.int64))
            else:
                raise ValueError(f"feature list {number} holds a value of wire type {wire}")
    if kind is None:
        return None
    if kind == 1:
        return values
    dtype = np.float32 if kind == 2 else np.int64
    return np.concatenate(values).astype(dtype, copy=False) if values else np.zeros(0, dtype)


def decode_example(data, keys=None) -> dict:
    """The features of a serialized ``tf.train.Example``: key → list of bytes, float32 array, int64 array or None;
    only those named in ``keys`` when it is given (the others are skipped undecoded)."""
    buf = data if isinstance(data, bytes) else bytes(data)
    out = {}
    try:
        for number, wire, value in _fields(buf, 0, len(buf)):
            if number != 1 or wire != _LEN:
                continue
            for entry_number, entry_wire, (lo, hi) in _fields(buf, *value):
                if entry_number != 1 or entry_wire != _LEN:
                    continue
                key, feature = "", None
                for field, field_wire, span in _fields(buf, lo, hi):
                    if field == 1 and field_wire == _LEN:
                        key = buf[span[0]:span[1]].decode("utf-8")
                    elif field == 2 and field_wire == _LEN:
                        feature = span
                if keys is None or key in keys:
                    out[key] = _decode_feature(buf, *feature) if feature is not None else None
    except IndexError as e:
        raise ValueError("a truncated tf.train.Example") from e
    return out


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _length_delimited(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | _LEN) + _varint(len(payload)) + payload


def _encode_feature(value) -> bytes:
    if isinstance(value, np.ndarray) and value.dtype.kind in "biuf":
        if value.dtype.kind == "f":
            packed = np.ascontiguousarray(value, "<f4").tobytes()
            number = 2
        else:
            packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in value.reshape(-1).astype(np.int64))
            number = 3
        inner = _length_delimited(1, packed) if packed else b""
        return _length_delimited(number, inner)
    if isinstance(value, (str, bytes)):
        value = [value]
    if not isinstance(value, Sequence):
        raise TypeError(f"a feature is a list of bytes or a numeric numpy array, not {type(value).__name__}")
    inner = b"".join(_length_delimited(1, v.encode("utf-8") if isinstance(v, str) else bytes(v)) for v in value)
    return _length_delimited(1, inner)


def encode_example(features: Mapping) -> bytes:
    """A serialized ``tf.train.Example`` of ``features``: key → a sequence of bytes (or str), or a numpy array
    (floats as a float list, integers and bools as an int64 list), written packed."""
    entries = b"".join(
        _length_delimited(1, _length_delimited(1, key.encode("utf-8")) + _length_delimited(2, _encode_feature(value)))
        for key, value in features.items()
    )
    return _length_delimited(1, entries)
