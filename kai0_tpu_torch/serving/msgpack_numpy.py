"""MessagePack with NumPy arrays, in the standard library: the wire format of the policy server.

The port's copy of ``packages/kai0-client/src/kai0_client/msgpack_numpy.py``,
which needs the ``msgpack`` package. It writes the bytes that
``msgpack.packb(obj, default=pack_array)`` writes (``use_bin_type``, doubles,
the smallest integer format, map keys in insertion order) and reads what
``msgpack.unpackb(data, object_hook=unpack_array)`` reads: nil, bool,
integers up to 64 bits, float32 and float64, str, bin, arrays (as lists) and
maps (str or bytes keys). Extension types are refused.

``ndarray``s travel as ``{b"__ndarray__": True, b"data", b"dtype", b"shape"}``
and NumPy scalars that are no Python ``int``/``float``/``str`` subclass as
``{b"__npgeneric__": True, b"data", b"dtype"}``; object, void and complex
dtypes are refused, so decoding never runs code.
"""

from __future__ import annotations

import struct

import numpy as np

_REJECTED_KINDS = ("V", "O", "c")
_MAX_DEPTH = 512


def pack_array(obj):
    if isinstance(obj, (np.ndarray, np.generic)) and obj.dtype.kind in _REJECTED_KINDS:
        raise ValueError(f"Unsupported dtype: {obj.dtype}")
    if isinstance(obj, np.ndarray):
        return {b"__ndarray__": True, b"data": obj.tobytes(), b"dtype": obj.dtype.str, b"shape": obj.shape}
    if isinstance(obj, np.generic):
        return {b"__npgeneric__": True, b"data": obj.item(), b"dtype": obj.dtype.str}
    return obj


def unpack_array(obj):
    if b"__ndarray__" in obj:
        return np.ndarray(buffer=obj[b"data"], dtype=np.dtype(obj[b"dtype"]), shape=obj[b"shape"])
    if b"__npgeneric__" in obj:
        return np.dtype(obj[b"dtype"]).type(obj[b"data"])
    return obj


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _pack_int(x: int, out: list) -> None:
    if 0 <= x < 128:
        out.append(struct.pack("B", x))
    elif -32 <= x < 0:
        out.append(struct.pack("b", x))
    elif x >= 0:
        for limit, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"), (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
            if x < limit:
                out.append(bytes((code,)) + struct.pack(fmt, x))
                return
        raise OverflowError("Integer value out of range")
    else:
        for limit, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"), (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
            if x >= -limit:
                out.append(bytes((code,)) + struct.pack(fmt, x))
                return
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple[int, int, int], out: list) -> None:
    """A str, bin, array or map header: the fix form below ``fix_max``, then 8-, 16- and 32-bit lengths."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
    elif codes[0] and n < 1 << 8:
        out.append(bytes((codes[0], n)))
    elif n < 1 << 16:
        out.append(bytes((codes[1],)) + struct.pack(">H", n))
    elif n < 1 << 32:
        out.append(bytes((codes[2],)) + struct.pack(">I", n))
    else:
        raise ValueError(f"{n} items or bytes exceed MessagePack's 32-bit length")


def _pack(obj, out: list, default, depth: int, will_default: bool = True) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("recursion limit exceeded")
    # The order of msgpack's packer, which accepts subclasses (a numpy float64 is packed as a float).
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(bytes(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (0, 0xDE, 0xDF), out)
        for key, value in obj.items():
            _pack(key, out, default, depth + 1)
            _pack(value, out, default, depth + 1)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (0, 0xDC, 0xDD), out)
        for value in obj:
            _pack(value, out, default, depth + 1)
    elif isinstance(obj, memoryview):
        data = obj.tobytes()
        _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif will_default:
        _pack(default(obj), out, default, depth, will_default=False)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj, default=pack_array) -> bytes:
    """``obj`` as MessagePack bytes; ``default`` maps what MessagePack has no type for."""
    out: list = []
    _pack(obj, out, default, 0)
    return b"".join(out)


class Packer:
    """``msgpack.Packer(default=pack_array)``'s ``pack``."""

    def __init__(self, default=pack_array):
        self._default = default

    def pack(self, obj) -> bytes:
        return packb(obj, self._default)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

_FIXED = {  # code: (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {0xC4: 1, 0xC5: 2, 0xC6: 4, 0xD9: 1, 0xDA: 2, 0xDB: 4, 0xDC: 2, 0xDD: 4, 0xDE: 2, 0xDF: 4}
_LENGTH_FORMAT = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data, object_hook):
        self.data = memoryview(data)
        self.pos = 0
        self.object_hook = object_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated MessagePack data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def read(self, depth: int = 0):
        if depth > _MAX_DEPTH:
            raise ValueError("recursion limit exceeded")
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.read_map(code & 0x0F, depth)
        if 0x90 <= code <= 0x9F:
            return self.read_array(code & 0x0F, depth)
        if 0xA0 <= code <= 0xBF:
            return str(self.take(code & 0x1F), "utf-8")
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _FIXED:
            fmt, size = _FIXED[code]
            return struct.unpack(fmt, self.take(size))[0]
        if code in _LENGTH:
            size = _LENGTH[code]
            n = struct.unpack(_LENGTH_FORMAT[size], self.take(size))[0]
            if code <= 0xC6:
                return bytes(self.take(n))
            if code <= 0xDB:
                return str(self.take(n), "utf-8")
            if code <= 0xDD:
                return self.read_array(n, depth)
            return self.read_map(n, depth)
        raise ValueError(f"MessagePack type 0x{code:02x} (an extension or a reserved code) is not supported")

    def read_array(self, n: int, depth: int) -> list:
        return [self.read(depth + 1) for _ in range(n)]

    def read_map(self, n: int, depth: int):
        out = {}
        for _ in range(n):
            key = self.read(depth + 1)
            if type(key) not in (str, bytes):
                raise ValueError(f"{type(key).__name__} is not allowed for map key")
            out[key] = self.read(depth + 1)
        return self.object_hook(out) if self.object_hook else out


def unpackb(data, object_hook=unpack_array):
    """The one object of MessagePack ``data``; ``object_hook`` maps every decoded map."""
    reader = _Reader(data, object_hook)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("extra data after the MessagePack object")
    return obj
