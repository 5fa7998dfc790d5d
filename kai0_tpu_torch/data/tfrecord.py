"""TFRecord files read and written without TensorFlow.

A record is ``uint64 length | uint32 masked_crc32c(length) | payload |
uint32 masked_crc32c(payload)``, little endian, where the mask is
``((c >> 15) | (c << 17)) + 0xa282ead8`` mod 2^32 and the CRC is CRC-32C
(Castagnoli), computed by the native extension (``native.load_crc32c``: it
builds or raises; there is no Python path). Both CRCs are checked on read, as
TensorFlow's reader checks them: a bad or truncated record raises
``ValueError`` with the file and the byte offset.

The writer makes the shards that the tests and ``chip_smoke.py`` stream on a
machine without TensorFlow.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator
import pathlib
import struct

_LENGTH = struct.Struct("<Q")
_CRC = struct.Struct("<I")


def _native():
    from kai0_tpu_torch import native

    return native.load_crc32c()


def masked_crc32c(data) -> int:
    """TFRecord's masked CRC-32C of ``data`` (any bytes-like object)."""
    return _native().masked_crc32c(data)


def encode_record(payload: bytes) -> bytes:
    """One framed record."""
    crc = _native().masked_crc32c
    length = _LENGTH.pack(len(payload))
    return b"".join((length, _CRC.pack(crc(length)), payload, _CRC.pack(crc(payload))))


def write_records(path: str | pathlib.Path, payloads: Iterable[bytes]) -> int:
    """Write ``payloads`` as one TFRecord file; returns the bytes written."""
    written = 0
    with open(path, "wb") as f:
        for payload in payloads:
            written += f.write(encode_record(payload))
    return written


def read_records(path: str | pathlib.Path) -> Iterator[bytes]:
    """Each record's payload of a TFRecord file, in order, both CRCs checked."""
    crc = _native().masked_crc32c
    with open(path, "rb") as f:
        offset = 0
        while header := f.read(12):
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header at byte {offset}")
            (length,) = _LENGTH.unpack_from(header)
            if crc(header[:8]) != _CRC.unpack_from(header, 8)[0]:
                raise ValueError(f"{path}: corrupted record length at byte {offset} (its crc32c does not match)")
            payload, footer = f.read(length), f.read(4)
            if len(footer) < 4:
                raise ValueError(f"{path}: truncated record at byte {offset}: {length} payload bytes and a crc "
                                 f"announced, {len(payload) + len(footer)} bytes there")
            if crc(payload) != _CRC.unpack(footer)[0]:
                raise ValueError(f"{path}: corrupted record at byte {offset} (the payload's crc32c does not match)")
            yield payload
            offset += 12 + length + 4
