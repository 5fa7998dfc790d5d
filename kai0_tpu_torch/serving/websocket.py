"""The part of the WebSocket protocol (RFC 6455) that the policy server and its clients use, in the standard library.

The port's server and client run where the ``websockets`` package is not
installed (the card's machine). What they speak, and what ``websockets`` and
``kai0_client`` speak to them:

- the opening handshake over HTTP/1.1 (``Sec-WebSocket-Accept`` = base64 of
  the SHA-1 of the key and the RFC's GUID); no extensions, no subprotocols;
- ``GET /healthz`` answered ``200 OK`` over plain HTTP, before any handshake;
- binary and text messages, in one frame or continued over several, with
  7-, 16- and 64-bit payload lengths; frames from a client are masked, frames
  from the server are not;
- ping (answered by a pong at once), pong (ignored) and the closing
  handshake, with its status code.

``serve`` runs the server on ``asyncio`` streams: a reader task per
connection takes frames off the socket as they come, so a ping is answered
while the server computes a reply. ``connect`` opens a blocking client on a
``socket``; it answers pings when it reads. Messages have no size limit.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import http
import logging
import os
import socket
import struct
import urllib.parse

import numpy as np

logger = logging.getLogger("kai0_tpu_torch")

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_CONTINUATION, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA
CLOSE_NORMAL, CLOSE_PROTOCOL_ERROR, CLOSE_NO_STATUS, CLOSE_ABNORMAL, CLOSE_INTERNAL_ERROR = 1000, 1002, 1005, 1006, 1011
HEALTH_PATH = "/healthz"
_HEAD_LIMIT = 1 << 16  # bytes of an HTTP request or response head
_CLOSE_TIMEOUT_S = 10.0  # how long a closing side waits for the peer's close frame


class ConnectionClosed(Exception):
    """The connection is closed; ``code`` is the peer's close code (1006 when it went away without one)."""

    def __init__(self, code: int = CLOSE_ABNORMAL, reason: str = ""):
        super().__init__(f"connection closed: {code} {reason}".rstrip())
        self.code, self.reason = code, reason


class ProtocolError(Exception):
    """The peer broke the protocol."""


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1((key + _GUID).encode()).digest()).decode()


def apply_mask(data, key: bytes) -> bytes:
    """XOR ``data`` with the 4-byte masking ``key`` repeated (its own inverse)."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty_like(src)
    words = len(src) // 4 * 4
    np.bitwise_xor(src[:words].view(np.uint32), np.frombuffer(key, np.uint32)[0], out=out[:words].view(np.uint32))
    out[words:] = src[words:] ^ np.frombuffer(key, np.uint8)[: len(src) - words]
    return out.tobytes()


def frame_header(opcode: int, length: int, mask_key: bytes | None = None) -> bytes:
    """The header of one final frame: FIN, opcode, the payload length in 7, 16 or 64 bits, the masking key."""
    mask_bit = 0x80 if mask_key else 0
    if length < 126:
        header = struct.pack(">BB", 0x80 | opcode, mask_bit | length)
    elif length < 1 << 16:
        header = struct.pack(">BBH", 0x80 | opcode, mask_bit | 126, length)
    else:
        header = struct.pack(">BBQ", 0x80 | opcode, mask_bit | 127, length)
    return header + (mask_key or b"")


def _close_payload(code: int, reason: str) -> bytes:
    return b"" if code == CLOSE_NO_STATUS else struct.pack(">H", code) + reason.encode()


def _parse_close(payload: bytes) -> tuple[int, str]:
    if len(payload) >= 2:
        return struct.unpack(">H", payload[:2])[0], payload[2:].decode("utf-8", "replace")
    return CLOSE_NO_STATUS, ""


class _Frames:
    """The checks of frame headers and the assembly of messages from data frames, shared by the server's and the
    client's readers."""

    def __init__(self, expect_masked: bool):
        self.expect_masked = expect_masked
        self.parts: list[bytes] = []
        self.opcode: int | None = None

    @staticmethod
    def lengths(head: bytes) -> tuple[bool, int, bool, int]:
        b0, b1 = head
        if b0 & 0x70:
            raise ProtocolError("reserved bits set (no extension was negotiated)")
        return bool(b0 & 0x80), b0 & 0x0F, bool(b1 & 0x80), b1 & 0x7F

    def check(self, fin: bool, opcode: int, masked: bool, length: int) -> None:
        if masked != self.expect_masked:
            raise ProtocolError("a client must mask its frames and a server must not")
        if opcode >= 0x8:
            if opcode not in (OP_CLOSE, OP_PING, OP_PONG):
                raise ProtocolError(f"unknown control opcode {opcode}")
            if not fin or length > 125:
                raise ProtocolError("a control frame must be final and at most 125 bytes")
        elif opcode == OP_CONTINUATION:
            if self.opcode is None:
                raise ProtocolError("a continuation frame without a message to continue")
        elif opcode in (OP_TEXT, OP_BINARY):
            if self.opcode is not None:
                raise ProtocolError("a new message before the last one ended")
        else:
            raise ProtocolError(f"unknown data opcode {opcode}")

    def add(self, fin: bool, opcode: int, payload: bytes) -> bytes | str | None:
        """Add a data frame; returns the message when ``fin`` ends it."""
        if opcode != OP_CONTINUATION:
            self.opcode = opcode
        self.parts.append(payload)
        if not fin:
            return None
        data = self.parts[0] if len(self.parts) == 1 else b"".join(self.parts)
        opcode, self.parts, self.opcode = self.opcode, [], None
        if opcode != OP_TEXT:
            return data
        try:
            return data.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ProtocolError(f"a text message that is not UTF-8: {e}") from e


def _parse_head(head: bytes) -> tuple[str, dict[str, str]]:
    """The first line and the headers (lower-case names; repeated ones joined by commas) of an HTTP head."""
    first, *lines = head.decode("latin-1").split("\r\n")
    headers: dict[str, str] = {}
    for line in lines:
        if line:
            name, _, value = line.partition(":")
            name = name.strip().lower()
            headers[name] = f"{headers[name]}, {value.strip()}" if name in headers else value.strip()
    return first, headers


def _tokens(value: str) -> set[str]:
    return {t.strip().lower() for t in value.split(",")}


def _http_response(status: http.HTTPStatus, body: str = "", headers: dict | None = None) -> bytes:
    lines = [f"HTTP/1.1 {status.value} {status.phrase}"]
    fields = dict(headers or {})
    if status != http.HTTPStatus.SWITCHING_PROTOCOLS:
        fields.update({"Connection": "close", "Content-Type": "text/plain; charset=utf-8",
                       "Content-Length": str(len(body.encode()))})
    lines += [f"{k}: {v}" for k, v in fields.items()]
    return ("\r\n".join(lines) + "\r\n\r\n" + body).encode()


# ---------------------------------------------------------------------------
# Server (asyncio)
# ---------------------------------------------------------------------------


class ServerConnection:
    """One accepted WebSocket: ``recv`` and ``send`` whole messages, ``close`` with a code."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader, self._writer = reader, writer
        self.remote_address = writer.get_extra_info("peername")
        self._messages: asyncio.Queue = asyncio.Queue()
        self._closed: ConnectionClosed | None = None
        self._close_sent = False
        self._reader_task = asyncio.get_running_loop().create_task(self._read_loop())

    def _write_frame(self, opcode: int, payload: bytes) -> None:
        # Header and payload are written without an await between them: frames never interleave.
        self._writer.write(frame_header(opcode, len(payload)))
        self._writer.write(payload)

    async def _read_loop(self) -> None:
        frames = _Frames(expect_masked=True)
        try:
            while True:
                fin, opcode, masked, length = frames.lengths(await self._reader.readexactly(2))
                if length == 126:
                    length = struct.unpack(">H", await self._reader.readexactly(2))[0]
                elif length == 127:
                    length = struct.unpack(">Q", await self._reader.readexactly(8))[0]
                    if length >> 63:
                        raise ProtocolError("a 64-bit length must have its top bit clear")
                frames.check(fin, opcode, masked, length)
                key = await self._reader.readexactly(4)
                payload = apply_mask(await self._reader.readexactly(length), key)
                if opcode == OP_PING:
                    if not self._close_sent:
                        self._write_frame(OP_PONG, payload)
                elif opcode == OP_CLOSE:
                    code, reason = _parse_close(payload)
                    if not self._close_sent:
                        self._close_sent = True
                        self._write_frame(OP_CLOSE, _close_payload(code, ""))
                        await self._writer.drain()
                    raise ConnectionClosed(code, reason)
                elif opcode != OP_PONG and (message := frames.add(fin, opcode, payload)) is not None:
                    self._messages.put_nowait(message)
        except ConnectionClosed as e:
            self._closed = e
        except ProtocolError as e:
            logger.warning(f"WebSocket protocol error from {self.remote_address}: {e}")
            self._closed = ConnectionClosed(CLOSE_PROTOCOL_ERROR, str(e))
            await self._send_close(CLOSE_PROTOCOL_ERROR, str(e)[:100])
        except (asyncio.IncompleteReadError, ConnectionError):
            self._closed = ConnectionClosed()
        finally:
            if self._closed is None:  # cancelled
                self._closed = ConnectionClosed()
            self._messages.put_nowait(None)

    async def recv(self) -> bytes | str:
        """The next message: bytes for a binary one, str for text; raises ``ConnectionClosed`` once closed."""
        message = await self._messages.get()
        if message is None:
            self._messages.put_nowait(None)
            raise self._closed
        return message

    async def send(self, message: bytes | str) -> None:
        if self._closed is not None or self._close_sent:
            raise self._closed or ConnectionClosed()
        if isinstance(message, str):
            self._write_frame(OP_TEXT, message.encode())
        else:
            self._write_frame(OP_BINARY, bytes(message))
        await self._writer.drain()

    async def _send_close(self, code: int, reason: str) -> None:
        if not self._close_sent:
            self._close_sent = True
            try:
                self._write_frame(OP_CLOSE, _close_payload(code, reason))
                await self._writer.drain()
            except ConnectionError:
                pass

    async def close(self, code: int = CLOSE_NORMAL, reason: str = "") -> None:
        """Send a close frame, wait a while for the peer's, and close the socket."""
        await self._send_close(code, reason)
        try:
            await asyncio.wait_for(asyncio.shield(self._reader_task), _CLOSE_TIMEOUT_S)
        except asyncio.TimeoutError:
            self._reader_task.cancel()
        self._writer.close()


async def _handshake(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> bool:
    """Answer the HTTP request: True when it opened a WebSocket, False when it was answered otherwise."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, ConnectionError):
        return False
    first, headers = _parse_head(head)
    parts = first.split(" ")
    if len(parts) != 3 or parts[0] != "GET":
        writer.write(_http_response(http.HTTPStatus.BAD_REQUEST, "Only GET requests are served.\n"))
        return False
    if urllib.parse.urlsplit(parts[1]).path == HEALTH_PATH:
        writer.write(_http_response(http.HTTPStatus.OK, "OK\n"))
        return False
    if "websocket" not in _tokens(headers.get("upgrade", "")) or "upgrade" not in _tokens(headers.get("connection", "")):
        writer.write(_http_response(http.HTTPStatus.UPGRADE_REQUIRED, "Failed to open a WebSocket connection: "
                                    "expected an Upgrade: websocket request.\n", {"Upgrade": "websocket"}))
        return False
    key = headers.get("sec-websocket-key", "")
    try:
        valid_key = len(base64.b64decode(key, validate=True)) == 16
    except ValueError:
        valid_key = False
    if not valid_key or headers.get("sec-websocket-version") != "13":
        writer.write(_http_response(http.HTTPStatus.BAD_REQUEST, "Failed to open a WebSocket connection: invalid "
                                    "Sec-WebSocket-Key or Sec-WebSocket-Version.\n", {"Sec-WebSocket-Version": "13"}))
        return False
    writer.write(_http_response(http.HTTPStatus.SWITCHING_PROTOCOLS, headers={
        "Upgrade": "websocket", "Connection": "Upgrade", "Sec-WebSocket-Accept": accept_key(key)}))
    await writer.drain()
    return True


async def serve(handler, host: str | None, port: int | None) -> asyncio.Server:
    """Listen on (host, port); each accepted WebSocket runs ``await handler(connection)``, and the socket closes
    when it returns. ``GET /healthz`` is answered ``200 OK``."""

    async def on_client(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            if not await _handshake(reader, writer):
                await writer.drain()
                return
            connection = ServerConnection(reader, writer)
            try:
                await handler(connection)
            finally:
                await connection.close()
        except ConnectionError:
            pass
        finally:
            writer.close()

    return await asyncio.start_server(on_client, host, port, limit=_HEAD_LIMIT)


# ---------------------------------------------------------------------------
# Client (blocking socket)
# ---------------------------------------------------------------------------


class ClientConnection:
    """A blocking WebSocket client connection: ``send``, ``recv`` (answering pings on the way) and ``close``."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._file = sock.makefile("rb")
        self._frames = _Frames(expect_masked=False)
        self._closed: ConnectionClosed | None = None
        self._close_sent = False

    def _read(self, n: int) -> bytes:
        data = self._file.read(n)
        if len(data) != n:
            raise ConnectionClosed()
        return data

    def _write_frame(self, opcode: int, payload: bytes) -> None:
        key = os.urandom(4)
        self._sock.sendall(frame_header(opcode, len(payload), key))
        self._sock.sendall(apply_mask(payload, key))

    def send(self, message: bytes | str) -> None:
        if self._closed is not None or self._close_sent:
            raise self._closed or ConnectionClosed()
        if isinstance(message, str):
            self._write_frame(OP_TEXT, message.encode())
        else:
            self._write_frame(OP_BINARY, bytes(message))

    def recv(self) -> bytes | str:
        """The next message: bytes for a binary one, str for text; raises ``ConnectionClosed`` once closed."""
        if self._closed is not None:
            raise self._closed
        try:
            while True:
                fin, opcode, masked, length = self._frames.lengths(self._read(2))
                if length == 126:
                    length = struct.unpack(">H", self._read(2))[0]
                elif length == 127:
                    length = struct.unpack(">Q", self._read(8))[0]
                self._frames.check(fin, opcode, masked, length)
                payload = self._read(length)
                if opcode == OP_PING:
                    if not self._close_sent:
                        self._write_frame(OP_PONG, payload)
                elif opcode == OP_CLOSE:
                    code, reason = _parse_close(payload)
                    if not self._close_sent:
                        self._close_sent = True
                        self._write_frame(OP_CLOSE, _close_payload(code, ""))
                    raise ConnectionClosed(code, reason)
                elif opcode != OP_PONG and (message := self._frames.add(fin, opcode, payload)) is not None:
                    return message
        except ConnectionClosed as e:
            self._closed = e
            self._shutdown()
            raise
        except (OSError, ProtocolError) as e:
            self._closed = ConnectionClosed(CLOSE_ABNORMAL, str(e))
            self._shutdown()
            raise self._closed from e

    def close(self, code: int = CLOSE_NORMAL, reason: str = "") -> None:
        """Send a close frame, read until the server's (for a while at most), and close the socket."""
        if self._closed is None:
            try:
                if not self._close_sent:
                    self._close_sent = True
                    self._write_frame(OP_CLOSE, _close_payload(code, reason))
                self._sock.settimeout(_CLOSE_TIMEOUT_S)
                while True:
                    self.recv()
            except ConnectionClosed:
                pass
        self._shutdown()

    def _shutdown(self) -> None:
        self._file.close()
        self._sock.close()


def connect(uri: str, additional_headers: dict | None = None) -> ClientConnection:
    """Open a WebSocket to ``ws://host[:port][/path]``; raises ``ConnectionRefusedError`` while nothing listens."""
    parts = urllib.parse.urlsplit(uri)
    if parts.scheme != "ws":
        raise ValueError(f"{uri}: only ws:// URIs are served (no TLS)")
    host, port = parts.hostname, parts.port or 80
    sock = socket.create_connection((host, port))
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        key = base64.b64encode(os.urandom(16)).decode()
        fields = {"Host": parts.netloc, "Upgrade": "websocket", "Connection": "Upgrade", "Sec-WebSocket-Key": key,
                  "Sec-WebSocket-Version": "13", **(additional_headers or {})}
        request = [f"GET {parts.path or '/'}{'?' + parts.query if parts.query else ''} HTTP/1.1"]
        sock.sendall(("\r\n".join(request + [f"{k}: {v}" for k, v in fields.items()]) + "\r\n\r\n").encode())
        head = b""
        while not head.endswith(b"\r\n\r\n"):
            byte = sock.recv(1)
            if not byte or len(head) > _HEAD_LIMIT:
                raise ConnectionError(f"{uri}: the server closed the connection during the handshake")
            head += byte
        first, headers = _parse_head(head)
        if first.split(" ")[1:2] != ["101"] or headers.get("sec-websocket-accept") != accept_key(key):
            raise ConnectionError(f"{uri}: handshake refused: {first}")
        return ClientConnection(sock)
    except BaseException:
        sock.close()
        raise
