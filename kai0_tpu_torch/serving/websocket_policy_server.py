"""Websocket action-chunk policy server over the port's ``Policy``.

Counterpart of ``kai0_tpu/serving/websocket_policy_server.py``, with the same
wire protocol: on connect the server sends one msgpack metadata frame; each
received msgpack observation is answered with one msgpack action frame whose
``server_timing`` dict carries ``infer_ms`` (the server-observed wall time of
the policy call), the policy's own ``policy_timing`` with its ``infer_ms``
renamed ``model_ms`` and, from the second reply on, ``prev_total_ms`` (the
previous full recv→send round trip). On an unexpected error the traceback is
sent as a text frame and the socket closes with INTERNAL_ERROR. ``GET
/healthz`` answers 200. Inference runs on a worker thread, never on the event
loop.

``websockets`` and the wire codec (``kai0_client.msgpack_numpy``, from the
installed ``kai0-client`` package or the checkout's
``packages/kai0-client/src``) are imported when the server runs, not when this
module is imported.
"""

from __future__ import annotations

import asyncio
import dataclasses
import http
import logging
import pathlib
import sys
import time
import traceback

logger = logging.getLogger("kai0_tpu_torch")

_CLIENT_SRC = pathlib.Path(__file__).resolve().parents[2] / "packages" / "kai0-client" / "src"


def _wire_codec():
    """``kai0_client.msgpack_numpy``: the installed package, else the checkout's copy."""
    try:
        from kai0_client import msgpack_numpy
    except ImportError:
        if _CLIENT_SRC.exists() and str(_CLIENT_SRC) not in sys.path:
            sys.path.insert(0, str(_CLIENT_SRC))
        from kai0_client import msgpack_numpy
    return msgpack_numpy


@dataclasses.dataclass
class _Session:
    """One client connection: greet, then answer observations until it closes."""

    socket: object  # websockets.asyncio.server.ServerConnection
    policy: object
    metadata: dict
    codec: object  # kai0_client.msgpack_numpy
    _last_roundtrip_s: float | None = None

    def __post_init__(self):
        self._pack = self.codec.Packer()

    async def greet(self) -> None:
        await self.socket.send(self._pack.pack(self.metadata))

    async def answer_one(self) -> None:
        t_recv = time.monotonic()
        request = self.codec.unpackb(await self.socket.recv())

        loop = asyncio.get_running_loop()
        t_infer = time.monotonic()
        reply = await loop.run_in_executor(None, self.policy.infer, request)
        timing = dict(reply.pop("policy_timing", {}))
        if "infer_ms" in timing:
            timing["model_ms"] = timing.pop("infer_ms")
        timing["infer_ms"] = (time.monotonic() - t_infer) * 1000

        if self._last_roundtrip_s is not None:
            timing["prev_total_ms"] = self._last_roundtrip_s * 1000
        reply["server_timing"] = timing

        await self.socket.send(self._pack.pack(reply))
        self._last_roundtrip_s = time.monotonic() - t_recv


async def _run_session(session: _Session) -> None:
    import websockets.exceptions
    import websockets.frames

    peer = session.socket.remote_address
    logger.info(f"Connection from {peer} opened")
    try:
        await session.greet()
        while True:
            await session.answer_one()
    except websockets.exceptions.ConnectionClosed:
        logger.info(f"Connection from {peer} closed")
    except Exception:
        # Contract: ship the traceback to the client, then close abnormally.
        await session.socket.send(traceback.format_exc())
        await session.socket.close(
            websockets.frames.CloseCode.INTERNAL_ERROR, "Internal server error. Traceback included in previous frame."
        )
        raise


def _respond_to_probe(connection, request):
    if request.path == "/healthz":
        return connection.respond(http.HTTPStatus.OK, "OK\n")
    return None  # fall through to the websocket handshake


class WebsocketPolicyServer:
    """Serve ``policy.infer`` over the msgpack/websocket action-chunk protocol."""

    def __init__(self, policy, host: str = "0.0.0.0", port: int | None = None, metadata: dict | None = None) -> None:
        self._policy = policy
        self._host = host
        self._port = port
        self._metadata = metadata or {}

    def serve_forever(self) -> None:
        asyncio.run(self.run())

    async def run(self) -> None:
        import websockets.asyncio.server

        logging.getLogger("websockets.server").setLevel(logging.INFO)
        codec = _wire_codec()

        async def handler(socket):
            await _run_session(_Session(socket, self._policy, self._metadata, codec))

        listener = websockets.asyncio.server.serve(
            handler,
            self._host,
            self._port,
            compression=None,  # images are already raw uint8; zlib only adds latency
            max_size=None,
            process_request=_respond_to_probe,
        )
        async with listener as server:
            await server.serve_forever()
