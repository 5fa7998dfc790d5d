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
loop. The socket and the codec are the standard-library ones of
``serving/websocket.py`` and ``serving/msgpack_numpy.py``, so the server runs
where neither ``websockets`` nor ``msgpack`` is installed.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
import traceback

from kai0_tpu_torch.serving import msgpack_numpy
from kai0_tpu_torch.serving import websocket as _websocket

logger = logging.getLogger("kai0_tpu_torch")

_CLOSE_ON_ERROR = (_websocket.CLOSE_INTERNAL_ERROR, "Internal server error. Traceback included in previous frame.")


@dataclasses.dataclass
class _Session:
    """One client connection: greet, then answer observations until it closes."""

    socket: _websocket.ServerConnection
    policy: object
    metadata: dict
    _pack: msgpack_numpy.Packer = dataclasses.field(default_factory=msgpack_numpy.Packer)
    _last_roundtrip_s: float | None = None

    async def greet(self) -> None:
        await self.socket.send(self._pack.pack(self.metadata))

    async def answer_one(self) -> None:
        t_recv = time.monotonic()
        request = msgpack_numpy.unpackb(await self.socket.recv())

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
    peer = session.socket.remote_address
    logger.info(f"Connection from {peer} opened")
    try:
        await session.greet()
        while True:
            await session.answer_one()
    except _websocket.ConnectionClosed:
        logger.info(f"Connection from {peer} closed")
    except Exception:
        # Contract: ship the traceback to the client, then close abnormally.
        await session.socket.send(traceback.format_exc())
        await session.socket.close(*_CLOSE_ON_ERROR)
        raise


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
        async def handler(socket):
            await _run_session(_Session(socket, self._policy, self._metadata))

        server = await _websocket.serve(handler, self._host, self._port)
        async with server:
            await server.serve_forever()
