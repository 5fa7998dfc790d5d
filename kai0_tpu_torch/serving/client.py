"""Synchronous websocket policy client.

The port's copy of ``packages/kai0-client/src/kai0_client/websocket_client_policy.py``
on the standard-library socket and codec (``serving/websocket.py``,
``serving/msgpack_numpy.py``), so that the card's machine can drive a server.
On connect the server sends one msgpack metadata frame; each ``infer`` sends a
msgpack observation and receives a msgpack action frame. A text frame from the
server carries a traceback and is raised as an error. The constructor blocks,
retrying until the server is reachable.
"""

from __future__ import annotations

import logging
import time

from kai0_tpu_torch.serving import msgpack_numpy
from kai0_tpu_torch.serving import websocket as _websocket

logger = logging.getLogger("kai0_tpu_torch")


class WebsocketClientPolicy:
    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int | None = None,
        api_key: str | None = None,
        *,
        retry_interval_s: float = 5.0,
    ) -> None:
        self._uri = host if host.startswith("ws") else f"ws://{host}"
        if port is not None:
            self._uri += f":{port}"
        self._packer = msgpack_numpy.Packer()
        self._api_key = api_key
        self._retry_interval_s = retry_interval_s
        self._ws, self._server_metadata = self._wait_for_server()

    def get_server_metadata(self) -> dict:
        return self._server_metadata

    def _wait_for_server(self):
        logger.info(f"Waiting for server at {self._uri}...")
        while True:
            try:
                headers = {"Authorization": f"Api-Key {self._api_key}"} if self._api_key else None
                conn = _websocket.connect(self._uri, additional_headers=headers)
                metadata = msgpack_numpy.unpackb(conn.recv())
                return conn, metadata
            except ConnectionRefusedError:
                logger.info("Still waiting for server...")
                time.sleep(self._retry_interval_s)

    def infer(self, obs: dict) -> dict:
        self._ws.send(self._packer.pack(obs))
        response = self._ws.recv()
        if isinstance(response, str):
            raise RuntimeError(f"Error in inference server:\n{response}")
        return msgpack_numpy.unpackb(response)

    def reset(self) -> None:
        pass

    def close(self) -> None:
        self._ws.close()
