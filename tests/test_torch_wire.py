"""The port's standard-library wire against ``msgpack`` and ``websockets``.

- ``serving/msgpack_numpy.py`` writes the bytes of ``msgpack.packb(obj,
  default=pack_array)`` (``kai0_client``'s codec) for request, RTC and reply
  payloads and for every length and integer format, and reads back what
  ``msgpack`` writes; object dtypes are refused.
- ``serving/websocket.py``: the port's server answers a ``websockets`` client
  and ``kai0_client``'s ``WebsocketClientPolicy`` (a 3 MB frame, ping, close,
  ``GET /healthz``, an error's traceback and close code), and the port's
  client talks to a ``websockets`` echo server that pings it.
"""

import asyncio
import http.client
import socket
import threading
import time

import msgpack
import numpy as np
import pytest

import kai0_tpu.serving  # noqa: F401  (puts the in-repo client package on sys.path)
from kai0_client import msgpack_numpy as client_codec
from kai0_client.websocket_client_policy import WebsocketClientPolicy as KaiClient
from kai0_tpu_torch.serving import client as port_client
from kai0_tpu_torch.serving import msgpack_numpy as codec
from kai0_tpu_torch.serving import websocket as port_websocket
from kai0_tpu_torch.serving.websocket_policy_server import WebsocketPolicyServer


def _agilex_request(rng) -> dict:
    return {"images": {cam: rng.integers(0, 256, (3, 48, 64), dtype=np.uint8) for cam in ("top_head", "hand_left", "hand_right")},
            "state": rng.uniform(-1, 1, 14).astype(np.float32), "prompt": "Flatten and fold the cloth."}


def _payloads():
    rng = np.random.default_rng(0)
    request = _agilex_request(rng)
    rtc = {**request, "prev_action_chunk": rng.standard_normal((50, 32)), "inference_delay": 2, "execute_horizon": 25,
           "enable_rtc": True, "mask_prefix_delay": False, "max_guidance_weight": 5.0}
    reply = {"state": rng.standard_normal(32).astype(np.float32), "actions": rng.standard_normal((50, 14)),
             "server_timing": {"infer_ms": 61.83, "model_ms": 55.1, "prev_total_ms": 70.0, "batch_size": 1}}
    edges = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129,
                 -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -0.0, 1.5, float("inf"), float("-inf"), 1e-300, np.float64(3.5)],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000, "long" * 20000],
        "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 70000, bytearray(b"ab"), memoryview(b"mv")],
        "lists": [list(range(15)), list(range(16)), tuple(range(70000))],
        "maps": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)}, {b"k": None, "t": True, "f": False}],
        "numpy": [np.float32(1.25), np.int64(-7), np.bool_(True), np.uint8(200), np.zeros((0, 3), np.float32),
                  np.arange(12, dtype=np.int16).reshape(3, 4), np.ones(5, dtype=">f8"), np.str_("np-str")],
    }
    return {"request": request, "rtc": rtc, "reply": reply, "metadata": {"backend": "torch"}, "edges": edges}


@pytest.mark.parametrize("name", ["request", "rtc", "reply", "metadata", "edges"])
def test_codec_writes_msgpacks_bytes_and_reads_them(name):
    obj = _payloads()[name]
    ours = codec.packb(obj)
    assert ours == msgpack.packb(obj, default=client_codec.pack_array)
    assert codec.Packer().pack(obj) == client_codec.Packer().pack(obj)
    back, ref = codec.unpackb(ours), client_codec.unpackb(ours)
    _assert_same(back, ref)


def _assert_same(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b, strict=True):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, float) and a != a:
        assert b != b
    else:
        assert a == b


def test_codec_reads_float32_and_refuses_what_msgpack_refuses():
    assert codec.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(ValueError, match="Unsupported dtype"):
        codec.packb({"bad": np.array([object()])})
    with pytest.raises(ValueError, match="Unsupported dtype"):
        codec.packb({"bad": np.complex64(1j)})
    with pytest.raises(OverflowError):
        codec.packb(2**64)
    with pytest.raises(TypeError):
        codec.packb({"set": {1, 2}})
    with pytest.raises(ValueError, match="map key"):
        codec.unpackb(msgpack.packb({1: 2}))
    with pytest.raises(ValueError, match="extension"):
        codec.unpackb(msgpack.packb(msgpack.ExtType(3, b"x")))
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(codec.packb(b"x" * 300)[:-1])
    with pytest.raises(ValueError, match="extra data"):
        codec.unpackb(codec.packb(1) + b"\x00")


# ---------------------------------------------------------------------------
# The socket
# ---------------------------------------------------------------------------


class _EchoPolicy:
    def infer(self, obs: dict) -> dict:
        if "boom" in obs:
            raise RuntimeError("the policy failed")
        return {"actions": np.asarray(obs["state"]) * 2.0, "size": sum(np.asarray(v).nbytes for v in obs.values())}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def server_port():
    port = _free_port()
    server = WebsocketPolicyServer(_EchoPolicy(), host="127.0.0.1", port=port, metadata={"who": "torch"})
    threading.Thread(target=server.serve_forever, daemon=True).start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return port
        except OSError:
            time.sleep(0.05)
    raise RuntimeError("the server did not start")


def test_server_answers_websockets_and_kai0_client(server_port):
    import websockets.sync.client

    big = np.random.default_rng(1).integers(0, 256, 3 * 2**20, dtype=np.uint8)  # a 3 MB frame
    with websockets.sync.client.connect(f"ws://127.0.0.1:{server_port}", compression=None, max_size=None) as ws:
        assert client_codec.unpackb(ws.recv()) == {"who": "torch"}
        assert ws.ping(b"hi").wait(5)
        ws.send(client_codec.packb({"state": np.arange(4, dtype=np.float32), "big": big}))
        reply = client_codec.unpackb(ws.recv())
        np.testing.assert_array_equal(reply["actions"], np.arange(4, dtype=np.float32) * 2)
        assert reply["size"] == 16 + big.nbytes and "infer_ms" in reply["server_timing"]
        ws.send(client_codec.packb({"state": np.ones(2), "boom": 1}))
        assert "the policy failed" in ws.recv()  # the traceback, as text
        with pytest.raises(websockets.exceptions.ConnectionClosedError) as closed:
            ws.recv()
        assert closed.value.rcvd.code == 1011

    client = KaiClient(host="127.0.0.1", port=server_port, retry_interval_s=0.1)
    assert client.get_server_metadata() == {"who": "torch"}
    for _ in range(2):
        result = client.infer({"state": np.arange(3, dtype=np.float32)})
    np.testing.assert_array_equal(result["actions"], np.arange(3, dtype=np.float32) * 2)
    assert "prev_total_ms" in result["server_timing"]
    client.close()

    conn = http.client.HTTPConnection("127.0.0.1", server_port, timeout=5)
    conn.request("GET", "/healthz")
    response = conn.getresponse()
    assert (response.status, response.read()) == (200, b"OK\n")
    conn = http.client.HTTPConnection("127.0.0.1", server_port, timeout=5)
    conn.request("GET", "/")
    assert conn.getresponse().status == 426


def test_port_client_against_the_port_server(server_port):
    client = port_client.WebsocketClientPolicy(host="127.0.0.1", port=server_port, retry_interval_s=0.1)
    assert client.get_server_metadata() == {"who": "torch"}
    state = np.linspace(0, 1, 14, dtype=np.float32)
    big = np.ones((3, 480, 640), np.uint8)
    result = client.infer({"state": state, "big": big})
    np.testing.assert_array_equal(result["actions"], state * 2)
    with pytest.raises(RuntimeError, match="the policy failed"):
        client.infer({"state": state, "boom": 1})
    client.close()


def test_port_client_against_a_websockets_echo_server():
    import websockets.asyncio.server

    port = _free_port()
    ready, stop = threading.Event(), threading.Event()
    received = []

    async def echo(ws):
        await ws.send(b"hello")
        async for message in ws:
            received.append(message)
            await ws.send(message)

    async def main():
        async with websockets.asyncio.server.serve(echo, "127.0.0.1", port, compression=None, max_size=None,
                                                   ping_interval=0.05, ping_timeout=2):
            ready.set()
            while not stop.is_set():
                await asyncio.sleep(0.02)

    thread = threading.Thread(target=lambda: asyncio.run(main()), daemon=True)
    thread.start()
    assert ready.wait(10)
    conn = port_websocket.connect(f"ws://127.0.0.1:{port}")
    try:
        assert conn.recv() == b"hello"
        for message in (b"x" * 100, b"y" * 300, "text é", bytes(range(256)) * (3 * 2**20 // 256)):
            conn.send(message)
            assert conn.recv() == message
            time.sleep(0.12)  # the server pings meanwhile; the client answers when it reads
    finally:
        conn.close()
        stop.set()
        thread.join(timeout=10)
    assert not thread.is_alive() and len(received) == 4
    with pytest.raises(ConnectionRefusedError):
        port_websocket.connect(f"ws://127.0.0.1:{port}")
