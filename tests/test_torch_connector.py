"""The port's wire transports (``runtime/connector.py``) against the JAX
package's: the JSONL line parser, ``JSONLConnector`` (EOF, a last line
without a newline, malformed lines counted, a reader on a real fd woken
by ``stop()``) and ``SocketConnector`` over localhost, a JAX-package
client against a port server and the reverse, frames equal bit for bit."""

import io
import json
import os
import threading
import time

import numpy as np
import pytest

from opencv_facerecognizer_tpu.runtime import connector as jax_connector
from opencv_facerecognizer_tpu_torch.runtime import connector as port_connector
from opencv_facerecognizer_tpu_torch.runtime.recognizer import FRAME_TOPIC, RESULT_TOPIC
from opencv_facerecognizer_tpu_torch.utils import metrics as mn

LINES = ["", "   ", '{"topic": "t", "data": {"a": 1}}', '{"topic": "t"}', "not json",
         '{"data": {}}', "[1, 2]", '{"topic": "t", "data": null}', "\n",
         '{"topic": "ocvfacerec/frames", "data": {"meta": [1, "x"]}}']


@pytest.mark.parametrize("line", LINES)
def test_parse_jsonl_line_like_jax(line):
    assert port_connector._parse_jsonl_line(line) == jax_connector._parse_jsonl_line(line)


def _frames():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (5, 7), dtype=np.uint8),
            rng.standard_normal((3, 4)).astype(np.float32),
            rng.integers(-9, 9, (2, 3, 2), dtype=np.int16)]


def test_encode_frame_is_the_reference_wire_format():
    for f in _frames():
        assert port_connector.encode_frame(f) == jax_connector.encode_frame(f)
        np.testing.assert_array_equal(port_connector.decode_frame(jax_connector.encode_frame(f)), f)


def _collect(conn, topic="*"):
    got, lock = [], threading.Lock()

    def handler(t, m):
        with lock:
            got.append((t, m))

    conn.subscribe(topic, handler)
    return got


def test_jsonl_eof_and_a_last_line_without_newline():
    text = "\n".join([json.dumps({"topic": "a", "data": {"i": i}}) for i in range(3)]
                     + ["garbage", json.dumps({"topic": "b", "data": {"last": True}})])
    metrics = mn.Metrics()
    out = io.StringIO()
    conn = port_connector.JSONLConnector(io.StringIO(text), out, metrics=metrics)
    got = _collect(conn)
    conn.start()
    assert conn.eof.wait(timeout=10)
    conn.stop()
    assert got == [("a", {"i": 0}), ("a", {"i": 1}), ("a", {"i": 2}), ("b", {"last": True})]
    assert metrics.counter(mn.CONNECTOR_MALFORMED_LINES) == 1 and conn.malformed_lines == 1
    conn.publish("r", {"x": [1, 2]})
    assert out.getvalue() == json.dumps({"topic": "r", "data": {"x": [1, 2]}}) + "\n"


def test_jsonl_on_a_pipe_matches_jax_and_stop_wakes_the_reader():
    """A real fd: the same bytes through both packages' readers give the
    same messages; a reader waiting for input ends on stop()."""
    payload = ("\n".join(json.dumps({"topic": "f", "data": port_connector.encode_frame(f)})
                         for f in _frames()) + "\n" + json.dumps({"topic": "end", "data": {}}))
    results = []
    for module in (jax_connector, port_connector):
        r, w = os.pipe()
        with os.fdopen(r, "r") as rf:
            conn = module.JSONLConnector(rf, None)
            got = _collect(conn)
            conn.start()
            os.write(w, payload.encode())
            os.close(w)
            assert conn.eof.wait(timeout=10)
            conn.stop()
        results.append(got)
    assert results[0] == results[1] and len(results[1]) == 4
    r, w = os.pipe()
    with os.fdopen(r, "r") as rf:
        conn = port_connector.JSONLConnector(rf, None)
        conn.start()
        time.sleep(0.05)
        t0 = time.monotonic()
        conn.stop()
        assert conn.eof.wait(timeout=5) and time.monotonic() - t0 < 3
    os.close(w)


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("server_module, client_module", [
    (port_connector, jax_connector), (jax_connector, port_connector)],
    ids=["jax-client-port-server", "port-client-jax-server"])
def test_socket_round_trip_bit_for_bit(server_module, client_module):
    server = server_module.SocketConnector(port=0, listen=True)
    server.start()
    client = client_module.SocketConnector(port=server.port, listen=False,
                                           reconnect_attempts=0)
    try:
        on_server = _collect(server, FRAME_TOPIC)
        on_client = _collect(client, RESULT_TOPIC)
        client.start()
        assert _wait_for(lambda: len(server._client_socks) == 1)
        frames = _frames()
        for i, f in enumerate(frames):
            client.publish(FRAME_TOPIC, {**client_module.encode_frame(f), "meta": i})
        assert _wait_for(lambda: len(on_server) == len(frames))
        for (topic, msg), f in zip(on_server, frames):
            got = port_connector.decode_frame(msg)
            assert got.dtype == f.dtype and got.tobytes() == f.tobytes() and got.shape == f.shape
        server.publish(RESULT_TOPIC, {"meta": 7, "faces": []})
        assert _wait_for(lambda: len(on_client) == 1)
        assert on_client[0][1] == {"meta": 7, "faces": []}
    finally:
        client.stop()
        server.stop()
    assert server.eof.wait(timeout=5) and client.eof.wait(timeout=5)


def test_socket_counts_a_peer_disconnect():
    metrics = mn.Metrics()
    server = port_connector.SocketConnector(port=0, listen=True, metrics=metrics)
    server.start()
    client = jax_connector.SocketConnector(port=server.port, listen=False,
                                           reconnect_attempts=0)
    client.start()
    try:
        assert _wait_for(lambda: len(server._client_socks) == 1)
        client.stop()
        assert _wait_for(lambda: metrics.counter(mn.CONNECTOR_PEER_DISCONNECTS) == 1)
        assert _wait_for(lambda: not server._client_socks)
    finally:
        server.stop()
