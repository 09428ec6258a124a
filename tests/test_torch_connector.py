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


def test_socket_sends_and_receives_cross_the_transport_boundary():
    """A ``SocketConnector`` with an injector: a send dropped never reaches
    the wire, a duplicated one arrives twice, a cut receive is eaten, and
    each fault counts ``transport_fault_<kind>``, as in the reference."""
    from opencv_facerecognizer_tpu_torch.runtime import faults as port_faults

    metrics = mn.Metrics()
    injector = port_faults.FaultInjector()
    server = port_connector.SocketConnector(port=0, listen=True)
    server.start()
    client = port_connector.SocketConnector(port=server.port, listen=False, metrics=metrics,
                                            fault_injector=injector, peer_name="srv")
    client.start()
    on_server, on_client = _collect(server), _collect(client)
    try:
        assert _wait_for(lambda: len(server._client_socks) == 1)
        injector.script("transport", "drop", "duplicate")
        for i in range(3):
            client.publish(FRAME_TOPIC, {"meta": i})
        assert _wait_for(lambda: len(on_server) == 3)
        assert [m["meta"] for _t, m in on_server] == [1, 1, 2]
        injector.set_partition("srv", "recv")
        server.publish(RESULT_TOPIC, {"meta": "lost"})
        time.sleep(0.2)
        injector.heal_partition("srv")
        server.publish(RESULT_TOPIC, {"meta": "kept"})
        assert _wait_for(lambda: len(on_client) == 1)
        assert on_client[0][1] == {"meta": "kept"}
        assert {k: metrics.counter(mn.TRANSPORT_FAULTS_PREFIX + k)
                for k in ("drop", "duplicate", "partition")} == {
            "drop": 1, "duplicate": 1, "partition": 1}
        assert dict(injector.injected) == {"transport:drop": 1, "transport:duplicate": 1,
                                           "transport:partition": 1}
    finally:
        client.stop()
        server.stop()


# ---------- ROSConnector against a mocked rospy ----------


class _ImageMsg:
    def __init__(self, height, width, encoding, data, step=None, is_bigendian=0):
        self.height, self.width, self.encoding, self.data = height, width, encoding, data
        bpp = {"mono8": 1, "mono16": 2, "rgb8": 3, "bgr8": 3, "rgba8": 4, "bgra8": 4}[encoding]
        self.step = step if step is not None else width * bpp
        self.is_bigendian = is_bigendian
        self.header = type("H", (), {"stamp": "12.5"})()


def _ros_images():
    rng = np.random.default_rng(3)
    out = [_ImageMsg(2, 3, "mono8", np.concatenate(
        [np.arange(6, dtype=np.uint8).reshape(2, 3), np.zeros((2, 2), np.uint8)], 1).tobytes(),
        step=5)]
    for enc, c in (("rgb8", 3), ("bgr8", 3), ("rgba8", 4), ("bgra8", 4)):
        out.append(_ImageMsg(4, 5, enc, rng.integers(0, 256, (4, 5, c), np.uint8).tobytes()))
    px = rng.integers(0, 65536, (3, 4)).astype(np.uint16)
    out.append(_ImageMsg(3, 4, "mono16", px.astype("<u2").tobytes()))
    out.append(_ImageMsg(3, 4, "mono16", px.astype(">u2").tobytes(), is_bigendian=1))
    return out


@pytest.mark.parametrize("i", range(7))
def test_decode_ros_image_matches_reference(i):
    msg = _ros_images()[i]
    got = port_connector.decode_ros_image(msg)
    want = jax_connector.decode_ros_image(msg)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_decode_ros_image_refuses_what_the_reference_refuses():
    msg = _ImageMsg(1, 1, "mono8", b"\x00")
    msg.encoding = "yuv422"
    for mod in (port_connector, jax_connector):
        with pytest.raises(ValueError, match="encoding"):
            mod.decode_ros_image(msg)


class _FakeRospy:
    """``rospy``'s node, Subscriber and Publisher, recording."""

    def __init__(self):
        self.node = None
        self.publishers = []
        self.subscribers = []

    def init_node(self, name, **kwargs):
        self.node = (name, kwargs)

    def Subscriber(self, topic, msg_cls, callback):  # noqa: N802 - rospy's name
        sub = type("Sub", (), {"topic": topic, "callback": staticmethod(callback),
                               "unregistered": False})()
        sub.unregister = lambda s=sub: setattr(s, "unregistered", True)
        self.subscribers.append(sub)
        return sub

    def Publisher(self, topic, msg_cls, queue_size=0):  # noqa: N802 - rospy's name
        pub = type("Pub", (), {"topic": topic, "published": []})()
        pub.publish = pub.published.append
        self.publishers.append(pub)
        return pub


def _ros_run(mod, rec):
    """One script through a package's ``ROSConnector`` on a mock rospy:
    images (one malformed), control in both wire forms, a result and a
    status out, stop."""
    rospy = _FakeRospy()
    conn = mod.ROSConnector(rospy_module=rospy)
    conn.publish(rec.RESULT_TOPIC, {"before": "start"})  # dropped: not started
    conn.start()
    conn.start()
    got = []
    conn.subscribe(rec.FRAME_TOPIC, lambda t, m: got.append((t, m)))
    conn.subscribe(rec.CONTROL_TOPIC, lambda t, m: got.append((t, m)))
    image = next(s for s in rospy.subscribers if s.topic == conn.image_topic)
    control = next(s for s in rospy.subscribers if s.topic == conn.control_topic)
    for msg in _ros_images()[:3]:
        image.callback(msg)
    image.callback(_ImageMsg(4, 5, "mono8", b"\x00\x01"))  # too short
    control.callback(type("S", (), {"data": '{"cmd": "stats"}'})())
    control.callback(type("S", (), {"data": json.dumps(
        {"topic": rec.CONTROL_TOPIC, "data": {"cmd": "enroll", "subject": "bob"}})})())
    control.callback(type("S", (), {"data": "not json"})())
    control.callback(type("S", (), {"data": ""})())
    conn.publish(rec.RESULT_TOPIC, {"faces": [], "meta": None})
    conn.publish(rec.STATUS_TOPIC, {"status": "ok"})
    conn.publish(rec.STATUS_TOPIC, {"status": "again"})
    conn.stop()
    published = {p.topic: [json.loads(m.data) for m in p.published] for p in rospy.publishers}
    return dict(node=rospy.node, subs=[s.topic for s in rospy.subscribers],
                got=got, malformed=conn.frames_malformed, published=published,
                unregistered=[s.unregistered for s in rospy.subscribers])


def test_ros_connector_on_a_mocked_rospy_matches_reference():
    from opencv_facerecognizer_tpu.runtime import recognizer as jax_rec
    from opencv_facerecognizer_tpu_torch.runtime import recognizer as port_rec

    want = _ros_run(jax_connector, jax_rec)
    got = _ros_run(port_connector, port_rec)
    assert got == want
    assert got["malformed"] == 1 and all(got["unregistered"])
    assert [t for t, _m in got["got"]] == [FRAME_TOPIC] * 3 + [port_rec.CONTROL_TOPIC] * 2
    assert got["got"][0][1]["meta"]["stamp"] == "12.5"
    assert got["published"]["/ocvfacerec/results"] == [{"faces": [], "meta": None}]


def test_ros_connector_without_rospy_names_the_alternatives():
    with pytest.raises(ImportError, match="SocketConnector"):
        port_connector.ROSConnector()
