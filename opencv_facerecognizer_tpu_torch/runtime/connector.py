"""Middleware connectors: the pluggable transport boundary. Port of
``opencv_facerecognizer_tpu/runtime/connector.py``.

- ``FakeConnector``: in-process pub-sub, the test and smoke transport.
- ``JSONLConnector``: one JSON object per line, ``{"topic": ..., "data":
  {...}}``, over any pair of streams (stdin/stdout by default in the
  CLI); ``eof`` is set when the input ends.
- ``SocketConnector``: the same framing over TCP. Listening, it accepts
  any number of clients and broadcasts each publish to all of them;
  connecting, it redials with bounded exponential backoff after a blip.

- ``ROSConnector``: ``sensor_msgs/Image`` in (``decode_ros_image``, no
  cv_bridge), ``std_msgs/String`` JSON for control and out; ``rospy`` is
  imported at construction, or injected (tests pass a mock).

Frames travel as base64 raw bytes with shape and dtype
(``encode_frame``). Messages are dicts, topics strings; handlers run on
the connector's dispatch thread, so they must be cheap (the recognizer's
only enqueues). With a ``fault_injector``, a ``SocketConnector``'s sends
and receives cross its transport boundary (``runtime.faults``).
"""

from __future__ import annotations

import base64
import io
import json
import os
import random
import select
import socket
import threading
import time
from typing import IO, Any, Callable, Dict, List, Optional

import numpy as np

from opencv_facerecognizer_tpu_torch.utils import metrics as mn

Handler = Callable[[str, Dict[str, Any]], None]

#: a handler subscribed under this topic receives every message (its
#: first argument carries the real topic)
WILDCARD_TOPIC = "*"


def encode_frame(frame: np.ndarray) -> Dict[str, Any]:
    frame = np.ascontiguousarray(frame)
    return {
        "__frame__": base64.b64encode(frame.tobytes()).decode("ascii"),
        "shape": list(frame.shape),
        "dtype": str(frame.dtype),
    }


def decode_frame(obj: Dict[str, Any]) -> np.ndarray:
    raw = base64.b64decode(obj["__frame__"])
    return np.frombuffer(raw, dtype=np.dtype(obj["dtype"])).reshape(obj["shape"]).copy()


class MiddlewareConnector:
    """publish/subscribe over topics; start/stop lifecycle."""

    def publish(self, topic: str, message: Dict[str, Any]) -> None:
        raise NotImplementedError

    def subscribe(self, topic: str, handler: Handler) -> None:
        raise NotImplementedError

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


class FakeConnector(MiddlewareConnector):
    """In-process pub-sub; synchronous dispatch on the publisher's thread.

    ``sent`` records every published message for assertions; ``inject`` is
    an alias of ``publish`` that reads better in tests.
    """

    def __init__(self):
        self._handlers: Dict[str, List[Handler]] = {}
        self._lock = threading.Lock()
        self.sent: List[tuple] = []

    def publish(self, topic: str, message: Dict[str, Any]) -> None:
        with self._lock:
            self.sent.append((topic, message))
            handlers = list(self._handlers.get(topic, ()))
            if topic != WILDCARD_TOPIC:
                handlers += list(self._handlers.get(WILDCARD_TOPIC, ()))
        for handler in handlers:
            handler(topic, message)

    inject = publish

    def subscribe(self, topic: str, handler: Handler) -> None:
        with self._lock:
            self._handlers.setdefault(topic, []).append(handler)

    def messages(self, topic: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [m for t, m in self.sent if t == topic]


def _parse_jsonl_line(line: str):
    """One wire line -> (topic, data); None for a blank line;
    ("__malformed__", None) when it does not parse."""
    line = line.strip()
    if not line:
        return None
    try:
        obj = json.loads(line)
        return obj["topic"], obj.get("data", {})
    except (json.JSONDecodeError, KeyError, TypeError):
        return "__malformed__", None


class _TopicDispatchConnector(MiddlewareConnector):
    """Handler registry and JSONL line handling shared by the wire
    transports. ``metrics`` (optional) counts the transport's failures
    (``connector_*``) on the service's surface."""

    def __init__(self, metrics: Optional[mn.Metrics] = None):
        self._handlers: Dict[str, List[Handler]] = {}
        self._lock = threading.Lock()
        self.malformed_lines = 0
        self.metrics = metrics

    def subscribe(self, topic: str, handler: Handler) -> None:
        with self._lock:
            self._handlers.setdefault(topic, []).append(handler)

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.incr(name)

    def _dispatch(self, topic: str, data: Dict[str, Any]) -> None:
        with self._lock:
            handlers = list(self._handlers.get(topic, ()))
            if topic != WILDCARD_TOPIC:
                handlers += list(self._handlers.get(WILDCARD_TOPIC, ()))
        for handler in handlers:
            handler(topic, data)

    def _handle_line(self, line: str) -> None:
        parsed = _parse_jsonl_line(line)
        if parsed is None:
            return
        topic, data = parsed
        if data is None:
            self.malformed_lines += 1
            self._count(mn.CONNECTOR_MALFORMED_LINES)
            return
        self._dispatch(topic, data)


class JSONLConnector(_TopicDispatchConnector):
    """One JSON object per line; a reader thread dispatches incoming lines,
    ``publish`` writes lines to the output stream. Malformed lines are
    counted and skipped.

    ``eof`` is set when the reader finishes (the input ended, or
    ``stop()``). For a stream with a real file descriptor the reader
    selects on it and on a self-pipe, so ``stop()`` wakes a reader that
    waits for input; a last line without a newline still counts.
    """

    def __init__(self, in_stream: Optional[IO[str]] = None,
                 out_stream: Optional[IO[str]] = None,
                 metrics: Optional[mn.Metrics] = None):
        super().__init__(metrics=metrics)
        self._in = in_stream
        self._out = out_stream
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._wake_r: Optional[int] = None
        self._wake_w: Optional[int] = None
        self.eof = threading.Event()

    def publish(self, topic: str, message: Dict[str, Any]) -> None:
        if self._out is None:
            return
        line = json.dumps({"topic": topic, "data": message})
        with self._lock:  # whole lines, never interleaved
            try:
                self._out.write(line + "\n")
                self._out.flush()
            except (ValueError, OSError):
                # the stream closed at shutdown, or the consumer went away:
                # publishing must never kill the serving thread calling it
                pass

    def start(self) -> None:
        if self._in is None or self._thread is not None:
            return
        self._running = True
        self._wake_r, self._wake_w = os.pipe()
        self._thread = threading.Thread(target=self._read_loop, daemon=True,
                                        name="ocvf-jsonl-reader")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._wake_w is not None:
            try:
                os.write(self._wake_w, b"x")  # wake a reader blocked in select
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        for fd in (self._wake_r, self._wake_w):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._wake_r = self._wake_w = None

    def _read_loop(self) -> None:
        stream = self._in
        try:
            fd = stream.fileno()
        except (OSError, AttributeError, ValueError, io.UnsupportedOperation):
            fd = None
        try:
            if fd is None:
                for line in stream:  # an in-memory stream never blocks
                    if not self._running:
                        break
                    self._handle_line(line)
            else:
                self._read_loop_fd(fd)
        except ValueError:
            pass  # the stream was closed under us
        finally:
            self.eof.set()

    def _read_loop_fd(self, fd: int) -> None:
        """select() on the stream's fd and the wake pipe; lines split here
        (the raw fd bypasses the text buffer)."""
        buf = b""
        while self._running:
            ready, _, _ = select.select([fd, self._wake_r], [], [])
            if self._wake_r in ready:
                break
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                if buf.strip():  # a last line without its newline
                    self._handle_line(buf.decode("utf-8", errors="replace"))
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not self._running:
                    return
                self._handle_line(line.decode("utf-8", errors="replace"))


class SocketConnector(_TopicDispatchConnector):
    """JSONL framing over TCP, the wire format of ``JSONLConnector``.

    ``listen=True`` binds ``(host, port)`` (port 0: any free port, read
    back from ``port`` after ``start``), accepts any number of clients,
    broadcasts every publish to all of them and dispatches every client
    line. ``listen=False`` connects out; a peer-initiated disconnect is
    redialled up to ``reconnect_attempts`` times with exponential backoff
    (``connector_reconnects``), and ``eof`` is set only once that budget
    is spent or ``stop()`` ends the session. Each send is bounded by a
    deadline; a client that cannot take a payload in time is dropped.
    """

    #: redial backoff: base * 2^attempt, capped, times a uniform draw from
    #: [1 - jitter, 1 + jitter] so the peers of a restarted server do not
    #: redial in step
    RECONNECT_BACKOFF_BASE_S = 0.05
    RECONNECT_BACKOFF_MAX_S = 2.0
    RECONNECT_JITTER = 0.5

    def __init__(self, host: str = "127.0.0.1", port: int = 0, listen: bool = False,
                 metrics: Optional[mn.Metrics] = None, reconnect_attempts: int = 8,
                 fault_injector=None, peer_name: Optional[str] = None):
        super().__init__(metrics=metrics)
        self.host = host
        self.port = port
        self.listen = listen
        #: transport boundary: every publish crosses ``on_transport(peer,
        #: "send", ...)`` before the wire, every received message ``(peer,
        #: "recv", ...)`` before dispatch; ``peer_name`` defaults to host:port
        self._faults = fault_injector
        self._peer_name = peer_name
        self._backoff_rng = random.Random()
        self.reconnect_attempts = max(0, int(reconnect_attempts))
        # one send lock per socket: whole lines, and one stalled client
        # cannot wedge publishes to the others
        self._send_locks: Dict[socket.socket, threading.Lock] = {}
        self._send_deadline_s = 2.0
        self._threads: List[threading.Thread] = []
        self._server_sock: Optional[socket.socket] = None
        self._client_socks: List[socket.socket] = []
        self._running = False
        self.eof = threading.Event()

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        if self.listen:
            self._server_sock = socket.create_server((self.host, self.port))
            self.port = self._server_sock.getsockname()[1]
            self._spawn(self._accept_loop)
        else:
            # the first connect raises: a server that was never there is a
            # configuration error, unlike a blip mid-session
            sock = socket.create_connection((self.host, self.port), timeout=10.0)
            sock.settimeout(None)
            self._register(sock)
            self._spawn(self._client_loop, sock)

    def _spawn(self, target, *args) -> None:
        thread = threading.Thread(target=target, args=args, daemon=True,
                                  name="ocvf-socket")
        thread.start()
        self._threads.append(thread)

    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, _addr = self._server_sock.accept()
            except OSError:
                break  # closed by stop()
            if self._register(sock):
                self._spawn(self._read_loop, sock)
        self.eof.set()

    def _register(self, sock: socket.socket) -> bool:
        """Track a live socket; checked against ``_running`` under the lock
        that ``stop()`` clears the registry under, so no socket outlives
        ``stop()``. False (socket closed) after ``stop()``."""
        with self._lock:
            if not self._running:
                try:
                    sock.close()
                except OSError:
                    pass
                return False
            self._client_socks.append(sock)
            self._send_locks[sock] = threading.Lock()
            return True

    def _read_sock(self, sock: socket.socket) -> None:
        """Read one socket until it dies or ``stop()``: dispatch its lines,
        count a peer-initiated disconnect, deregister it."""
        fh = sock.makefile("r", encoding="utf-8", errors="replace")
        try:
            for line in fh:
                if not self._running:
                    break
                self._handle_line(line)
        except (OSError, ValueError):
            pass  # the peer is gone, or stop() closed the socket
        finally:
            if self._running:
                self._count(mn.CONNECTOR_PEER_DISCONNECTS)
            with self._lock:
                if sock in self._client_socks:
                    self._client_socks.remove(sock)
                self._send_locks.pop(sock, None)

    def _read_loop(self, sock: socket.socket) -> None:
        """Server side: one reader per client."""
        self._read_sock(sock)
        with self._lock:
            remaining = len(self._client_socks)
        if not self._running and remaining == 0:
            self.eof.set()

    def _client_loop(self, sock: socket.socket) -> None:
        """Client side: read until the connection dies, then redial."""
        while True:
            self._read_sock(sock)
            if not self._running or self.reconnect_attempts <= 0:
                break
            sock = self._reconnect_with_backoff()
            if sock is None:
                break
            self._count(mn.CONNECTOR_RECONNECTS)
        self.eof.set()

    def _reconnect_with_backoff(self) -> Optional[socket.socket]:
        """Up to ``reconnect_attempts`` redials with jittered exponential
        backoff, sleeping in slices so ``stop()`` is honoured promptly."""
        for attempt in range(self.reconnect_attempts):
            delay = min(self.RECONNECT_BACKOFF_MAX_S,
                        self.RECONNECT_BACKOFF_BASE_S * 2 ** attempt)
            delay *= self._backoff_rng.uniform(1.0 - self.RECONNECT_JITTER,
                                               1.0 + self.RECONNECT_JITTER)
            deadline = time.monotonic() + delay
            while self._running and time.monotonic() < deadline:
                time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
            if not self._running:
                return None
            try:
                sock = socket.create_connection((self.host, self.port), timeout=10.0)
                # a loopback dial of a dead ephemeral port can connect to
                # itself (simultaneous open): not a revived server
                if sock.getsockname() == sock.getpeername():
                    sock.close()
                    raise OSError("self-connect")
            except OSError:
                self._count(mn.CONNECTOR_RECONNECT_FAILURES)
                continue
            sock.settimeout(None)
            return sock if self._register(sock) else None
        return None

    def _send_bounded(self, sock: socket.socket, payload: bytes) -> bool:
        """Send within ``_send_deadline_s`` without changing the socket's
        blocking mode (its reader shares it): non-blocking sends, select
        for buffer space. False when the deadline passes."""
        deadline = time.monotonic() + self._send_deadline_s
        view = memoryview(payload)
        while view:
            try:
                view = view[sock.send(view, socket.MSG_DONTWAIT):]
                continue
            except (BlockingIOError, InterruptedError):
                pass
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            _, writable, _ = select.select((), (sock,), (), remaining)
            if not writable:
                return False
        return True

    def _transport_peer(self) -> str:
        return self._peer_name or f"{self.host}:{self.port}"

    def _transport_sink(self, kind: str) -> None:
        self._count(mn.TRANSPORT_FAULTS_PREFIX + kind)

    def _dispatch(self, topic: str, data: Dict[str, Any]) -> None:
        if self._faults is None:
            super()._dispatch(topic, data)
            return
        for msg in self._faults.on_transport(self._transport_peer(), "recv", data,
                                             sink=self._transport_sink):
            super()._dispatch(topic, msg)

    def publish(self, topic: str, message: Dict[str, Any]) -> None:
        messages = [message]
        if self._faults is not None:
            # a dropped or cut message never reaches the wire; a duplicate
            # is framed twice in one payload
            messages = self._faults.on_transport(self._transport_peer(), "send", message,
                                                 sink=self._transport_sink)
            if not messages:
                return
        payload = "".join(json.dumps({"topic": topic, "data": m}) + "\n"
                          for m in messages).encode()
        with self._lock:
            socks = [(s, self._send_locks[s]) for s in self._client_socks]
        dead = []
        for sock, lock in socks:
            with lock:
                try:
                    ok = self._send_bounded(sock, payload)
                except (OSError, ValueError):
                    ok = False  # ValueError: closed by another thread (fileno -1)
                if not ok:
                    # closed under the send lock, shutdown first (close alone
                    # does not wake a reader parked in recv)
                    for close in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                        try:
                            close()
                        except OSError:
                            pass
            if not ok:
                dead.append(sock)
        if dead:
            with self._lock:
                for sock in dead:
                    if sock in self._client_socks:
                        self._client_socks.remove(sock)
                    self._send_locks.pop(sock, None)
            for _ in dead:
                self._count(mn.CONNECTOR_STALLED_CLIENTS_DROPPED)

    def stop(self) -> None:
        self._running = False
        if self._server_sock is not None:
            # shutdown before close: it wakes a thread blocked in accept()
            for close in (lambda: self._server_sock.shutdown(socket.SHUT_RDWR),
                          self._server_sock.close):
                try:
                    close()
                except OSError:
                    pass
        with self._lock:
            socks = list(self._client_socks)
            self._client_socks.clear()
            self._send_locks.clear()
        for sock in socks:
            for close in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    close()
                except OSError:
                    pass
        for thread in self._threads:
            thread.join(timeout=2.0)
        self._threads.clear()


def decode_ros_image(msg) -> np.ndarray:
    """``sensor_msgs/Image`` -> float32 grayscale ``[H, W]`` without
    cv_bridge: mono8 and mono16 (``is_bigendian`` honoured) directly,
    rgb8, bgr8, rgba8 and bgra8 through the luma weights; ``step`` is the
    row stride."""
    h, w, step = int(msg.height), int(msg.width), int(msg.step)
    enc = str(msg.encoding).lower()
    raw = np.frombuffer(bytes(msg.data), dtype=np.uint8)
    channels = {"mono8": 1, "mono16": 2, "rgb8": 3, "bgr8": 3, "rgba8": 4, "bgra8": 4}
    if enc not in channels:
        raise ValueError(f"unsupported image encoding: {msg.encoding!r}")
    rows = raw.reshape(h, step)[:, : w * channels[enc]]
    if enc == "mono8":
        return rows.astype(np.float32)
    if enc == "mono16":
        dt = ">u2" if getattr(msg, "is_bigendian", 0) else "<u2"
        img16 = rows.reshape(h, w, 2).copy().view(dt)[..., 0]
        return img16.astype(np.float32) / 257.0  # 16 bits onto 0..255
    rgb = rows.reshape(h, w, channels[enc])[..., :3].astype(np.float32)
    if enc.startswith("bgr"):
        rgb = rgb[..., ::-1]
    return rgb @ np.asarray([0.299, 0.587, 0.114], np.float32)


class ROSConnector(_TopicDispatchConnector):
    """The ROS transport of the reference's recognizer node:

    - ``sensor_msgs/Image`` on ``image_topic``, decoded to a grayscale
      frame, dispatched to ``FRAME_TOPIC`` subscribers (the other
      connectors' message schema);
    - ``std_msgs/String`` JSON on ``control_topic`` (a wire line or a bare
      command) to ``CONTROL_TOPIC``;
    - ``publish`` writes results and statuses as ``std_msgs/String`` JSON
      on ``result_topic`` / ``status_topic``.

    ``rospy`` is imported at construction unless ``rospy_module`` is given
    (tests pass a mock)."""

    def __init__(self, image_topic: str = "/camera/image_raw",
                 result_topic: str = "/ocvfacerec/results",
                 control_topic: str = "/ocvfacerec/control",
                 status_topic: str = "/ocvfacerec/status", node_name: str = "ocvf_recognizer",
                 rospy_module=None):
        if rospy_module is None:
            try:
                import rospy as rospy_module  # type: ignore[no-redef]
            except ImportError as e:
                raise ImportError(
                    "rospy is not installed in this environment; use JSONLConnector, "
                    "SocketConnector, or FakeConnector, which implement the same "
                    "MiddlewareConnector interface") from e
        super().__init__()
        self._rospy = rospy_module
        self.image_topic = image_topic
        self.result_topic = result_topic
        self.control_topic = control_topic
        self.status_topic = status_topic
        self.node_name = node_name
        self._publishers: Dict[str, Any] = {}
        self._subscribers: List[Any] = []
        self._started = False
        self.frames_malformed = 0

    def _ros_topic_for(self, topic: str) -> str:
        from opencv_facerecognizer_tpu_torch.runtime import recognizer as rec

        return {rec.RESULT_TOPIC: self.result_topic,
                rec.STATUS_TOPIC: self.status_topic}.get(topic, topic)

    def start(self) -> None:
        if self._started:
            return
        rospy = self._rospy
        rospy.init_node(self.node_name, anonymous=True, disable_signals=True)
        self._string_cls = self._string_msg_cls()
        self._subscribers.append(
            rospy.Subscriber(self.image_topic, self._image_msg_cls(), self._on_image))
        self._subscribers.append(
            rospy.Subscriber(self.control_topic, self._string_cls, self._on_control))
        self._started = True

    @staticmethod
    def _string_msg_cls():
        try:
            from std_msgs.msg import String  # only beside rospy
        except ImportError:
            class String:  # std_msgs/String's one field
                def __init__(self, data: str = ""):
                    self.data = data

        return String

    @staticmethod
    def _image_msg_cls():
        try:
            from sensor_msgs.msg import Image  # only beside rospy
        except ImportError:
            class Image:  # only the Subscriber's type argument
                pass

        return Image

    def _on_image(self, msg) -> None:
        from opencv_facerecognizer_tpu_torch.runtime import recognizer as rec

        try:
            frame = decode_ros_image(msg)
        except Exception:  # noqa: BLE001 - a malformed frame must not kill the node
            self.frames_malformed += 1
            self._count(mn.CONNECTOR_MALFORMED_LINES)
            return
        stamp = getattr(getattr(msg, "header", None), "stamp", None)
        self._dispatch(rec.FRAME_TOPIC, {**encode_frame(frame), "meta": {
            "stamp": str(stamp) if stamp is not None else None}})

    def _on_control(self, msg) -> None:
        from opencv_facerecognizer_tpu_torch.runtime import recognizer as rec

        parsed = _parse_jsonl_line(getattr(msg, "data", ""))
        if parsed is None:
            return
        topic, data = parsed
        if data is None:
            try:  # a bare command: {"cmd": "enroll", ...}
                data = json.loads(msg.data)
                topic = rec.CONTROL_TOPIC
            except (json.JSONDecodeError, TypeError):
                return
        self._dispatch(topic if topic != "__malformed__" else rec.CONTROL_TOPIC, data)

    def publish(self, topic: str, message: Dict[str, Any]) -> None:
        if not self._started:
            return
        ros_topic = self._ros_topic_for(topic)
        with self._lock:
            pub = self._publishers.get(ros_topic)
            if pub is None:
                pub = self._rospy.Publisher(ros_topic, self._string_cls, queue_size=16)
                self._publishers[ros_topic] = pub
        pub.publish(self._string_cls(data=json.dumps(message)))

    def stop(self) -> None:
        for sub in self._subscribers:
            try:
                sub.unregister()
            except Exception:  # noqa: BLE001 - rospy teardown is best effort
                pass
        self._subscribers.clear()
        self._started = False
