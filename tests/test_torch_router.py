"""The port's topic router against the JAX package's: one script through
both routers over ``FakeConnector`` replicas, under one
``runtime.fakes.FakeClock`` and each package's transport fault injector.
The script covers rendezvous order, budget spills and rejections, health
failover, a raising probe and recovery, cordons, link supervision (a
half-open link past its deadline, then healed), interactive hedges with
their wins and wasted copies, fan-in dedup of duplicated results,
``replace_connector``, and control traffic to the writer only. Both
routers must forward the same messages to the same replicas in the same
order, publish the same results upstream, and end with equal metrics and
``registry()``.
"""

import types

import pytest

from opencv_facerecognizer_tpu.runtime import admission as jax_admission
from opencv_facerecognizer_tpu.runtime import faults as jax_faults
from opencv_facerecognizer_tpu.runtime import recognizer as jax_rec
from opencv_facerecognizer_tpu.runtime import replication as jax_repl
from opencv_facerecognizer_tpu.runtime.connector import FakeConnector as JaxConnector
from opencv_facerecognizer_tpu.utils.metrics import Metrics as JaxMetrics
from opencv_facerecognizer_tpu_torch.runtime import fakes as port_fakes
from opencv_facerecognizer_tpu_torch.runtime import faults as port_faults
from opencv_facerecognizer_tpu_torch.runtime import recognizer as port_rec
from opencv_facerecognizer_tpu_torch.runtime import replication as port_repl
from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector as PortConnector
from opencv_facerecognizer_tpu_torch.runtime.slo import STATE_CRITICAL, STATE_OK
from opencv_facerecognizer_tpu_torch.utils import metrics as mn

PKG = {
    "jax": types.SimpleNamespace(repl=jax_repl, faults=jax_faults, rec=jax_rec,
                                 Conn=JaxConnector, Metrics=JaxMetrics),
    "port": types.SimpleNamespace(repl=port_repl, faults=port_faults, rec=port_rec,
                                  Conn=PortConnector, Metrics=mn.Metrics),
}

NAMES = ("r0", "r1", "r2")
TOPICS = [f"camera/{i}" for i in range(12)]

#: every counter and gauge the router keeps
COUNTERS = (mn.ROUTER_ROUTED, mn.ROUTER_BUDGET_SPILLS, mn.ROUTER_FAILOVERS,
            mn.ROUTER_RECOVERIES, mn.ROUTER_CUTOVER_DRAINS, mn.ROUTER_HEALTH_PROBE_FAILURES,
            mn.ROUTER_PROBE_ERRORS, mn.ROUTER_HEDGES, mn.ROUTER_HEDGE_WINS,
            mn.ROUTER_HEDGE_WASTED, mn.ROUTER_RESULTS_DEDUPED, mn.LINK_HEARTBEATS_SENT,
            mn.LINK_HEARTBEATS_RECEIVED, mn.LINK_FAILURES, mn.LINK_RECOVERIES,
            mn.ROUTER_REJECTED_PREFIX + "budget", mn.ROUTER_REJECTED_PREFIX + "no_replica",
            mn.ROUTER_REJECTED_PREFIX + "no_writer", mn.TRANSPORT_FAULTS_PREFIX + "duplicate",
            mn.TRANSPORT_FAULTS_PREFIX + "half_open")
GAUGES = (mn.ROUTER_REPLICAS, mn.ROUTER_HEALTHY_REPLICAS, mn.LINKS_DOWN,
          *(mn.LINK_STATE_PREFIX + n for n in NAMES))


class _Fleet:
    """Three fake replicas behind one package's router. A replica pongs
    every ping while ``alive``, and answers a frame only when the script
    says so (``answer``)."""

    def __init__(self, name, clock, hedge=True, budget_fps=2.0):
        p = self.p = PKG[name]
        self.clock = clock
        self.metrics = p.Metrics()
        self.faults = p.faults.FaultInjector(seed=0)
        self.health = {n: STATE_OK for n in NAMES}
        self.alive = {n: True for n in NAMES}
        self.frames = {n: [] for n in NAMES}
        self.handles = []
        for i, n in enumerate(NAMES):
            conn = p.Conn()
            self._wire(n, conn)
            self.handles.append(p.repl.ReplicaHandle(
                n, conn, health_fn=lambda n=n: self._probe(n), budget_fps=budget_fps,
                writer=i == 0))
        for h in self.handles:
            if h.budget is not None:  # both buckets on the fake clock
                h.budget._clock = clock
                h.budget._last = clock()
        self.router = p.repl.TopicRouter(self.handles, metrics=self.metrics,
                                         fault_injector=self.faults, link_deadline_s=1.0,
                                         hedge_deadline_s=0.5 if hedge else None,
                                         dedup_window=64)
        self.upstream = []
        for topic in (p.rec.RESULT_TOPIC, p.rec.STATUS_TOPIC):
            self.router.subscribe(topic, lambda t, m: self.upstream.append((t, m)))

    def _probe(self, n):
        state = self.health[n]
        if state == "raise":
            raise OSError(f"{n} unreachable")
        return state

    def _wire(self, n, conn):
        rec = self.p.rec
        conn.subscribe(rec.FRAME_TOPIC, lambda t, m, n=n: self.frames[n].append(m))
        conn.subscribe(rec.LINK_PING_TOPIC, lambda t, m, n=n, c=conn: (
            c.publish(rec.LINK_PONG_TOPIC, {**m, "replica": n}) if self.alive[n] else None))

    def handle(self, n):
        return next(h for h in self.router.replicas() if h.name == n)

    def answer(self, n, frame, **extra):
        self.handle(n).connector.publish(self.p.rec.RESULT_TOPIC,
                                         {"meta": frame["meta"], "faces": [], **extra})

    def send(self, topic, i, priority="bulk"):
        self.router.publish(topic, {"frame": [i], "priority": priority,
                                    "meta": {"cam": topic, "i": i}})

    def outcome(self):
        routes = {n: [(t, m) for t, m in h.connector.sent] for n, h in
                  ((h.name, h) for h in self.router.replicas())}
        counters = {c: self.metrics.counter(c) for c in COUNTERS}
        gauges = {g: self.metrics.gauge(g) for g in GAUGES}
        return dict(routes=routes, frames=self.frames, upstream=self.upstream,
                    registry=self.router.registry(), counters=counters, gauges=gauges,
                    injected=dict(self.faults.injected))


def _script(fleet: _Fleet, clock):
    """The routing script; every step is deterministic under ``clock``."""
    router = fleet.router
    trace = []

    def note(tag):
        trace.append((tag, [h.name for h in router.replicas() if h.healthy and h.link_up
                            and not h.cordoned],
                      {t: (router.route(t) or types.SimpleNamespace(name=None)).name
                       for t in TOPICS[:4]}))

    router.check_health()
    router.check_links()
    # rendezvous: one frame per topic; the budgets (2 a second, burst 2)
    # spill the third frame of a replica to the next one, then reject
    for i, topic in enumerate(TOPICS):
        fleet.send(topic, i)
    for i in range(8):
        fleet.send(TOPICS[0], 100 + i)
    note("budgets")
    clock.advance(5.0)
    # health: r1 critical, r2's probe raises; then both recover
    fleet.health["r1"] = STATE_CRITICAL
    fleet.health["r2"] = "raise"
    router.check_health()
    note("r1 critical, r2 probe raises")
    for i, topic in enumerate(TOPICS):
        fleet.send(topic, 200 + i)
    router.check_health()  # the streak grows, logged once
    clock.advance(5.0)
    fleet.health.update(r1=STATE_OK, r2=STATE_OK)
    router.check_health()
    note("recovered")
    # a planned drain through the resync hook
    hook = router.cordon_hook("r0")
    hook("begin")
    for i, topic in enumerate(TOPICS):
        fleet.send(topic, 300 + i)
    note("r0 cordoned")
    hook("end")
    clock.advance(5.0)
    # links: r2's pongs die on a half-open link; past the deadline the
    # link is down, and it comes back once pongs flow again
    router.check_links(clock())
    fleet.faults.set_half_open("r2", "recv")
    clock.advance(0.6)
    router.check_links(clock())
    clock.advance(0.6)
    router.check_links(clock())
    note("r2 link down")
    for i, topic in enumerate(TOPICS):
        fleet.send(topic, 400 + i)
    fleet.faults.heal_half_open("r2")
    clock.advance(0.3)
    router.check_links(clock())
    note("r2 link up")
    clock.advance(5.0)
    # hedges: interactive frames nobody answers within the deadline go
    # once more to the next replica; the first answer wins
    for i, topic in enumerate(TOPICS[:6]):
        fleet.send(topic, 500 + i, priority="interactive")
    sent = {n: list(fleet.frames[n]) for n in NAMES}
    clock.advance(0.6)
    hedged = router.check_hedges(clock())
    assert router.check_hedges(clock()) == 0  # one hedge per frame
    late = {n: fleet.frames[n][len(sent[n]):] for n in NAMES}
    for i, (n, frames) in enumerate(sorted(late.items())):
        for frame in frames:
            fleet.answer(n, frame)  # the hedge's copy answers first
    for n in NAMES:
        for frame in sent[n]:
            if frame.get("priority") == "interactive":
                fleet.answer(n, frame)  # the original, deduped
    # a duplicated delivery on the result link is deduped at fan-in
    fleet.faults.script("transport", "duplicate")
    frame = next(f for f in fleet.frames["r0"] if f.get("priority") == "bulk")
    fleet.answer("r0", frame)
    # replace_connector: a restarted r1 at a new connector keeps its topics
    fresh = fleet.p.Conn()
    fleet._wire("r1", fresh)
    router.replace_connector("r1", fresh)
    for i, topic in enumerate(TOPICS):
        fleet.send(topic, 600 + i)
    for frame in [m for t, m in fresh.sent if t == fleet.p.rec.FRAME_TOPIC]:
        fleet.answer("r1", frame)
    with pytest.raises(KeyError):
        router.replace_connector("nope", fleet.p.Conn())
    # control traffic goes to the healthy writer only
    router.publish(fleet.p.rec.CONTROL_TOPIC, {"cmd": "enroll", "subject": "x"})
    fleet.health["r0"] = STATE_CRITICAL
    router.check_health()
    router.publish(fleet.p.rec.CONTROL_TOPIC, {"cmd": "enroll", "subject": "y"})
    # statuses fan in stamped with the replica
    fleet.handle("r2").connector.publish(fleet.p.rec.STATUS_TOPIC, {"status": "degraded"})
    note("end")
    return trace, hedged, router.down_link_fraction()


@pytest.fixture
def clock(monkeypatch):
    fake = port_fakes.FakeClock()
    for mod in (jax_repl, port_repl, jax_admission):
        monkeypatch.setattr(mod, "time", fake)
    return fake


def test_routers_of_both_packages_route_one_script_alike(clock):
    out = {}
    for name in ("jax", "port"):
        clock.reset()
        fleet = _Fleet(name, clock)
        trace, hedged, down = _script(fleet, clock)
        out[name] = dict(fleet.outcome(), trace=trace, hedged=hedged, down=down)
    jax_out, port_out = out["jax"], out["port"]
    for key in jax_out:
        assert port_out[key] == jax_out[key], key
    c = port_out["counters"]
    # the script reached every path
    for name in (mn.ROUTER_BUDGET_SPILLS, mn.ROUTER_FAILOVERS, mn.ROUTER_RECOVERIES,
                 mn.ROUTER_CUTOVER_DRAINS, mn.ROUTER_PROBE_ERRORS, mn.ROUTER_HEDGES,
                 mn.ROUTER_HEDGE_WINS, mn.ROUTER_RESULTS_DEDUPED, mn.LINK_FAILURES,
                 mn.LINK_RECOVERIES, mn.ROUTER_REJECTED_PREFIX + "budget",
                 mn.ROUTER_REJECTED_PREFIX + "no_writer",
                 mn.TRANSPORT_FAULTS_PREFIX + "duplicate",
                 mn.TRANSPORT_FAULTS_PREFIX + "half_open"):
        assert c[name] >= 1, name
    assert port_out["hedged"] == 6
    # every routed frame reached upstream at most once
    fids = [m["meta"]["_fid"] for t, m in port_out["upstream"]
            if t == port_rec.RESULT_TOPIC and "_fid" in m["meta"]]
    assert len(fids) == len(set(fids))
    assert [m["replica"] for t, m in port_out["upstream"]
            if t == port_rec.STATUS_TOPIC] == ["r2"]


def test_rendezvous_weights_are_the_reference_digest():
    """One topic goes to one replica from either package (a mixed fleet)."""
    for topic in TOPICS + ["", "camera/ü", "x" * 300]:
        for name in NAMES + ("127.0.0.1:5600",):
            assert (port_repl.TopicRouter._weight(topic, name)
                    == jax_repl.TopicRouter._weight(topic, name))


@pytest.mark.parametrize("n_replicas", [2, 3, 5])
def test_losing_a_replica_moves_only_its_topics(n_replicas):
    """Rendezvous: taking one replica out moves the topics it had, no
    others, in both packages alike."""
    routes = {}
    for name in ("jax", "port"):
        p = PKG[name]
        handles = [p.repl.ReplicaHandle(f"replica-{i}", p.Conn()) for i in range(n_replicas)]
        router = p.repl.TopicRouter(handles, metrics=p.Metrics())
        topics = [f"camera/{i}" for i in range(64)]
        before = {t: router.route(t).name for t in topics}
        handles[1].healthy = False
        after = {t: router.route(t).name for t in topics}
        routes[name] = (before, after)
        for t in topics:
            assert after[t] == before[t] or before[t] == "replica-1"
            assert after[t] != "replica-1"
    assert routes["port"] == routes["jax"]


def test_probes_read_a_service_and_an_http_health_alike():
    """``service_health_probe`` and ``http_health_probe`` give the codes
    the reference's give (ok, the SLO's state, critical when stopped, 503,
    an unparseable 200, a raising URL)."""
    import http.server
    import threading

    codes = {"/ok": (200, b'{"state_code": 1}'), "/crit": (503, b"{}"),
             "/junk": (200, b"not json"), "/err": (500, b"")}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - the stdlib's name
            status, body = codes[self.path]
            self.send_response(status)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        out = {}
        for name in ("jax", "port"):
            repl = PKG[name].repl
            got = []
            for path in ("/ok", "/crit", "/junk"):
                got.append(repl.http_health_probe(
                    f"http://127.0.0.1:{server.server_port}{path}")())
            with pytest.raises(Exception):
                repl.http_health_probe(f"http://127.0.0.1:{server.server_port}/err")()
            service = types.SimpleNamespace(loop_crashed=False, _running=True, slo=None)
            probe = repl.service_health_probe(service)
            got.append(probe())
            service.slo = types.SimpleNamespace(state_code=1)
            got.append(probe())
            service._running = False
            got.append(probe())
            out[name] = got
        assert out["port"] == out["jax"] == [1, STATE_CRITICAL, 0, 0, 1, STATE_CRITICAL]
    finally:
        server.shutdown()
        server.server_close()


def test_a_router_holds_no_card_and_serves_replicas_on_the_exposition(clock):
    """The router's modules start no CUDA context; ``/replicas`` serves
    ``registry()``."""
    import json
    import subprocess
    import sys
    import urllib.request

    code = ("import torch\n"
            "from opencv_facerecognizer_tpu_torch.runtime import replication, expo\n"
            "from opencv_facerecognizer_tpu_torch.apps import recognize\n"
            "from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector\n"
            "r = replication.TopicRouter([replication.ReplicaHandle('a', FakeConnector())])\n"
            "r.publish('camera/0', {'frame': [0]})\n"
            "print('CUDA', torch.cuda.is_initialized())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "CUDA False" in proc.stdout

    from opencv_facerecognizer_tpu_torch.runtime.expo import ExpoServer

    fleet = _Fleet("port", clock, budget_fps=None)
    fleet.send("camera/a", 0)
    expo = ExpoServer(metrics=fleet.metrics, router=fleet.router, port=0)
    expo.start()
    try:
        with urllib.request.urlopen(f"http://{expo.host}:{expo.port}/replicas",
                                    timeout=10) as r:
            body = json.loads(r.read())
    finally:
        expo.stop()
    assert body["replicas"] == json.loads(json.dumps(fleet.router.registry()))
    assert [t for r in body["replicas"] for t in r["topics"]] == ["camera/a"]


def test_the_router_cli_dials_a_restarted_replica_again():
    """A replica whose connector spent its reconnect budget (restarted
    later than the backoff reached) is dialled again by the router CLI's
    loop, and frames route to it anew (ROADMAP C.16)."""
    import time

    from opencv_facerecognizer_tpu_torch.apps.recognize import _redial
    from opencv_facerecognizer_tpu_torch.runtime.connector import SocketConnector

    def wait(pred):
        deadline = time.monotonic() + 10
        while not pred():
            assert time.monotonic() < deadline
            time.sleep(0.01)

    server = SocketConnector(port=0, listen=True)
    server.start()
    port = server.port
    conn = SocketConnector(port=port, listen=False, reconnect_attempts=0)
    conn.start()
    metrics = mn.Metrics()
    router = port_repl.TopicRouter([port_repl.ReplicaHandle(f"127.0.0.1:{port}", conn)],
                                   metrics=metrics)
    wait(lambda: len(server._client_socks) == 1)
    server.stop()
    wait(conn.eof.is_set)
    _redial(router, metrics)  # the endpoint is still down: nothing changes
    assert router.replicas()[0].connector is conn
    revived = SocketConnector(port=port, listen=True)
    revived.start()
    got = []
    revived.subscribe(port_rec.FRAME_TOPIC, lambda t, m: got.append(m))
    try:
        _redial(router, metrics)
        fresh = router.replicas()[0].connector
        assert fresh is not conn and not fresh.eof.is_set()
        wait(lambda: len(revived._client_socks) == 1)
        router.publish("camera/0", {"frame": [1], "meta": {"i": 0}})
        wait(lambda: got)
        assert got[0]["meta"]["i"] == 0 and got[0]["_route_topic"] == "camera/0"
    finally:
        router.replicas()[0].connector.stop()
        revived.stop()
