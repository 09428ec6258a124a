"""Read-only HTTP exposition of the serving runtime's state. Port of
``opencv_facerecognizer_tpu/runtime/expo.py``.

``ExpoServer`` answers from its own threads, so a wedged serving loop
still answers (the counters, the ledger and the spans are lock-light
reads):

==================  ========================================================
path                payload
==================  ========================================================
``/``               the endpoints, brownout level, health, tracer stats
``/metrics``        ``Metrics.summary()``
``/prom``           the same state in Prometheus text (``runtime.promtext``)
``/health``         the SLO monitor's last verdict: 200 for ok or warn,
                    **503 for critical**; ``{"state": null}`` unwired;
                    critical while a read replica's registry install is
                    pending (``ReadReplica.install_pending``)
``/ledger``         ``RecognizerService.ledger()``
``/brownout``       ``{"level": n}``
``/spans``          recent spans, ``?topic=<ring>&limit=<n>`` (alias
                    ``n``; default all topics, newest 256; a non-integer
                    or non-positive limit answers 400, more than
                    ``SPAN_LIMIT_MAX`` is clamped)
``/attribution``    the stage-attribution gauges, folded on read
``/replicas``       the topic router's ``registry()`` (``{"replicas": null}``
                    without one)
``/rollout``        the rollout coordinator's ``status()``, or
                    ``{"rollout": null}`` while none is attached
``/registry``       the model registry's manifest when one is attached
``/tracks``         the identity tracker's tracks and stats
==================  ========================================================

**Read-only**: every verb but GET answers 405. Requests and errors are
counted (``expo_requests``, ``expo_errors``). The refresh thread ticks the
SLO monitor (a backstop for a wedged loop) and folds the attribution.

**Stage attribution** (``fold_attribution``):

- ``device_busy_fraction``: the union of the recent ``ready_wait`` batch
  spans over a trailing window (``utils.tracing.device_busy_fraction``);
- ``stage_share_b<bucket>_<detect|crop|embed|match>``: the stages run in
  one CUDA graph per step, so a live split is unobservable; the shares
  come from a table of per-bucket stage times measured on the card by
  ablated prefixes of the graphed step (``chip_smoke.py`` phase 10 writes
  ``stage_quotes_h100.json`` beside this package, with the card's name and
  power limit), for the buckets the dispatch spans show serving. Without
  the table the shares are not set. The port never reads the TPU's
  ``BENCH_DETAIL.json`` (ROADMAP C.11).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

from opencv_facerecognizer_tpu_torch.runtime.promtext import render as render_prom
from opencv_facerecognizer_tpu_torch.runtime.slo import STATE_CRITICAL
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils import tracing

log = logging.getLogger(__name__)

#: the step's stages in order (the stage table's names)
DEVICE_STAGES = ("detect", "crop", "embed", "match")

#: the cap of ``/spans?limit=``
SPAN_LIMIT_MAX = 10000
SPAN_LIMIT_DEFAULT = 256

#: the stage table measured on the card (``chip_smoke.py`` phase 10)
DEFAULT_QUOTES_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "stage_quotes_h100.json")


class _BadQuery(ValueError):
    """A malformed query parameter: HTTP 400."""


def load_stage_quotes(quotes_path: str = DEFAULT_QUOTES_PATH) -> Dict[int, Dict[str, float]]:
    """Per-batch stage ms from the table's ``stage_attribution.per_batch``
    (``{"<batch>": {"<stage>": {"ms_per_batch": ms}}}``, the reference's
    layout); ``{}`` without the file or the section."""
    try:
        with open(quotes_path) as fh:
            table = json.load(fh)["stage_attribution"]["per_batch"]
    except (OSError, KeyError, ValueError, TypeError):
        return {}
    out: Dict[int, Dict[str, float]] = {}
    for batch, stages in table.items():
        try:
            out[int(batch)] = {s: float(stages[s]["ms_per_batch"])
                               for s in DEVICE_STAGES if s in stages}
        except (KeyError, TypeError, ValueError):
            continue
    return out


def fold_attribution(tracer, metrics, quotes_path: str = DEFAULT_QUOTES_PATH,
                     window_s: float = 30.0,
                     _quotes_cache: Dict[str, Any] = {}) -> Dict[str, float]:
    """Fold the tracer's recent batch spans into the attribution gauges
    (module docstring); returns the values set. A loaded table is cached
    per path in the shared default dict; a miss is not, so a table
    written after the start is picked up."""
    out: Dict[str, float] = {}
    if tracer is None or metrics is None:
        return out
    spans = tracer.snapshot(topic=tracing.BATCH_TOPIC)
    busy = tracing.device_busy_fraction(spans, window_s=window_s)
    metrics.set_gauge(mn.DEVICE_BUSY_FRACTION, busy)
    out[mn.DEVICE_BUSY_FRACTION] = busy
    quotes = _quotes_cache.get(quotes_path)
    if quotes is None:
        quotes = load_stage_quotes(quotes_path)
        if quotes:
            _quotes_cache[quotes_path] = quotes
    if not quotes:
        return out
    lo = time.monotonic() - window_s
    buckets = {s.get("bucket") for s in spans
               if s.get("stage") == "dispatch" and s["t0"] >= lo and s.get("bucket")}
    for bucket in buckets:
        # the nearest measured batch stands in for an unmeasured bucket
        nearest = min(quotes, key=lambda b: abs(b - bucket))
        stage_ms = quotes[nearest]
        total = sum(stage_ms.values())
        if total <= 0:
            continue
        for stage, ms in stage_ms.items():
            share = ms / total
            metrics.set_gauge(mn.STAGE_SHARE_PREFIX + f"b{bucket}_{stage}", share)
            out[mn.STAGE_SHARE_PREFIX + f"b{bucket}_{stage}"] = share
    return out


class ExpoServer:
    """Read-only HTTP exposition (module docstring). ``port=0`` binds an
    ephemeral port (``.port`` after construction); ``start`` spawns the
    HTTP thread and the refresh thread, ``stop`` ends both."""

    def __init__(self, service=None, tracer=None, metrics=None, host: str = "127.0.0.1",
                 port: int = 0, refresh_s: float = 2.0,
                 quotes_path: str = DEFAULT_QUOTES_PATH, slo=None, router=None,
                 rollout=None, registry=None):
        self.service = service
        self.tracer = tracer if tracer is not None else getattr(service, "tracer", None)
        self.metrics = metrics if metrics is not None else getattr(service, "metrics", None)
        self.slo = slo if slo is not None else getattr(service, "slo", None)
        #: the topic router behind ``/replicas``
        self.router = router
        #: the rollout coordinator behind ``/rollout`` (else the service's)
        self.rollout = rollout
        self.registry = registry
        self.refresh_s = float(refresh_s)
        self.quotes_path = quotes_path
        self._started_t = time.monotonic()
        self._stop = threading.Event()
        self._refresh_thread: Optional[threading.Thread] = None
        self._thread: Optional[threading.Thread] = None
        expo = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                expo._handle_get(self)

            def do_POST(self):  # noqa: N802
                expo._reject(self)

            do_PUT = do_DELETE = do_PATCH = do_POST  # noqa: N815

            def log_message(self, fmt, *args):  # no per-request stderr
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]

    # ---- lifecycle ----

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                                        name="ocvf-expo")
        self._thread.start()
        self._refresh_thread = threading.Thread(target=self._refresh_loop, daemon=True,
                                                name="ocvf-expo-refresh")
        self._refresh_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        for name in ("_thread", "_refresh_thread"):
            thread = getattr(self, name)
            if thread is not None:
                thread.join(timeout=2.0)
                setattr(self, name, None)

    def _refresh_loop(self) -> None:
        """The SLO backstop tick first, in its own try (a failing fold must
        not starve it), then the attribution fold."""
        while not self._stop.wait(timeout=self.refresh_s):
            if self.slo is not None:
                try:
                    self.slo.tick()
                except Exception:  # noqa: BLE001 - the refresh must live
                    log.exception("expo slo backstop tick failed")
                    if self.metrics is not None:
                        self.metrics.incr(mn.SLO_TICK_ERRORS)
            try:
                fold_attribution(self.tracer, self.metrics, quotes_path=self.quotes_path)
            except Exception:  # noqa: BLE001 - the refresh must live
                log.exception("expo attribution refresh failed")
                if self.metrics is not None:
                    self.metrics.incr(mn.EXPO_ERRORS)

    # ---- requests ----

    def payload(self, path: str, query: Dict[str, Any]) -> Dict[str, Any]:
        """The JSON body of one GET path; ``KeyError`` for an unknown path
        (404). Reads only."""
        service = self.service
        if path in ("/", "/index"):
            return {
                "endpoints": ["/", "/metrics", "/prom", "/health", "/ledger", "/brownout",
                              "/spans", "/attribution", "/replicas", "/rollout",
                              "/registry", "/tracks"],
                "uptime_s": round(time.monotonic() - self._started_t, 1),
                "brownout_level": getattr(service, "brownout_level", None),
                "health": self.slo.state if self.slo is not None else None,
                "tracer": self.tracer.stats() if self.tracer is not None else None,
            }
        if path == "/metrics":
            return dict(self.metrics.summary()) if self.metrics else {}
        if path == "/health":
            pending = getattr(getattr(service, "replica", None), "install_pending", None)
            if pending:
                return {"state": "critical", "state_code": STATE_CRITICAL,
                        "detail": f"registry weights not installed: {pending}"}
            if self.slo is None:
                return {"state": None, "detail": "no SLO monitor wired"}
            return dict(self.slo.verdict())
        if path == "/ledger":
            return service.ledger() if service is not None else {}
        if path == "/brownout":
            return {"level": getattr(service, "brownout_level", None)}
        if path == "/spans":
            limit = self._span_limit(query)
            if self.tracer is None:
                return {"topics": [], "spans": []}
            topic = (query.get("topic") or [None])[0]
            return {"topics": self.tracer.topics(),
                    "spans": self.tracer.snapshot(topic=topic, limit=limit)}
        if path == "/attribution":
            return fold_attribution(self.tracer, self.metrics, quotes_path=self.quotes_path)
        if path == "/replicas":
            if self.router is None:
                return {"replicas": None, "detail": "no topic router wired"}
            return {"replicas": self.router.registry()}
        if path == "/rollout":
            coordinator = (self.rollout if self.rollout is not None
                           else getattr(service, "rollout", None))
            if coordinator is None:
                return {"rollout": None, "detail": "no rollout in flight"}
            return {"rollout": coordinator.status()}
        if path == "/registry":
            registry = (self.registry if self.registry is not None
                        else getattr(service, "registry", None))
            if registry is None:
                return {"registry": None, "detail": "no model registry wired"}
            swap = getattr(service, "registry_swap", None)
            return {"registry": registry.status(),
                    "swap": swap.status() if swap is not None else None}
        if path == "/tracks":
            tracker = getattr(service, "tracker", None)
            if tracker is None:
                return {"tracks": None, "detail": "no identity tracker wired"}
            return {"tracks": tracker.registry(), "stats": tracker.stats()}
        raise KeyError(path)

    @staticmethod
    def _span_limit(query: Dict[str, Any]) -> int:
        """``limit=`` (alias ``n=``) of ``/spans``, bounds-checked."""
        raw = (query.get("limit") or query.get("n") or [None])[0]
        if raw is None:
            return SPAN_LIMIT_DEFAULT
        try:
            limit = int(raw)
        except (TypeError, ValueError):
            raise _BadQuery(f"limit must be an integer, got {raw!r}")
        if limit <= 0:
            raise _BadQuery(f"limit must be positive, got {limit}")
        return min(limit, SPAN_LIMIT_MAX)

    def _handle_get(self, handler) -> None:
        if self.metrics is not None:
            self.metrics.incr(mn.EXPO_REQUESTS)
        parsed = urlparse(handler.path)
        try:
            if parsed.path == "/prom":
                text = render_prom(self.metrics) if self.metrics else ""
                self._respond(handler, 200, text.encode("utf-8"),
                              "text/plain; version=0.0.4; charset=utf-8")
                return
            body = self.payload(parsed.path, parse_qs(parsed.query))
            status = 200
            if parsed.path == "/health" and body.get("state_code") == STATE_CRITICAL:
                status = 503  # a load balancer reads the verdict from the code
        except _BadQuery as exc:
            body, status = {"error": str(exc)}, 400
        except KeyError:
            body, status = {"error": f"unknown path {parsed.path!r}"}, 404
        except Exception:  # noqa: BLE001 - a handler bug answers 500
            log.exception("expo request failed")
            if self.metrics is not None:
                self.metrics.incr(mn.EXPO_ERRORS)
            body, status = {"error": "internal error"}, 500
        self._respond(handler, status, json.dumps(body, default=repr).encode("utf-8"),
                      "application/json")

    @staticmethod
    def _respond(handler, status: int, blob: bytes, content_type: str,
                 allow: Optional[str] = None) -> None:
        try:
            handler.send_response(status)
            if allow is not None:
                handler.send_header("Allow", allow)
            handler.send_header("Content-Type", content_type)
            handler.send_header("Content-Length", str(len(blob)))
            handler.end_headers()
            handler.wfile.write(blob)
        except OSError:
            pass  # the client went away

    def _reject(self, handler) -> None:
        """Every verb but GET: 405."""
        if self.metrics is not None:
            self.metrics.incr(mn.EXPO_REQUESTS)
        self._respond(handler, 405, b'{"error": "read-only endpoint: GET only"}',
                      "application/json", allow="GET")
