"""``ocvf-recognize-torch``: the live recognizer node on one NVIDIA card.
Port of ``opencv_facerecognizer_tpu/apps/recognize.py``.

    python -m opencv_facerecognizer_tpu_torch.apps.recognize \\
        --model cnn.msgpack --detector det.msgpack --gallery gallery_dir \\
        --source {jsonl,socket,dir} [--device cuda|cpu] ...

It loads a CNN model checkpoint and a detector checkpoint (written by
either package), embeds the gallery directory (a folder per subject) and
serves frames:

- ``--source jsonl`` (default): frames as JSONL on stdin (the schema of
  ``runtime.connector.encode_frame``), results as JSONL on stdout; stdin
  EOF drains every accepted frame and exits. Control messages ride the
  same stream (``{"topic": "ocvfacerec/control", "data": {"cmd":
  "enroll", ...}}``).
- ``--source socket``: the same JSONL framing over TCP (``--host``,
  ``--port``), serving until SIGTERM.
- ``--source dir``: replay the images of ``--dir`` once, print one result
  line each, exit.

With ``--state-dir DIR`` the node keeps its gallery durable: it takes the
writer lease of DIR (a second writer exits naming it), recovers the
newest checkpoint and replays the enrolment WAL (the first run on an
empty DIR checkpoints the ``--gallery`` rows instead), appends every
enrolment to the WAL before it is acknowledged, checkpoints in the
background (``--checkpoint-every-s``, ``--checkpoint-wal-rows``,
``--keep-checkpoints``) and watches the disk (``--disk-low-watermark``,
``--durability-probe-s``). SIGTERM drains, takes a final checkpoint and
exits 0 with a ``clean`` report. ``--supervised`` restarts a crashed
serving loop; ``--probe-on-degraded`` probes the card when dispatches keep
failing. A state dir crosses between the two packages both ways.

The command line is the reference's, so any reference command line
parses. ``--device`` (default ``cuda``) is the port's own: the CLI runs on
the card and raises without one, unless ``--device cpu`` names the CPU.
A flag whose subsystem is not ported yet, set away from its default,
exits naming its ROADMAP item (``REFUSED``) instead of being ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
import warnings

import numpy as np
import torch

#: the ROADMAP items that bring the refused flags
_ADMISSION = "ROADMAP A.8.2 (admission, brownout, dead-letter journal)"
_INGEST = "ROADMAP A.8.3 (ingest staging ring, JPEG decode pool)"
_OBSERVE = "ROADMAP A.8.4 (tracing, SLO monitor, exposition, profiling)"
_REGISTRY = "ROADMAP A.8.5 (model registry, cascade)"
_REPLICAS = "ROADMAP A.8.6 (replication, topic router)"
_HOST = "ROADMAP A.8.7 (host side of the step: async grow, CUDA graphs)"
_MULTI_GPU = "ROADMAP A.11 (multi-GPU)"

#: (flag, refused value or None for "any value but the default", item)
REFUSED = (
    ("--max-inflight-frames", None, _ADMISSION), ("--rate-limit-fps", None, _ADMISSION),
    ("--brownout-queue-wait-ms", None, _ADMISSION),
    ("--shed-stale-after-ms", None, _ADMISSION),
    ("--dead-letter-journal", None, _ADMISSION), ("--journal-fsync", None, _ADMISSION),
    ("--ingest-mode", "jpeg", _INGEST), ("--ingest-ring-depth", None, _INGEST),
    ("--ingest-decode-workers", None, _INGEST),
    ("--trace-sample", None, _OBSERVE), ("--trace-ring", None, _OBSERVE),
    ("--trace-jsonl", None, _OBSERVE), ("--flight-dir", None, _OBSERVE),
    ("--expo-port", None, _OBSERVE), ("--slo", None, _OBSERVE),
    ("--slo-interval-s", None, _OBSERVE), ("--slo-e2e-p99-ms", None, _OBSERVE),
    ("--slo-queue-wait-p99-ms", None, _OBSERVE),
    ("--slo-completion-target", None, _OBSERVE),
    ("--slo-durability-rows", None, _OBSERVE), ("--slo-windows", None, _OBSERVE),
    ("--slo-loop-stale-s", None, _OBSERVE), ("--profile-dir", None, _OBSERVE),
    ("--profile-batches", None, _OBSERVE),
    ("--cascade", None, _REGISTRY), ("--cascade-threshold", None, _REGISTRY),
    ("--no-cascade", None, _REGISTRY), ("--registry-swap", None, _REGISTRY),
    ("--detector-version", None, _REGISTRY), ("--cascade-version", None, _REGISTRY),
    ("--replica-role", "reader", _REPLICAS), ("--replica-poll-ms", None, _REPLICAS),
    ("--replication-lag-rows", None, _REPLICAS), ("--router", None, _REPLICAS),
    ("--router-health", None, _REPLICAS), ("--router-budget-fps", None, _REPLICAS),
    ("--router-writer", None, _REPLICAS), ("--router-link-deadline-s", None, _REPLICAS),
    ("--router-hedge-deadline-s", None, _REPLICAS),
    ("--router-dedup-window", None, _REPLICAS),
    ("--async-grow", None, _HOST),
    ("--parallel", "pp", _MULTI_GPU),
)


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, names, defaults and choices, plus ``--device``."""
    p = argparse.ArgumentParser(prog="ocvf-recognize-torch",
                                description="Live face recognition on an NVIDIA card")
    refused = {flag: (value, item) for flag, value, item in REFUSED}

    def add(flag, *args, help=None, **kwargs):
        if flag in refused:  # the help names the item from REFUSED, the one source
            value, item = refused[flag]
            note = f"refused: {item}" if value is None else f"{value} is refused: {item}"
            help = f"{help}; {note}" if help else note
        p.add_argument(flag, *args, help=help, **kwargs)

    add("--device", default="cuda",
        help="torch device to serve on (default cuda; raises without a card). "
             "cpu runs the plain PyTorch path")
    add("--model", help="CNN model checkpoint (save_model of a CNNEmbedding model)")
    add("--detector", help="detector checkpoint (CNNFaceDetector.save)")
    add("--gallery", help="dataset dir to enrol at startup (a folder per subject)")
    add("--source", choices=["jsonl", "socket", "dir"], default="jsonl")
    add("--dir", help="image directory for --source dir")
    add("--port", type=int, default=5600, help="TCP port for --source socket")
    add("--host", default="127.0.0.1", help="bind address for --source socket")
    add("--profile-dir")
    add("--profile-batches", type=int, default=20)
    add("--frame-size", type=int, nargs=2, default=(256, 256), metavar=("H", "W"))
    add("--parallel", choices=["fused", "pp"], default="fused",
        help="fused: the whole step on one card")
    add("--fused-embedder", action="store_true",
        help="run the embed stage as one fused kernel per block (ops.sepblock)")
    add("--batch-size", type=int, default=8)
    add("--flush-ms", type=float, default=30.0,
        help="max age of the oldest buffered frame before a partial batch "
             "flushes; the cap of the adaptive deadline with --target-latency-ms")
    add("--target-latency-ms", type=float, default=None,
        help="adaptive flush: wait the target less the EWMA of the measured "
             "downstream time, clamped to [2 ms, --flush-ms]")
    add("--bucket-sizes", type=int, nargs="+", default=[8, 32, 128], metavar="B",
        help="dispatch ladder: a partial batch runs at the smallest bucket "
             "that holds it (all warmed at start); 0 disables slicing")
    add("--no-readback-worker", action="store_true",
        help="drain readbacks inline in the serving loop (polling) instead of "
             "in the readback worker thread")
    add("--readback-poll-ms", type=float, default=5.0,
        help="inline path: poll interval while waiting out a head batch")
    add("--drain-poll-ms", type=float, default=50.0,
        help="completion-wait tick of drain() and the serving threads")
    add("--ingest-mode", choices=["f32", "uint8", "jpeg"], default=None,
        help="transfer dtype of the frame batches: f32 (default) or uint8 "
             "(4x fewer bytes, cast on the card)")
    add("--ingest-ring-depth", type=int, default=0)
    add("--ingest-decode-workers", type=int, default=2)
    add("--transfer-uint8", action="store_true",
        help="deprecated alias of --ingest-mode uint8")
    add("--cascade", metavar="PATH")
    add("--cascade-threshold", type=float, default=None, metavar="P")
    add("--no-cascade", action="store_true")
    add("--track-reverify-frames", type=int, default=8, metavar="N",
        help="identity cache: a coherent track serves its identity from the "
             "cache for at most N-1 frames before a full re-verify")
    add("--track-iou-min", type=float, default=0.3, metavar="IOU",
        help="minimum box IoU for frame-to-frame track association")
    add("--no-track-cache", action="store_true",
        help="disable the identity cache: every frame takes the full path")
    add("--similarity-threshold", type=float, default=0.3)
    add("--capacity", type=int, default=4096, help="gallery capacity")
    add("--gallery-dtype", choices=["bf16", "f32"], default="bf16",
        help="device dtype of the gallery rows (both match in bf16 x bf16 -> f32)")
    add("--match-mode", choices=["auto", "exact", "ivf"], default="auto",
        help="auto: exact scan below the IVF threshold, two-stage IVF above; "
             "exact: always the scan; ivf: two-stage once the quantizer is built")
    add("--ivf-nlist", type=int, default=0,
        help="IVF cell count; 0 = from the row count at every build")
    add("--ivf-nprobe", type=int, default=8, help="IVF cells probed per query")
    add("--async-grow", action="store_true")
    add("--metrics-jsonl",
        help="append JSON records to this file: the startup's checkpoint load "
             "and gallery embed seconds, the dir replay's frame count and "
             "seconds, and at shutdown the ledger and the metrics summary")
    add("--readback-deadline", type=float, default=30.0, metavar="S",
        help="dead-letter a batch whose readback is not ready after S seconds")
    add("--dispatch-retries", type=int, default=3,
        help="retries per batch on transient dispatch failures (backoff)")
    add("--degraded-after", type=int, default=3,
        help="consecutive dispatch failures before degraded mode is published")
    add("--probe-on-degraded", action="store_true",
        help="in degraded mode, probe the card in a bounded subprocess and publish "
             "its verdict (backend_usable); there is no CPU fallback")
    add("--supervised", action="store_true",
        help="restart a crashed serving loop from the last-known-good gallery "
             "(ServiceSupervisor)")
    add("--max-inflight-frames", type=int, default=0)
    add("--rate-limit-fps", type=float, default=0.0)
    add("--brownout-queue-wait-ms", type=float, default=0.0)
    add("--shed-stale-after-ms", type=float, default=0.0)
    add("--dead-letter-journal", metavar="PATH")
    add("--state-dir", metavar="DIR",
        help="durable state: checkpoints, the enrolment WAL, the IVF sidecar and the "
             "registry manifest; recovered at start, checkpointed at SIGTERM")
    add("--embedder-version", type=int, default=0, metavar="N",
        help="the loaded model's embedder version, stamped on results and "
             "identity-cache entries (0 = 1)")
    add("--detector-version", type=int, default=0, metavar="N")
    add("--cascade-version", type=int, default=0, metavar="N")
    add("--registry-swap", metavar="ROLE=VERSION")
    add("--checkpoint-every-s", type=float, default=300.0,
        help="checkpoint when WAL rows are this old")
    add("--checkpoint-wal-rows", type=int, default=256,
        help="checkpoint when this many rows are in the WAL only")
    add("--keep-checkpoints", type=int, default=3, help="checkpoints retained")
    add("--disk-low-watermark", type=float, default=256.0, metavar="MB",
        help="below this much free disk: force a checkpoint and shrink retention; "
             "below a sixth of it: refuse enrolments (0 disables)")
    add("--durability-probe-s", type=float, default=5.0,
        help="interval of the disk checks and of the recovery probe while degraded")
    add("--journal-fsync", choices=["never", "interval", "always"], default="never")
    add("--trace-sample", type=float, default=0.0)
    add("--trace-ring", type=int, default=4096)
    add("--trace-jsonl", metavar="PATH")
    add("--flight-dir", metavar="DIR")
    add("--expo-port", type=int, default=None, metavar="PORT")
    add("--slo", action="store_true")
    add("--slo-interval-s", type=float, default=5.0)
    add("--slo-e2e-p99-ms", type=float, default=500.0)
    add("--slo-queue-wait-p99-ms", type=float, default=250.0)
    add("--slo-completion-target", type=float, default=0.999)
    add("--slo-durability-rows", type=int, default=1024)
    add("--slo-windows", type=float, nargs=2, default=(60.0, 600.0),
        metavar=("SHORT_S", "LONG_S"))
    add("--replica-role", choices=["writer", "reader"], default="writer",
        help="writer (default)")
    add("--replica-poll-ms", type=float, default=50.0)
    add("--replication-lag-rows", type=int, default=4096)
    add("--router", metavar="HOST:PORT[,HOST:PORT...]")
    add("--router-health", metavar="URL[,URL...]")
    add("--router-budget-fps", type=float, default=0.0)
    add("--router-writer", type=int, default=0, metavar="IDX")
    add("--router-link-deadline-s", type=float, default=0.0)
    add("--router-hedge-deadline-s", type=float, default=0.0)
    add("--router-dedup-window", type=int, default=4096)
    add("--slo-loop-stale-s", type=float, default=30.0)
    return p


def refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    """``SystemExit`` naming the ROADMAP item of the first flag whose
    subsystem is not ported yet and which is set away from its default."""
    for flag, value, item in REFUSED:
        dest = flag.lstrip("-").replace("-", "_")
        got = getattr(args, dest)
        default = parser.get_default(dest)
        refused = got == value if value is not None else (
            got != default and not (isinstance(default, (list, tuple))
                                    and list(got) == list(default)))
        if refused:
            raise SystemExit(f"ocvf-recognize-torch: {flag} {got!r} is not ported yet: "
                             f"{item}")


def _ingest_dtype(args):
    """The batches' transfer dtype: uint8 for ``--ingest-mode uint8`` (or
    the deprecated ``--transfer-uint8``), else float32."""
    mode = args.ingest_mode
    if args.transfer_uint8:
        warnings.warn("--transfer-uint8 is deprecated; it aliases --ingest-mode uint8",
                      DeprecationWarning, stacklevel=2)
        mode = mode or "uint8"
    return np.uint8 if mode == "uint8" else np.float32


def _load_stack(args, metrics):
    """Checkpoints, the gallery directory embedded into a gallery, and the
    serving pipeline on ``--device``; returns (pipeline, subject names).
    Logs a ``startup`` record of its load and embed seconds to
    ``metrics``' sink."""
    from opencv_facerecognizer_tpu_torch.models.detector import CNNFaceDetector
    from opencv_facerecognizer_tpu_torch.models.embedder import CNNEmbedding
    from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery
    from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline
    from opencv_facerecognizer_tpu_torch.parallel.quantizer import CoarseQuantizer
    from opencv_facerecognizer_tpu_torch.utils import dataset as dataset_utils
    from opencv_facerecognizer_tpu_torch.utils import serialization
    from opencv_facerecognizer_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    model = serialization.load_model(args.model, device=device)
    feature = model.feature
    if not isinstance(feature, CNNEmbedding):
        raise SystemExit("--model must be a CNN model checkpoint (CNNEmbedding)")
    detector = CNNFaceDetector.load(args.detector, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    images, labels, names = dataset_utils.read_images(args.gallery,
                                                      image_size=feature.input_size)
    emb = feature.extract(images).cpu().numpy()
    load_s, embed_s = t1 - t0, time.perf_counter() - t1
    metrics.log("startup", checkpoint_load_s=load_s, gallery_images=len(images),
                gallery_subjects=len(names), gallery_embed_s=embed_s)
    print(f"checkpoints loaded in {load_s:.3f} s; gallery of {len(images)} images, "
          f"{len(names)} subjects, embedded in {embed_s:.3f} s", file=sys.stderr)
    gallery = ShardedGallery(
        max(args.capacity, 2 * len(emb)), emb.shape[1],
        store_dtype=torch.bfloat16 if args.gallery_dtype == "bf16" else torch.float32,
        device=device, embedder_version=args.embedder_version or 1)
    gallery.add(emb, labels)
    if args.match_mode != "exact":
        # attached after the startup enrolment: main() runs the one build
        gallery.attach_quantizer(
            CoarseQuantizer(nlist=args.ivf_nlist or CoarseQuantizer.default_nlist(
                gallery.capacity), nprobe=args.ivf_nprobe, auto_nlist=not args.ivf_nlist),
            mode=args.match_mode)
    pipeline = RecognitionPipeline(detector, feature.net, gallery,
                                   face_size=feature.input_size,
                                   fused_embedder=args.fused_embedder, device=device)
    return pipeline, names


def _registry_fence(registry, args) -> None:
    """Refuse to start when a declared detector or cascade version is not
    the one the state dir's manifest serves (a no-op at the defaults)."""
    for role, declared in (("detector", args.detector_version),
                           ("cascade", args.cascade_version)):
        if declared and registry.version(role) != declared:
            raise SystemExit(
                f"ocvf-recognize-torch: --{role}-version {declared} declared but the "
                f"state dir's registry manifest serves {role} v{registry.version(role)}")


def _open_state(args, pipeline, names, metrics):
    """The writer's durable state over ``--state-dir`` (the lease is held
    already): recovery into the pipeline's gallery and ``names``, the
    ``--embedder-version`` fence, the registry manifest, the first
    checkpoint of a fresh dir, the durability monitor. Returns the
    ``StateLifecycle``."""
    from opencv_facerecognizer_tpu_torch.runtime.registry import ModelRegistry
    from opencv_facerecognizer_tpu_torch.runtime.resilience import DurabilityMonitor
    from opencv_facerecognizer_tpu_torch.runtime.state_store import StateLifecycle

    state = StateLifecycle(args.state_dir, metrics=metrics,
                           keep_checkpoints=args.keep_checkpoints,
                           checkpoint_wal_rows=args.checkpoint_wal_rows,
                           checkpoint_every_s=args.checkpoint_every_s)
    t0 = time.perf_counter()
    report = state.recover(pipeline.gallery, names)
    recover_s = time.perf_counter() - t0
    print(f"state recovery: {report}", file=sys.stderr)
    recovered_version = int(report.get("embedder_version", 1))
    if args.embedder_version and recovered_version != args.embedder_version:
        raise SystemExit(
            f"ocvf-recognize-torch: --embedder-version {args.embedder_version} declared but "
            f"recovery landed on embedder v{recovered_version}: refusing to serve mixed "
            f"spaces (the embedder rollout is ROADMAP A.8.8)")
    if state.registry is None:
        state.attach_registry(ModelRegistry(args.state_dir, metrics=metrics))
    state.registry.mirror_embedder(recovered_version)
    _registry_fence(state.registry, args)
    if report["recovered_checkpoint"] is None and not report["replayed_records"]:
        # a fresh dir: the baseline gallery is durable before the first
        # enrolment
        state.checkpoint_now(wait=True)
    metrics.log("recovery", seconds=recover_s, stages=state.last_recovery_s,
                checkpoint=report["recovered_checkpoint"],
                replayed_records=report["replayed_records"],
                gallery_size=report["gallery_size"])
    DurabilityMonitor(state, metrics=metrics, probe_interval_s=args.durability_probe_s,
                      low_watermark_bytes=int(args.disk_low_watermark * (1 << 20)))
    return state


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)
    if not (args.model and args.detector and args.gallery):
        parser.error("the following arguments are required: --model, --detector, --gallery")
    from opencv_facerecognizer_tpu_torch.runtime.connector import (
        FakeConnector, JSONLConnector, SocketConnector, encode_frame)
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
        FRAME_TOPIC, RESULT_TOPIC, RecognizerService)
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        WriterLease, WriterLeaseHeldError)
    from opencv_facerecognizer_tpu_torch.runtime.resilience import (
        ResiliencePolicy, ServiceSupervisor)
    from opencv_facerecognizer_tpu_torch.runtime.state_store import graceful_shutdown
    from opencv_facerecognizer_tpu_torch.runtime.tracker import (
        IdentityTracker, TrackerConfig)
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics

    transfer_dtype = _ingest_dtype(args)
    metrics_sink = open(args.metrics_jsonl, "a") if args.metrics_jsonl else None
    metrics = Metrics(sink=metrics_sink)
    lease = None
    try:
        if args.state_dir:
            # one writer per state dir, taken before anything is loaded or
            # touched: a second writer fails closed with no side effects
            lease = WriterLease(args.state_dir, metrics=metrics)
            try:
                lease.acquire()
            except WriterLeaseHeldError as exc:
                raise SystemExit(f"ocvf-recognize-torch: {exc}")
        pipeline, names = _load_stack(args, metrics)
        state = _open_state(args, pipeline, names, metrics) if args.state_dir else None
    except BaseException:
        if lease is not None:
            lease.release()
        if metrics_sink:
            metrics_sink.close()
        raise
    quantizer = pipeline.gallery.quantizer
    if quantizer is not None:
        quantizer.metrics = metrics
        if not quantizer.ready and pipeline.gallery._ivf_wanted():
            # no sidecar (or no --state-dir): train before serving
            print(f"training IVF coarse quantizer (nlist={quantizer.nlist})...",
                  file=sys.stderr)
            quantizer.rebuild_now(wait=True, skip_if_ready=True)
            print(f"IVF quantizer: {quantizer.stats()}", file=sys.stderr)

    if args.source == "jsonl":
        connector = JSONLConnector(sys.stdin, sys.stdout, metrics=metrics)
    elif args.source == "socket":
        connector = SocketConnector(host=args.host, port=args.port, listen=True,
                                    metrics=metrics)
    else:
        connector = FakeConnector()
    tracker = None
    if not args.no_track_cache:
        tracker = IdentityTracker(TrackerConfig(
            reverify_frames=max(1, args.track_reverify_frames),
            iou_min=args.track_iou_min), metrics=metrics)
    service = RecognizerService(
        pipeline, connector, batch_size=args.batch_size,
        frame_shape=tuple(args.frame_size), flush_timeout=args.flush_ms / 1e3,
        similarity_threshold=args.similarity_threshold, subject_names=names,
        metrics=metrics, transfer_dtype=transfer_dtype,
        readback_worker=not args.no_readback_worker,
        readback_poll_s=args.readback_poll_ms / 1e3,
        drain_poll_s=args.drain_poll_ms / 1e3,
        bucket_sizes=tuple(b for b in args.bucket_sizes if b > 0),
        target_latency_s=(None if args.target_latency_ms is None
                          else args.target_latency_ms / 1e3),
        resilience=ResiliencePolicy(dispatch_retries=args.dispatch_retries,
                                    readback_deadline_s=args.readback_deadline,
                                    degraded_after=args.degraded_after,
                                    probe_backend_on_degraded=args.probe_on_degraded),
        tracker=tracker, state_store=state)
    supervisor = ServiceSupervisor(service, state=state) if args.supervised else None
    if supervisor is not None:
        supervisor.start()
    else:
        service.start()
    if args.source == "socket":
        print(f"serving on {args.host}:{connector.port}", file=sys.stderr)

    term_event = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda signum, frame: term_event.set())
    except ValueError:
        pass  # not the main thread (tests drive main() from a worker)

    interrupted = False
    try:
        if args.source == "dir":
            from opencv_facerecognizer_tpu_torch.ops import image as image_ops
            from opencv_facerecognizer_tpu_torch.utils.dataset import _imread_gray

            files = sorted(f for f in os.listdir(args.dir)
                           if f.lower().endswith((".png", ".jpg", ".jpeg", ".pgm", ".bmp")))
            t0 = time.perf_counter()
            for fn in files:
                img = _imread_gray(os.path.join(args.dir, fn))
                if img is None:
                    continue
                img = image_ops.resize(torch.as_tensor(img), tuple(args.frame_size)).numpy()
                connector.inject(FRAME_TOPIC, {**encode_frame(img), "meta": {"file": fn}})
            deadline = time.monotonic() + 60
            while (len(connector.messages(RESULT_TOPIC)) < len(files)
                   and time.monotonic() < deadline and not term_event.is_set()):
                time.sleep(0.005)
            results = connector.messages(RESULT_TOPIC)
            metrics.log("dir_replay", files=len(files), answered=len(results),
                        seconds=time.perf_counter() - t0)
            for message in results:
                print(json.dumps(message))
        else:
            # until the input ends (stdin EOF), SIGTERM or Ctrl-C; then every
            # accepted frame finishes and publishes before the teardown
            while not connector.eof.wait(timeout=0.5):
                if term_event.is_set():
                    print("SIGTERM: draining before shutdown", file=sys.stderr)
                    break
            service.drain()
    except KeyboardInterrupt:
        interrupted = True
    finally:
        shutdown = graceful_shutdown(service, state=state, supervisor=supervisor,
                                     drain_timeout=0.0 if interrupted else 30.0)
        if state is not None:
            print(f"final checkpoint: "
                  f"{'written' if shutdown['final_checkpoint'] else 'FAILED (previous kept)'}",
                  file=sys.stderr)
        summary = metrics.summary()
        metrics.log("shutdown", ledger=shutdown["ledger"], summary=summary,
                    clean=shutdown["clean"])
        if summary:
            print(f"metrics: {summary}", file=sys.stderr)
        if shutdown["ledger"]["admitted"]:
            print(f"admission ledger: {shutdown['ledger']}", file=sys.stderr)
        print(f"shutdown: {'clean' if shutdown['clean'] else 'NOT clean'}", file=sys.stderr)
        if lease is not None:
            lease.release()  # last: the final checkpoint ran under it
        if metrics_sink:
            metrics_sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
