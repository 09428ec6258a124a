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

Ingest: frames stage through a ring of pinned host buffers and upload on
a side stream (``--ingest-mode f32|uint8|jpeg``, ``--ingest-ring-depth``,
``--ingest-decode-workers``); ``jpeg`` takes ``{"__jpeg__": base64}``
payloads and decodes them off the connector thread. With ``--state-dir``
and ``--embedder-version N``, a pending cutover to N is completed by the
recovery; any other version mismatch exits.

The cascade: ``--cascade PATH`` loads a stage-1 ``FaceGate`` (written by
either package) onto ``--device``; each batch is scored at its rung first
and frames below ``--cascade-threshold`` (default: the gate's own) are
answered with no faces (``exit: "cascade"``) without the full step;
``--no-cascade`` serves single-stage with the gate loaded. The registry:
with ``--state-dir``, ``--detector-version N`` and ``--cascade-version N``
refuse to start unless the manifest serves that version of the role, and
``--registry-swap ROLE=N`` (``detector`` or ``cascade``) performs one
fenced swap offline and exits: the candidate must be staged at
``STATE_DIR/registry/<role>-v<N>.params``, the writer lease is taken, the
``registry_cutover`` fence is appended and the manifest installed; a
writer picks the version up at its next start.

Overload control: ``--max-inflight-frames`` and ``--rate-limit-fps`` reject
at the front door (``rejected`` statuses), ``--brownout-queue-wait-ms``
sheds bulk frames under a growing queue, ``--shed-stale-after-ms`` sheds
frames that waited too long, and ``--dead-letter-journal`` (fsynced per
``--journal-fsync``) records every lost frame. Observability:
``--trace-sample`` / ``--trace-ring`` / ``--trace-jsonl`` record spans,
``--flight-dir`` keeps flight-recorder dumps, ``--expo-port`` serves
``/metrics``, ``/prom``, ``/health``, ``/spans`` and more (0 picks a free
port, printed on stderr), ``--slo`` runs the burn-rate monitor (the
``--slo-*`` objectives), and ``--profile-dir`` writes a ``torch.profiler``
Chrome trace (CPU and CUDA) of the first ``--profile-batches`` batches.

Replication: ``--replica-role reader`` with ``--state-dir`` serves a
read replica of a writer's dir (no lease, no writes): it anchors on the
newest checkpoint, tails the WAL between batches (``--replica-poll-ms``),
refuses enrolment, installs the detector or cascade a registry swap moves
to at its re-anchor, and with ``--slo`` watches its lag
(``--replication-lag-rows``). ``--router HOST:PORT,...`` runs a topic
router in front of such CLIs (``--source socket`` each) and loads no
model: rendezvous per topic, ``--router-health`` failover,
``--router-budget-fps`` spills, ``--router-writer`` for control traffic,
``--router-link-deadline-s`` pings, ``--router-hedge-deadline-s`` hedges,
``--router-dedup-window``; ``/replicas`` on ``--expo-port``.

Meshes: ``--parallel fused`` (the default) with ``--device cuda`` lays
the reference's ``make_mesh()`` over every card, dp 1 and tp n: each
step detects, aligns and embeds its frames on the first card (dp 1: one
row) and matches them against the gallery sharded over all n (kernel A
on each card's shard, the candidates merged on the first), each step key
captured as CUDA graphs, one per card and level (``parallel.pipeline``). On one card, or
with ``--device cuda:N``, it serves on that card alone. On a mesh it
refuses ``--match-mode ivf`` (the reference's text; ``auto`` attaches no
quantizer there) and ``--fused-embedder`` (the reference's
``ValueError``); ``--cascade`` runs stage 1 on the first card. Pipeline
parallelism: ``--parallel pp`` detects and aligns on one half of the
cards and embeds and matches on the other, the gallery sharded over the
second half's tp axis (``parallel.pp``): 8 or more cards (a multiple of
4) give dp x tp = (n / 2) x 2, fewer tp 1. It needs an even card count
>= 2, and refuses ``--fused-embedder``, ``--match-mode ivf`` and
``--cascade`` (each single-mesh only), before any checkpoint loads, with
the reference's messages.

The command line is the reference's, so any reference command line
parses, and every flag of it is served. ``--device`` (default ``cuda``) is
the port's own: the CLI runs on the card and raises without one, unless
``--device cpu`` names the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import sys
import threading
import time

import torch

def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, names, defaults and choices, plus ``--device``."""
    p = argparse.ArgumentParser(prog="ocvf-recognize-torch",
                                description="Live face recognition on an NVIDIA card")
    add = p.add_argument

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
    add("--profile-dir",
        help="write a torch.profiler Chrome trace (CPU and CUDA activity) of the first "
             "--profile-batches batches after warmup into this directory")
    add("--profile-batches", type=int, default=20,
        help="batches dispatched before the --profile-dir trace stops")
    add("--frame-size", type=int, nargs=2, default=(256, 256), metavar=("H", "W"))
    add("--parallel", choices=["fused", "pp"], default="fused",
        help="fused: the whole step, the gallery sharded over every card (--device cuda) "
             "or on one (--device cuda:N); pp: two-stage pipeline parallelism, "
             "detector on one half of the cards, embedder + sharded gallery on the "
             "other (an even card count >= 2)")
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
        help="f32 (default): float staging; uint8: frames stage and upload as uint8 "
             "(4x fewer bytes, cast on the card); jpeg: uint8, and the frame topic "
             "takes compressed payloads decoded off the connector thread")
    add("--ingest-ring-depth", type=int, default=0,
        help="pinned staging buffers per dispatch rung; 0 = the in-flight depth + 2. "
             "An exhausted ring rejects intake (reason staging), never allocates")
    add("--ingest-decode-workers", type=int, default=2,
        help="decode threads of --ingest-mode jpeg (a corrupt payload dead-letters "
             "with reason decode_error)")
    add("--transfer-uint8", action="store_true",
        help="deprecated alias of --ingest-mode uint8")
    add("--cascade", metavar="PATH",
        help="stage-1 FaceGate file (FaceGate.save): frames scoring below the threshold "
             "are answered with no faces without the full step (completed_empty)")
    add("--cascade-threshold", type=float, default=None, metavar="P",
        help="stage-1 operating point (default: the gate's own); brownout level >= 1 "
             "raises it one notch")
    add("--no-cascade", action="store_true",
        help="serve single-stage even with a --cascade gate loaded")
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
    add("--max-inflight-frames", type=int, default=0,
        help="admission bound: reject new frames (reason overload) once this many "
             "admitted frames are in the system; bulk frames at 75%% of it. 0 = off")
    add("--rate-limit-fps", type=float, default=0.0,
        help="per-topic token-bucket rate limit (frames/s, a burst of 1 s): frames "
             "above it are rejected (reason rate_limit). 0 = off")
    add("--brownout-queue-wait-ms", type=float, default=0.0,
        help="brownout threshold of the queue-wait EWMA: level 1 sheds half the bulk "
             "frames, level 2 all of them and cuts a batch to the smallest rung; "
             "announced on the status topic. 0 = off")
    add("--shed-stale-after-ms", type=float, default=0.0,
        help="shed a queued frame older than this (reason stale) before it takes a "
             "dispatch slot. 0 = off")
    add("--dead-letter-journal", metavar="PATH",
        help="append lost frames' metadata and reason to this rotating JSONL journal "
             "(read it with python -m opencv_facerecognizer_tpu_torch.runtime.journal)")
    add("--state-dir", metavar="DIR",
        help="durable state: checkpoints, the enrolment WAL, the IVF sidecar and the "
             "registry manifest; recovered at start, checkpointed at SIGTERM")
    add("--embedder-version", type=int, default=0, metavar="N",
        help="the loaded model's embedder version, stamped on results and "
             "identity-cache entries (0 = 1)")
    add("--detector-version", type=int, default=0, metavar="N",
        help="the loaded --detector's registry version: with --state-dir, refuse to "
             "start unless the manifest serves it (0 = adopt the manifest's)")
    add("--cascade-version", type=int, default=0, metavar="N",
        help="the same fence for the --cascade gate")
    add("--registry-swap", metavar="ROLE=VERSION",
        help="perform one fenced registry swap against --state-dir and exit: the "
             "candidate must be staged at STATE_DIR/registry/<role>-v<N>.params; "
             "roles detector, cascade")
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
    add("--journal-fsync", choices=["never", "interval", "always"], default="never",
        help="fsync policy of the dead-letter journal (the WAL always fsyncs)")
    add("--trace-sample", type=float, default=0.0,
        help="share of frames whose spans are recorded (deterministic per arrival "
             "index); lifecycle spans are always recorded when tracing is on")
    add("--trace-ring", type=int, default=4096, help="spans kept per topic ring")
    add("--trace-jsonl", metavar="PATH",
        help="also stream every span as JSONL into this rotating file")
    add("--flight-dir", metavar="DIR",
        help="flight-recorder dumps of the span rings: on a dead-letter, a stall, a "
             "supervisor restart, a critical health verdict and the SIGTERM drain")
    add("--expo-port", type=int, default=None, metavar="PORT",
        help="serve the read-only HTTP exposition (/metrics /prom /health /ledger "
             "/brownout /spans /attribution ...) on this port; 0 picks a free one")
    add("--slo", action="store_true",
        help="run the SLO burn-rate monitor (interactive e2e p99, queue-wait p99, "
             "completion ratio, durability lag, loop liveness): /health, the status "
             "topic with --supervised, one more brownout level when critical")
    add("--slo-interval-s", type=float, default=5.0, help="seconds between evaluations")
    add("--slo-e2e-p99-ms", type=float, default=500.0,
        help="interactive e2e objective: 99%% of interactive frames within this")
    add("--slo-queue-wait-p99-ms", type=float, default=250.0,
        help="queue-wait objective: 99%% of frames leave the queue within this")
    add("--slo-completion-target", type=float, default=0.999,
        help="completion objective: the share of admitted frames that must publish")
    add("--slo-durability-rows", type=int, default=1024,
        help="durability-lag objective: WAL rows not covered by a checkpoint "
             "(needs --state-dir)")
    add("--slo-windows", type=float, nargs=2, default=(60.0, 600.0),
        metavar=("SHORT_S", "LONG_S"),
        help="the two burn-rate windows; a severity needs both to burn")
    add("--replica-role", choices=["writer", "reader"], default="writer",
        help="role on a shared --state-dir. writer (default): takes the writer lease "
             "and owns enrolment (a second writer exits). reader: reads the state dir "
             "only, anchors on its newest checkpoint, tails the WAL between batches and "
             "refuses enrolment (reason read_replica)")
    add("--replica-poll-ms", type=float, default=50.0,
        help="reader: WAL tail poll interval (bounds its staleness)")
    add("--replication-lag-rows", type=int, default=4096,
        help="reader with --slo: the replication-lag objective's bound in unapplied WAL "
             "rows (warn; critical at 6x)")
    add("--router", metavar="HOST:PORT[,HOST:PORT...]",
        help="run as a topic router instead of a recognizer: frames arriving on --source "
             "are spread over these replica endpoints (each a --source socket CLI) by "
             "rendezvous hashing of their topic, with health failover; results and "
             "statuses come back to the source. Loads no model and touches no card")
    add("--router-health", metavar="URL[,URL...]",
        help="each replica's /health URL (--router's order): 503 or unreachable fails "
             "it over; unset = assumed healthy")
    add("--router-budget-fps", type=float, default=0.0,
        help="per-replica token-bucket budget (frames/s): an over-budget topic spills "
             "to its next replica. 0 = none")
    add("--router-writer", type=int, default=0, metavar="IDX",
        help="index into --router of the writer: control traffic goes there only")
    add("--router-link-deadline-s", type=float, default=0.0,
        help="link supervision: a ping per replica per health cycle over the data "
             "link; no pong within this many seconds marks the link down and routes "
             "around it. 0 = off")
    add("--router-hedge-deadline-s", type=float, default=0.0,
        help="an interactive frame with no result after this many seconds is sent "
             "once more to its next replica (same frame id; the loser is deduped). "
             "0 = off")
    add("--router-dedup-window", type=int, default=4096,
        help="frame ids remembered at the router's fan-in, so a duplicated or hedged "
             "result publishes once. 0 = off")
    add("--slo-loop-stale-s", type=float, default=30.0,
        help="loop-liveness objective: seconds without a serving-loop iteration "
             "(warn; critical at 6x). 0 = off")
    return p


def _mesh_devices(device: torch.device) -> list:
    """The devices a mesh is laid over (``--parallel pp``, and ``--parallel
    fused`` unless ``--device`` names one card): every card, or the one CPU
    for ``--device cpu``."""
    if device.type == "cpu":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def pp_layout(n: int) -> tuple:
    """(dp, tp) of ``--parallel pp`` over ``n`` devices: 8 -> (4, 2), halved
    into two (2, 2) stage meshes; below 8, tp 2 would leave each half one
    dp row, so tp stays 1."""
    tp = 2 if n % 4 == 0 and n >= 8 else 1
    return n // tp, tp


def _pp_meshes(args, device: torch.device):
    """(stage A mesh, gallery mesh) of ``--parallel pp``, or the
    reference's refusals (module docstring), raised before any checkpoint
    loads."""
    from opencv_facerecognizer_tpu_torch.parallel.mesh import make_mesh
    from opencv_facerecognizer_tpu_torch.parallel.pp import split_mesh

    if args.fused_embedder:
        raise SystemExit("--fused-embedder applies to --parallel fused only "
                         "(stage-B meshes aren't single-device)")
    if args.match_mode == "ivf":
        raise SystemExit("--match-mode ivf applies to --parallel fused only "
                         "(the two-stage path is single-device, like the "
                         "pallas streaming matcher)")
    if args.cascade:
        raise SystemExit("--cascade applies to --parallel fused only (the "
                         "pipeline-parallel path carries no stage-1 gate)")
    devices = _mesh_devices(device)
    n = len(devices)
    try:
        return split_mesh(make_mesh(*pp_layout(n), devices=devices))
    except ValueError as e:
        raise SystemExit(f"--parallel pp needs an even device count >= 2 (have {n}): "
                         f"{e}; use --parallel fused on this host")


def _fused_mesh(args, device: torch.device):
    """The gallery mesh of ``--parallel fused``: the reference's
    ``make_mesh()`` (dp 1, tp n) over every card of ``_mesh_devices``, or
    None when that is one device or ``--device`` names one card. Refuses
    ``--match-mode ivf`` on a mesh (the reference's text) before any
    checkpoint loads."""
    from opencv_facerecognizer_tpu_torch.parallel.mesh import make_mesh

    if torch.device(args.device).index is not None:
        return None
    devices = _mesh_devices(device)
    if len(devices) < 2:
        return None
    mesh = make_mesh(devices=devices)
    if args.match_mode == "ivf":
        raise SystemExit("--match-mode ivf requires a single-device mesh "
                         f"(got {mesh.size} devices); use "
                         "--match-mode auto/exact on this host")
    return mesh


def _load_stack(args, metrics):
    """Checkpoints, the gallery directory embedded into a gallery, and the
    serving pipeline: ``RecognitionPipeline`` over ``_fused_mesh`` (or on
    ``--device`` alone), or with ``--parallel pp`` a ``TwoStagePipeline``
    over the cards; returns (pipeline, subject names). Logs a ``startup``
    record of its load and embed seconds to ``metrics``' sink."""
    from opencv_facerecognizer_tpu_torch.models.detector import CNNFaceDetector
    from opencv_facerecognizer_tpu_torch.models.embedder import CNNEmbedding
    from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery
    from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline
    from opencv_facerecognizer_tpu_torch.parallel.quantizer import CoarseQuantizer
    from opencv_facerecognizer_tpu_torch.utils import dataset as dataset_utils
    from opencv_facerecognizer_tpu_torch.utils import serialization
    from opencv_facerecognizer_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    mesh_a = gallery_mesh = None
    if args.parallel == "pp":
        mesh_a, gallery_mesh = _pp_meshes(args, device)
    else:
        gallery_mesh = _fused_mesh(args, device)
    t0 = time.perf_counter()
    model = serialization.load_model(args.model, device=device)
    feature = model.feature
    if not isinstance(feature, CNNEmbedding):
        raise SystemExit("--model must be a CNN model checkpoint (CNNEmbedding)")
    detector = CNNFaceDetector.load(args.detector, device=device)
    gate = None
    if args.cascade:
        from opencv_facerecognizer_tpu_torch.models.cascade import FaceGate

        gate = FaceGate.load(args.cascade, device=device)
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
        device=device, embedder_version=args.embedder_version or 1,
        async_grow=args.async_grow, mesh=gallery_mesh)
    gallery.add(emb, labels)
    if mesh_a is not None:
        from opencv_facerecognizer_tpu_torch.parallel.pp import TwoStagePipeline

        return TwoStagePipeline(detector, feature.net, None, gallery, mesh_a,
                                face_size=feature.input_size), names
    if args.match_mode != "exact" and gallery.mesh.size == 1:
        # attached after the startup enrolment: main() runs the one build
        gallery.attach_quantizer(
            CoarseQuantizer(nlist=args.ivf_nlist or CoarseQuantizer.default_nlist(
                gallery.capacity), nprobe=args.ivf_nprobe, auto_nlist=not args.ivf_nlist),
            mode=args.match_mode)
    pipeline = RecognitionPipeline(detector, feature.net, gallery,
                                   face_size=feature.input_size,
                                   fused_embedder=args.fused_embedder, device=device,
                                   cascade=gate)
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


def run_registry_swap(args) -> int:
    """``--registry-swap ROLE=N``: one fenced swap against ``--state-dir``
    under the writer lease, then exit (module docstring)."""
    from opencv_facerecognizer_tpu_torch.runtime.registry import (
        ModelRegistry, _file_sha256, registry_params_path)
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        WriterLease, WriterLeaseHeldError)
    from opencv_facerecognizer_tpu_torch.runtime.state_store import StateLifecycle
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics

    if not args.state_dir:
        raise SystemExit("ocvf-recognize-torch: --registry-swap requires --state-dir")
    role, sep, version = args.registry_swap.partition("=")
    role = role.strip()
    try:
        to_version = int(version)
    except ValueError:
        to_version = 0
    if not sep or role not in ("detector", "cascade") or to_version <= 0:
        raise SystemExit(
            "ocvf-recognize-torch: --registry-swap wants ROLE=VERSION with role in "
            f"(detector, cascade) and a positive integer version, got {args.registry_swap!r}")
    params_path = registry_params_path(args.state_dir, role, to_version)
    if not os.path.exists(params_path):
        raise SystemExit(f"ocvf-recognize-torch: stage the candidate params first — "
                         f"{params_path} does not exist (CNNFaceDetector.save / "
                         f"FaceGate.save to the registry's path)")
    metrics = Metrics()
    lease = WriterLease(args.state_dir, metrics=metrics)
    try:
        lease.acquire()
    except WriterLeaseHeldError as exc:
        raise SystemExit(f"ocvf-recognize-torch: {exc} — stop the writer first (or swap "
                         f"through its live coordinator)")
    try:
        state = StateLifecycle(args.state_dir, metrics=metrics)
        state.attach_registry(ModelRegistry(args.state_dir, metrics=metrics))
        state.adopt_wal_seq()
        try:
            seq = state.perform_registry_cutover(role, to_version, params_path=params_path,
                                                 params_sha256=_file_sha256(params_path))
        except ValueError as exc:
            raise SystemExit(f"ocvf-recognize-torch: {exc}")
        finally:
            state.close()
        print(f"registry swap fenced at WAL seq {seq}; manifest now serves "
              f"{state.registry.stamp()}", file=sys.stderr)
    finally:
        lease.release()
    return 0


def run_router(args) -> int:
    """``--router``: a model-free topic router (module docstring) from
    ``--source`` (socket or JSONL) to the replica endpoints, until the
    input ends or SIGTERM. It imports no model and never touches the
    card."""
    from opencv_facerecognizer_tpu_torch.runtime.connector import (
        WILDCARD_TOPIC, JSONLConnector, SocketConnector)
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import RESULT_TOPIC, STATUS_TOPIC
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        ReplicaHandle, TopicRouter, http_health_probe)
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics
    from opencv_facerecognizer_tpu_torch.utils.tracing import Tracer

    metrics = Metrics()
    tracer = None
    if args.flight_dir or args.expo_port is not None:
        tracer = Tracer(ring_size=args.trace_ring, sample=args.trace_sample,
                        dump_dir=args.flight_dir, metrics=metrics)
    endpoints = [e.strip() for e in args.router.split(",") if e.strip()]
    healths = ([u.strip() or None for u in args.router_health.split(",")]
               if args.router_health else [None] * len(endpoints))
    if len(healths) != len(endpoints):
        raise SystemExit(f"--router-health lists {len(healths)} URLs for {len(endpoints)} "
                         f"--router endpoints")
    if not 0 <= args.router_writer < len(endpoints):
        raise SystemExit(f"--router-writer {args.router_writer} is out of range for "
                         f"{len(endpoints)} endpoints")
    replicas = []
    for i, endpoint in enumerate(endpoints):
        host, _, port = endpoint.rpartition(":")
        try:
            conn = SocketConnector(host=host or "127.0.0.1", port=int(port), listen=False,
                                   metrics=metrics)
            conn.start()  # a replica that was never there is a configuration error
        except (OSError, ValueError) as exc:
            raise SystemExit(f"--router endpoint {endpoint!r}: {exc}")
        replicas.append(ReplicaHandle(
            endpoint, conn, health_fn=http_health_probe(healths[i]) if healths[i] else None,
            budget_fps=args.router_budget_fps or None, writer=i == args.router_writer))
    router = TopicRouter(replicas, metrics=metrics, tracer=tracer,
                         link_deadline_s=args.router_link_deadline_s or None,
                         hedge_deadline_s=args.router_hedge_deadline_s or None,
                         dedup_window=args.router_dedup_window)
    slo_monitor = None
    if args.slo and args.router_link_deadline_s:
        from opencv_facerecognizer_tpu_torch.runtime.slo import (
            SLOMonitor, link_health_objective)

        # the router's /health speaks for the links, not for a model
        slo_monitor = SLOMonitor(metrics, [link_health_objective(router.down_link_fraction)],
                                 tracer=tracer)
    if args.source == "socket":
        upstream = SocketConnector(host=args.host, port=args.port, listen=True,
                                   metrics=metrics)
    else:
        upstream = JSONLConnector(sys.stdin, sys.stdout, metrics=metrics)
    upstream.subscribe(WILDCARD_TOPIC, lambda topic, msg: router.publish(topic, msg))
    for topic in (RESULT_TOPIC, STATUS_TOPIC):
        router.subscribe(topic, lambda _t, msg, _up=topic: upstream.publish(_up, msg))
    expo = None
    if args.expo_port is not None:
        from opencv_facerecognizer_tpu_torch.runtime.expo import ExpoServer

        expo = ExpoServer(metrics=metrics, tracer=tracer, router=router, slo=slo_monitor,
                          port=args.expo_port)
        expo.start()
        print(f"router expo endpoint: http://{expo.host}:{expo.port}/", file=sys.stderr)
    term_event = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda signum, frame: term_event.set())
    except ValueError:
        pass  # not the main thread
    router.start()
    upstream.start()
    if args.source == "socket":
        print(f"serving on {args.host}:{upstream.port}", file=sys.stderr)
    print(f"routing {len(replicas)} replicas: {', '.join(endpoints)}", file=sys.stderr)
    try:
        while not upstream.eof.wait(timeout=0.5):
            if term_event.is_set():
                break
            _redial(router, metrics)
    except KeyboardInterrupt:
        pass
    finally:
        if expo is not None:
            expo.stop()
        upstream.stop()
        router.stop()
        for handle in router.replicas():
            handle.connector.stop()
        print(f"router metrics: {json.dumps(metrics.counters(), sort_keys=True)}",
              file=sys.stderr)
        print(f"router registry at shutdown: {json.dumps(router.registry())}",
              file=sys.stderr)
        print(f"router holds a CUDA context: {torch.cuda.is_initialized()}", file=sys.stderr)
    return 0


def _redial(router, metrics) -> None:
    """Dial again each replica whose connector spent its reconnect budget
    (a restart that outlasted the backoff) and hand the router the new
    connector (``replace_connector``); an endpoint still down is tried at
    the next call (ROADMAP C.16)."""
    from opencv_facerecognizer_tpu_torch.runtime.connector import SocketConnector

    for handle in router.replicas():
        old = handle.connector
        if not old.eof.is_set():
            continue
        conn = SocketConnector(host=old.host, port=old.port, listen=False, metrics=metrics)
        try:
            conn.start()
        except OSError:
            continue
        router.replace_connector(handle.name, conn)
        old.stop()
        print(f"router: replica {handle.name} dialled again", file=sys.stderr)


def _open_reader(args, pipeline, names, metrics, tracer=None):
    """A read replica of ``--state-dir`` (no lease, nothing written): the
    first resync into the pipeline's gallery and ``names`` (raising when
    it fails), the ``--embedder-version`` fence, the read-only registry
    and its fence, and the installer of the weights a registry re-anchor
    moves to. Returns the ``ReadReplica``."""
    from opencv_facerecognizer_tpu_torch.runtime.registry import ModelRegistry
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        ReadReplica, pipeline_model_installer)

    replica = ReadReplica(args.state_dir, pipeline.gallery, names, metrics=metrics,
                          tracer=tracer, poll_interval_s=args.replica_poll_ms / 1e3)
    t0 = time.perf_counter()
    report = replica.resync()
    print(f"replica initial sync: {report}", file=sys.stderr)
    metrics.log("resync", seconds=time.perf_counter() - t0, stages=replica.last_resync_s,
                checkpoint=report["checkpoint"], applied_rows=report["applied_rows"],
                gallery_size=int(pipeline.gallery.size))
    if args.embedder_version and replica.embedder_version != args.embedder_version:
        raise SystemExit(
            f"ocvf-recognize-torch: --embedder-version {args.embedder_version} declared but "
            f"the state dir's checkpoint serves embedder v{replica.embedder_version}: a "
            f"reader never mixes versions; start the matching model (or wait for the "
            f"writer's cutover checkpoint)")
    replica.registry = ModelRegistry(args.state_dir, metrics=metrics, readonly=True)
    _registry_fence(replica.registry, args)
    replica.install_model = pipeline_model_installer(pipeline)
    return replica


def _open_state(args, pipeline, names, metrics, tracer=None):
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
                           checkpoint_every_s=args.checkpoint_every_s, tracer=tracer)
    t0 = time.perf_counter()
    report = state.recover(pipeline.gallery, names)
    recover_s = time.perf_counter() - t0
    print(f"state recovery: {report}", file=sys.stderr)
    recovered_version = int(report.get("embedder_version", 1))
    if args.embedder_version and recovered_version != args.embedder_version:
        # a pending cutover to the declared version was completed inside
        # recover() and matches here; anything else would serve mixed spaces
        raise SystemExit(
            f"ocvf-recognize-torch: --embedder-version {args.embedder_version} declared but "
            f"recovery landed on embedder v{recovered_version} — refusing to serve mixed "
            f"spaces. Roll the new embedder out via the staged re-embed (runtime.rollout: "
            f"stage + parity gate + cutover), or start the matching model")
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
    DurabilityMonitor(state, metrics=metrics, tracer=tracer,
                      probe_interval_s=args.durability_probe_s,
                      low_watermark_bytes=int(args.disk_low_watermark * (1 << 20)))
    return state


def _metrics_window(args):
    """(window_s, slices) of the latency windows: with ``--slo`` the
    rolling horizon covers the longest SLO window and a slice the
    shortest, as the reference sizes them."""
    window_s, slices = 600.0, 20
    if args.slo:
        window_s = max(window_s, *args.slo_windows)
        slices = min(960, max(20, int(math.ceil(
            window_s / max(1e-3, min(30.0, min(args.slo_windows)))))))
    return window_s, slices


def _build_tracer(args, metrics):
    """(tracer, span journal): a tracer whenever any observability
    surface is asked for, else (None, None)."""
    from opencv_facerecognizer_tpu_torch.utils.tracing import Tracer, make_span_journal

    if not (args.trace_sample > 0 or args.flight_dir or args.trace_jsonl
            or args.expo_port is not None):
        return None, None
    span_journal = (make_span_journal(args.trace_jsonl, metrics=metrics)
                    if args.trace_jsonl else None)
    return Tracer(ring_size=args.trace_ring, sample=args.trace_sample,
                  dump_dir=args.flight_dir, span_sink=span_journal,
                  metrics=metrics), span_journal


def _build_slo(args, metrics, state, tracer):
    from opencv_facerecognizer_tpu_torch.runtime.slo import (
        SLOMonitor, default_objectives, disk_free_objective)
    from opencv_facerecognizer_tpu_torch.utils.metrics import LEDGER_DROP_COUNTERS

    short_s, long_s = args.slo_windows
    monitor = SLOMonitor(metrics, default_objectives(
        drop_counters=LEDGER_DROP_COUNTERS, state=state,
        e2e_p99_s=args.slo_e2e_p99_ms / 1e3,
        queue_wait_p99_s=args.slo_queue_wait_p99_ms / 1e3,
        completion_target=args.slo_completion_target,
        durability_rows=args.slo_durability_rows, short_s=short_s, long_s=long_s),
        tracer=tracer, interval_s=args.slo_interval_s)
    dur = None if state is None else state.durability
    if dur is not None and dur.low_watermark_bytes:
        monitor.add_objective(disk_free_objective(dur.free_bytes, dur.low_watermark_bytes,
                                                  short_s=short_s, long_s=long_s))
    return monitor


def _serving_counts(pipeline) -> dict:
    """The kernels' launches so far (graph replays included) and the step
    cache's captures; the ``shutdown`` record carries them as counted
    after warmup (``warm``) and at the end."""
    from opencv_facerecognizer_tpu_torch.ops.nms import nms_mask
    from opencv_facerecognizer_tpu_torch.ops.sepblock import fused_sep_block
    from opencv_facerecognizer_tpu_torch.ops.streaming_match import streaming_match_topk

    return {"launches": {"streaming_match": getattr(streaming_match_topk, "launches", 0),
                         "sepblock": getattr(fused_sep_block, "launches", 0),
                         "nms": getattr(nms_mask, "launches", 0)},
            "captures": getattr(pipeline, "captures", 0),
            "recaptures": getattr(pipeline, "recaptures", 0),
            "cascade_captures": getattr(pipeline, "cascade_captures", 0)}


class _Profile:
    """``--profile-dir``: ``torch.profiler`` (CPU, and CUDA on the card)
    from after warmup until ``--profile-batches`` batches were dispatched
    or the process stops, written as a Chrome trace. A replayed CUDA
    graph is one launch on the host side; its kernels show on the card's
    timeline."""

    def __init__(self, args, device, metrics):
        self.dir = args.profile_dir
        self.batches = args.profile_batches
        self.metrics = metrics
        self.prof = None
        if not self.dir:
            return
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def stop_if_due(self) -> None:
        from opencv_facerecognizer_tpu_torch.utils.metrics import BATCHES_DISPATCHED

        if self.prof is not None and self.metrics.counter(BATCHES_DISPATCHED) >= self.batches:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        prof.stop()
        path = os.path.join(self.dir, f"trace-{os.getpid()}.json")
        prof.export_chrome_trace(path)
        print(f"profile trace written to {path}", file=sys.stderr)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.registry_swap:
        return run_registry_swap(args)
    if not (args.model and args.detector and args.gallery):
        parser.error("the following arguments are required: --model, --detector, --gallery "
                     "(only --registry-swap runs without a serving stack)")
    if args.router:
        return run_router(args)
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

    from opencv_facerecognizer_tpu_torch.runtime.admission import AdmissionController
    from opencv_facerecognizer_tpu_torch.runtime.journal import DeadLetterJournal
    from opencv_facerecognizer_tpu_torch.runtime.resilience import BrownoutPolicy
    from opencv_facerecognizer_tpu_torch.runtime.slo import loop_liveness_objective

    from opencv_facerecognizer_tpu_torch.runtime.ingest import (
        IngestConfig, resolve_ingest_mode)

    ingest = IngestConfig(mode=resolve_ingest_mode(args.ingest_mode, args.transfer_uint8),
                          ring_depth=args.ingest_ring_depth or None,
                          decode_workers=args.ingest_decode_workers)
    metrics_sink = open(args.metrics_jsonl, "a") if args.metrics_jsonl else None
    window_s, window_slices = _metrics_window(args)
    metrics = Metrics(sink=metrics_sink, window_s=window_s, window_slices=window_slices)
    tracer, span_journal = _build_tracer(args, metrics)
    journal = (DeadLetterJournal(args.dead_letter_journal, metrics=metrics,
                                 fsync=args.journal_fsync)
               if args.dead_letter_journal else None)
    lease = state = replica = None
    reader = bool(args.state_dir) and args.replica_role == "reader"
    try:
        if args.state_dir and not reader:
            # one writer per state dir, taken before anything is loaded or
            # touched: a second writer fails closed with no side effects
            lease = WriterLease(args.state_dir, metrics=metrics)
            try:
                lease.acquire()
            except WriterLeaseHeldError as exc:
                raise SystemExit(f"ocvf-recognize-torch: {exc}")
        pipeline, names = _load_stack(args, metrics)
        if reader:
            replica = _open_reader(args, pipeline, names, metrics, tracer)
        elif args.state_dir:
            state = _open_state(args, pipeline, names, metrics, tracer)
    except BaseException:
        if lease is not None:
            lease.release()
        for sink in (journal, span_journal):
            if sink is not None:
                sink.close()
        if metrics_sink:
            metrics_sink.close()
        raise
    if state is not None:
        # the lenient sinks shed while durability is degraded
        state.durability.attach_sinks(journal=journal, span_sink=span_journal, tracer=tracer)
    quantizer = pipeline.gallery.quantizer
    if quantizer is not None:
        quantizer.metrics = metrics
        quantizer.tracer = tracer
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
    admission = None
    if args.max_inflight_frames > 0 or args.rate_limit_fps > 0:
        admission = AdmissionController(max_inflight_frames=args.max_inflight_frames or None,
                                        rate_limit_fps=args.rate_limit_fps or None)
    brownout = (BrownoutPolicy(queue_wait_s=args.brownout_queue_wait_ms / 1e3)
                if args.brownout_queue_wait_ms > 0 else None)
    slo_monitor = _build_slo(args, metrics, state, tracer) if args.slo else None
    service = RecognizerService(
        pipeline, connector, batch_size=args.batch_size,
        frame_shape=tuple(args.frame_size), flush_timeout=args.flush_ms / 1e3,
        similarity_threshold=args.similarity_threshold, subject_names=names,
        metrics=metrics, ingest=ingest,
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
        tracker=tracker, state_store=state, admission=admission, brownout=brownout,
        dead_letter_journal=journal,
        shed_stale_after_s=(args.shed_stale_after_ms / 1e3
                            if args.shed_stale_after_ms > 0 else None),
        tracer=tracer, slo_monitor=slo_monitor, cascade=not args.no_cascade,
        cascade_threshold=args.cascade_threshold, replica=replica)
    if state is not None:
        service.registry = state.registry
    if replica is not None:
        # the replica grows the names the service publishes (ROADMAP C.16)
        service.subject_names = names
        service.registry = replica.registry
        replica.on_registry_change = service.flush_model_caches
        if slo_monitor is not None:
            from opencv_facerecognizer_tpu_torch.runtime.slo import replication_lag_objective

            short_s, long_s = args.slo_windows
            slo_monitor.add_objective(replication_lag_objective(
                replica, rows_bound=args.replication_lag_rows, short_s=short_s,
                long_s=long_s))
    if slo_monitor is not None and args.slo_loop_stale_s > 0:
        short_s, long_s = args.slo_windows
        slo_monitor.add_objective(loop_liveness_objective(
            service, stale_s=args.slo_loop_stale_s, short_s=short_s, long_s=long_s))
    supervisor = ServiceSupervisor(service, state=state) if args.supervised else None
    expo = None
    if args.expo_port is not None:
        from opencv_facerecognizer_tpu_torch.runtime.expo import ExpoServer

        expo = ExpoServer(service, tracer=tracer, metrics=metrics, port=args.expo_port)
        expo.start()
        print(f"expo endpoint: http://{expo.host}:{expo.port}/", file=sys.stderr)
    if supervisor is not None:
        supervisor.start()
    else:
        service.start()
    warm_counts = _serving_counts(pipeline)
    # after warmup (the trace shows serving, not the captures) and before
    # the port is announced (its start stalls the process for a while)
    profile = _Profile(args, pipeline.device, metrics)
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
                profile.stop_if_due()
                time.sleep(0.005)
            results = connector.messages(RESULT_TOPIC)
            metrics.log("dir_replay", files=len(files), answered=len(results),
                        seconds=time.perf_counter() - t0)
            for message in results:
                print(json.dumps(message))
        else:
            # until the input ends (stdin EOF), SIGTERM or Ctrl-C; then every
            # accepted frame finishes and publishes before the teardown
            while not connector.eof.wait(timeout=0.05 if profile.active else 0.5):
                profile.stop_if_due()
                if term_event.is_set():
                    print("SIGTERM: draining before shutdown", file=sys.stderr)
                    break
            service.drain()
    except KeyboardInterrupt:
        interrupted = True
    finally:
        profile.stop()
        if expo is not None:
            expo.stop()
        shutdown = graceful_shutdown(service, state=state, supervisor=supervisor,
                                     drain_timeout=0.0 if interrupted else 30.0)
        if shutdown.get("flight_dump"):
            print(f"flight-recorder dump: {shutdown['flight_dump']}", file=sys.stderr)
        if state is not None:
            print(f"final checkpoint: "
                  f"{'written' if shutdown['final_checkpoint'] else 'FAILED (previous kept)'}",
                  file=sys.stderr)
        summary = metrics.summary()
        metrics.log("shutdown", ledger=shutdown["ledger"], summary=summary,
                    clean=shutdown["clean"], warm=warm_counts, **_serving_counts(pipeline))
        if summary:
            print(f"metrics: {summary}", file=sys.stderr)
        if shutdown["ledger"]["admitted"]:
            print(f"admission ledger: {shutdown['ledger']}", file=sys.stderr)
        print(f"shutdown: {'clean' if shutdown['clean'] else 'NOT clean'}", file=sys.stderr)
        for sink in (journal, span_journal):
            if sink is not None:
                sink.close()
        if lease is not None:
            lease.release()  # last: the final checkpoint ran under it
        if metrics_sink:
            metrics_sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
