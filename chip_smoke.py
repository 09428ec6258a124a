#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--frames N]

Phases (any failure exits nonzero before the result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``opencv_facerecognizer_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and print each kernel
   instantiation's registers, spills and barriers from ``-Xptxas -v``;
3. hold each kernel against its plain PyTorch version on the card:
   the streaming match (kernel A) at Q = 512, D = 256, N = 2^20 bf16 with
   duplicate and invalid rows at k = 1, 5, 16, 17 and 64, on ragged
   galleries that end mid-tile (bf16 and f32, D = 256 and 64, fewer valid
   rows than k), and on the 2^20-row gallery stored in f32; the fused
   separable block (kernel B) at the six serving block shapes, bf16 and
   f32, at B = 512, 37 and 601 (more than two samples per persistent CTA;
   these must also equal the same samples run one per CTA, bit for bit),
   and at blocks with F = 48 and 96 (OTHER_BLOCKS). Time each at the
   serving shape: the wrapper's time by CUDA events around eager calls,
   host work included (``ms``), the kernel's device time from a CUDA
   graph of back-to-back calls (``device_ms``), its plain version and one
   PyTorch call computing the same function;
4. serve: a ``RecognizerService`` over ``FakeConnector`` with the serving
   detector and embedder (random weights from ``--seed``), a 2^20-row
   bf16 gallery, batches of 32 256x256 uint8 frames and the fused
   embedder. Every frame must get one result, both kernels' launch counts
   must rise during the run, and the faces of the first batch must find
   their own planted gallery rows; the first batch through the same stack
   in f32 must agree with the CPU (smaller gallery; see XCHECK_*);
5. time the steady-state serving step, fused and unfused embedder in
   turns, and profile it (device time by kernel, the card's busy share);
6. IVF: the same 2^20 rows in a gallery with a ``CoarseQuantizer``
   attached in mode ``"auto"`` (``default_nlist``, ``nprobe`` 8), as the
   reference's recognizer serves such a gallery. Build it (nlist,
   max_cell, spill, the lists' device bytes, the build's stages), enrol the
   first batch's faces after the build (the incremental path), hold the
   two-stage match with kernel A as the rerank against the same match
   with the plain rerank at Q = 512 and 32, k = 1 and 5, serve the frames
   again (one result each, planted rows found, kernel A launched, every
   step through the IVF path), time the serving step through IVF, time
   ``gallery.match`` through IVF (split into stage 1, bucket, rerank) and
   through the exact kernel at Q = 512 down to 16 on 2^18, 2^20 and 2^22
   rows, print the two-stage recall against the exact scan at 2^20, and
   run the reference's ``bench.py --ivf-smoke`` recall gate (>= 0.99).
   Its numbers are one ``{"ivf": ...}`` line;
7. cli: the serving detector and embedder (the weights of phase 4) written
   by the port's ``CNNFaceDetector.save`` and ``save_model`` (a
   ``CNNEmbedding`` in ``PredictableModel(..., NearestNeighbor(
   CosineDistance()))``), a gallery directory and a frames directory of
   PGM images (``build/cli_smoke/``); ``apps.recognize.main`` in dir mode
   on them with a 2^20-row gallery, the exact match and the fused
   embedder. Every frame must get one result, both kernels must launch,
   the first batch must agree with a direct ``RecognitionPipeline`` call
   on the loaded weights (XCHECK_*) and the ledger must close. Then the
   CLI in jsonl mode in a subprocess (``python -m``): frames, an
   ``enroll`` command, frames of one scene until ``enrolled`` comes back,
   more frames of that scene (which must come back with the enrolled
   name), ``stats``, EOF. Its numbers are one ``{"cli": ...}`` line,
   each time with the card's name and power limit: the load and embed
   seconds as the CLI's own loader logs them (the ``startup`` record of
   ``--metrics-jsonl``), and the dir run's frames/s and the jsonl run's
   latencies, which are smoke observations (64 frames in two batches,
   about 20 requests, a gallery of 8-10 rows) and no measure of
   throughput or latency.
8. durability: phase 4's stack over phase 6's IVF gallery (2^20 bf16 rows,
   its built quantizer) with a ``StateLifecycle`` (``build/state_smoke/``,
   ``keep_checkpoints`` 2, WAL fsync ``always``) attached to a
   ``RecognizerService``: the first checkpoint, 4 subjects enrolled
   through the control topic (the first grows the gallery to 2^21 rows),
   a forced checkpoint (2 GiB in flax's chunked form, and the IVF
   sidecar), 2 more subjects (WAL only), then a "crash" (the WAL closed,
   no shutdown, no checkpoint) and ``recover`` into a fresh gallery with a
   fresh quantizer. The recovery must report the checkpoint, 2 replayed
   records and the loaded sidecar, and give host mirrors, size, capacity
   and names equal to the crashed service's, and ``gallery.match`` (Q =
   512, k = 1 and 5) equal indices and sims through kernel A on the exact
   path and through the two-stage path. Then the frames again through the
   recovered gallery under ``ServiceSupervisor`` in three waves: a result
   subscriber raising once (the readback worker dies), then a state tick
   raising once with a batch in hand (the dispatch loop dies and settles
   that batch as crashed drops): two restarts, one result per frame
   outside that batch, a ledger that closes, the planted faces found,
   both kernels launched after the restarts. Then the CLI with
   ``--state-dir``: enrol and SIGKILL; a second writer refused while the
   first lives; a restart names the subject (WAL replay); SIGTERM exits
   0 with a clean report; a third start recovers that checkpoint with
   nothing to replay and names the subject. Its numbers are one ``{"durability": ...}`` line: checkpoint
   and recovery seconds by stage, bytes, peak host RSS, WAL append p50 /
   max and the CLI's startup seconds, with the card's name and power
   limit; smoke observations, not measurements.

The line before the last is the per-kernel JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.apps import recognize as recognize_app
from opencv_facerecognizer_tpu_torch.models import detector as detector_mod
from opencv_facerecognizer_tpu_torch.models import embedder as embedder_mod
from opencv_facerecognizer_tpu_torch.models.classifier import NearestNeighbor
from opencv_facerecognizer_tpu_torch.models.model import PredictableModel
from opencv_facerecognizer_tpu_torch.ops.distance import CosineDistance
from opencv_facerecognizer_tpu_torch.ops import _build
from opencv_facerecognizer_tpu_torch.ops.ivf_match import (
    gather_bucket, ivf_match_topk, shortlist_cells, tie_aware_agreement)
from opencv_facerecognizer_tpu_torch.ops.sepblock import (
    fused_sep_block, fused_sep_block_plain)
from opencv_facerecognizer_tpu_torch.ops.sepblock import launch_info as sepblock_launch_info
from opencv_facerecognizer_tpu_torch.ops.streaming_match import (
    NEG_INF, match_smem_bytes, streaming_match_topk, streaming_match_topk_plain)
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery
from opencv_facerecognizer_tpu_torch.parallel.pipeline import (
    RecognitionPipeline, unpack_result)
from opencv_facerecognizer_tpu_torch.parallel.quantizer import CoarseQuantizer
from opencv_facerecognizer_tpu_torch.runtime.connector import (
    FakeConnector, encode_frame)
from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
    CONTROL_TOPIC, FRAME_TOPIC, RESULT_TOPIC, STATUS_TOPIC, RecognizerService)
from opencv_facerecognizer_tpu_torch.runtime.resilience import ServiceSupervisor
from opencv_facerecognizer_tpu_torch.runtime.state_store import StateLifecycle
from opencv_facerecognizer_tpu_torch.utils import dataset as dataset_utils
from opencv_facerecognizer_tpu_torch.utils import native, serialization
from opencv_facerecognizer_tpu_torch.utils.metrics import (
    BATCHES_DISPATCHED, FRAMES_DROPPED_CRASHED, IVF_INCREMENTAL_ROWS, LOOP_CRASHES,
    SUPERVISOR_RESTARTS, Metrics)

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

GALLERY_ROWS = 1 << 20
DIM = 256
BATCH = 32
FRAME = (256, 256)
MAX_FACES = 16
#: the untrained detector's head biases. The heatmap's (flax init: -4)
#: keeps every score below the 0.3 threshold; 0 lets it report faces. The
#: size head's (init 0) gives boxes of ~0 px, whose crops are near-constant
#: and embed alike; 3 cells (~24 px) gives distinct crops, so each face's
#: embedding is told apart from the others' (measured on the CPU: cos to
#: any other face <= 0.91, to itself >= 0.999).
HEATMAP_BIAS = 0.0
SIZE_BIAS = 3.0
#: kernel A: f32 sums of the same bf16 products in another order
MATCH_ATOL = 1e-4
#: kernel A's k checked at the serving shape: the serving top-1, the
#: one-pass lists (5, 16) and the multi-pass k (17, 64, and 300: 19 passes)
MATCH_KS = (1, 5, 16, 17, 64, 300)
#: kernel B: bf16 outputs; the kernel and the plain version may round an
#: intermediate to neighbouring bf16 values: two bf16 ulps of the output
SEP_RTOL = 2.0 ** -6
#: the six (H, W, C, F, stride) blocks of the serving embedder at 64x64
SERVING_BLOCKS = [(32, 32, 32, 64, 2), (16, 16, 64, 64, 1),
                  (16, 16, 64, 128, 2), (8, 8, 128, 128, 1),
                  (8, 8, 128, 256, 2), (4, 4, 256, 256, 1)]
#: other (H, W, C, F, stride) blocks the kernel takes, F / 8 not a multiple
#: of 8 (F = 48, 96), stride 1 and 2: checked, not timed
OTHER_BLOCKS = [(32, 32, 32, 48, 2), (16, 16, 48, 48, 1), (16, 16, 48, 96, 2),
                (8, 8, 96, 96, 1), (16, 16, 96, 96, 1)]
#: kernel B's batches: the serving 512, fewer samples than CTAs (37), and
#: more than two per CTA of a full grid (601); none a multiple of the grid
SEP_BATCHES = (512, 37, 601)
#: CPU cross-check: the first batch through the same stack computing in
#: f32 on the card and on the CPU (in bf16 the two devices' convolutions
#: round at other points, so detection decisions near a boundary differ
#: often; the bf16 serving path is held by the planted-row check and by
#: phase 3). In f32 the devices differ by f32 noise (~1e-6): boxes within
#: XCHECK_BOX_PX, sims within XCHECK_SIM. A face kept on one device only is
#: allowed only as a boundary swap: its score within XCHECK_SCORE of the
#: 0.3 threshold or of the lowest kept score (all 16 slots full), or its
#: IoU with a kept box within XCHECK_IOU of the NMS threshold. Swaps are
#: counted and printed; any other difference fails the run.
XCHECK_BOX_PX = 0.05
XCHECK_SIM = 1e-3
XCHECK_SCORE = 1e-3
XCHECK_IOU = 1e-3
#: IVF phase: the reference recognizer's quantizer (``--match-mode auto``:
#: nprobe 8, nlist from the row count); the query batches checked (the
#: serving batch's 512 face slots, and 32) and timed (down to one frame's
#: 16 slots); k checked; the other gallery sizes timed, match alone (the
#: reference's IVF threshold 2^18, and 2^22); the queries' noise
#: (perturbed gallery rows)
IVF_NPROBE = 8
IVF_QS = (512, 32)
IVF_TIME_QS = (512, 128, 32, 16)
IVF_KS = (1, 5)
IVF_OTHER_ROWS = (1 << 18, 1 << 22)
IVF_QUERY_NOISE = 0.05
#: the reference's ``bench.py --ivf-smoke`` recall gate: rows, dim, nlist,
#: nprobe, data seed, queries, quantizer seed, k-means iterations and
#: sample; the two-stage top-1 must agree with the exact scan (modulo
#: ties) on at least IVF_SMOKE_RECALL of the queries
IVF_SMOKE = dict(rows=16384, dim=64, nlist=128, nprobe=8, seed=11, n_q=64,
                 quantizer_seed=5, kmeans_iters=8, train_sample=8192)
IVF_SMOKE_RECALL = 0.99
#: cli phase: gallery subjects and images each (64x64 PGM), frames of the
#: dir run (two serving batches), the gallery capacity (kernel A's path),
#: frames of the jsonl run before and after the enroll command, the
#: enrolled subject's name
CLI_SUBJECTS = 4
CLI_IMAGES = 2
CLI_FRAMES = 2 * BATCH
CLI_CAPACITY = 1 << 20
CLI_JSONL_FRAMES = 8
CLI_ENROL_COUNT = 2
CLI_NEW_NAME = "enrolled_subject"
#: durability phase: subjects enrolled before the forced checkpoint and
#: after it (WAL only), crops each, the match's query batch and k
DUR_SUBJECTS_CHECKPOINTED = 4
DUR_SUBJECTS_WAL = 2
DUR_ENROL_COUNT = 2
DUR_Q = 512
DUR_KS = (1, 5)

def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` in ms: CUDA events around ``iters`` eager runs
    after ``warmup`` runs (host work between launches included)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Device time of one ``fn`` in ms: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events (no host work
    between the launches)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def log_ptxas(name: str) -> None:
    """One line per kernel instantiation from the build's ``-Xptxas -v``
    output: registers, barriers, spill stores/loads (dynamic shared memory
    is per launch and is logged with each kernel's timing)."""
    entry, spills = None, ""
    for line in _build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            entry = _demangle(line.split("'")[1])
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and entry:
            log(f"  ptxas {entry}: {line.split('info    :')[-1].strip()}; {spills}")
            entry, spills = None, ""


def _demangle(symbol: str) -> str:
    """The kernel's name and template arguments, e.g.
    ``sepblock_kernel<__nv_bfloat16, 256, 8, 8>``."""
    try:
        text = subprocess.run(["c++filt", symbol], capture_output=True, text=True,
                              timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    text = text.replace("(anonymous namespace)::", "").removeprefix("void ")
    return text.split("(")[0] or symbol


def _match_case(q, g, valid, k, what: str) -> float:
    """Kernel A against its plain version; returns the max sim error."""
    got_v, got_i = streaming_match_topk(q, g, valid, k=k)
    want_v, want_i = streaming_match_topk_plain(q, g, valid, k=k)
    torch.cuda.synchronize()
    err = (got_v - want_v).abs().max().item()
    beyond_ties = ((got_i != want_i) & ((got_v - want_v).abs() > MATCH_ATOL)).sum().item()
    sentinels_ok = torch.equal(got_i == -1, want_i == -1) and bool(
        (got_v[got_i == -1] == NEG_INF).all())
    if err > MATCH_ATOL or beyond_ties or not sentinels_ok:
        raise AssertionError(f"kernel A {what} k={k}: max sim err {err}, {beyond_ties} index "
                             f"mismatches beyond ties, sentinels equal: {sentinels_ok}")
    log(f"kernel A {what} k={k} ({streaming_match_topk.last_path} path): max |sim - plain| "
        f"{err:.3e}, index agreement {(got_i == want_i).float().mean().item():.6f}")
    return err


def check_match(dev, gen) -> dict:
    """Kernel A vs its plain version; returns the kernel's JSON entry
    fields measured here."""
    q = torch.randn(512, DIM, generator=gen)
    g = torch.randn(GALLERY_ROWS, DIM, generator=gen)
    q = q / q.norm(dim=1, keepdim=True)
    g = g / g.norm(dim=1, keepdim=True)
    g[4096:8192] = g[0:4096]            # duplicate rows: ties
    g[100000:100512] = q                # planted queries ...
    g[900000:900512] = q                # ... twice: exact ties at 1.0
    valid = torch.rand(GALLERY_ROWS, generator=gen) > 0.05
    valid[100000:100256] = False        # half the first plants invalid
    valid[900000:900512] = True
    q, g, valid = q.to(dev), g.to(dev, torch.bfloat16), valid.to(dev)
    planted = torch.where(valid[100000:100512], 100000, 900000) + torch.arange(512, device=dev)
    max_err = 0.0
    for k in MATCH_KS:
        max_err = max(max_err, _match_case(q, g, valid, k, "serving shape"))
        got_i = streaming_match_topk(q, g, valid, k=k)[1]
        if not torch.equal(got_i[:, 0].long(), planted):
            raise AssertionError(f"kernel A k={k}: planted rows not found at the lowest index")
    # ragged galleries: N one row past a tile, below one tile; fewer valid
    # rows than k
    for n, d, gdt in ((70001, DIM, torch.bfloat16), (70001, DIM, torch.float32),
                      (301, 64, torch.bfloat16), (301, 64, torch.float32)):
        q2 = torch.randn(37, d, generator=gen)
        g2 = torch.randn(n, d, generator=gen)
        q2 = (q2 / q2.norm(dim=1, keepdim=True)).to(dev)
        g2 = (g2 / g2.norm(dim=1, keepdim=True)).to(dev, gdt)
        v2 = (torch.rand(n, generator=gen) > 0.2).to(dev)
        for k in (1, 17):
            max_err = max(max_err, _match_case(q2, g2, v2, k, f"ragged N={n} D={d} {gdt}"))
        v3 = torch.zeros(n, dtype=torch.bool, device=dev)
        v3[[3, n // 2, n - 1]] = True
        max_err = max(max_err, _match_case(q2, g2, v3, 5, f"3 valid rows N={n} D={d} {gdt}"))
    # the same 2^20 rows stored in f32 (the gallery's default store dtype)
    g32 = g.float()
    for k in (1, 5):
        max_err = max(max_err, _match_case(q, g32, valid, k, "f32 gallery"))
    f32_ms = cuda_ms(lambda: streaming_match_topk(q, g32, valid, k=1), iters=5)
    f32_dev = graph_ms(lambda: streaming_match_topk(q, g32, valid, k=1), iters=5)
    log(f"kernel A f32 gallery (Q=512, D=256, N=2^20, k=1, "
        f"{streaming_match_topk.last_path} path): {f32_ms:.4f} ms eager with events, "
        f"{f32_dev:.4f} ms device time")
    del g32

    k = 1  # the serving top_k
    ms = cuda_ms(lambda: streaming_match_topk(q, g, valid, k=k))
    device_ms = graph_ms(lambda: streaming_match_topk(q, g, valid, k=k))
    for kk in MATCH_KS[1:]:
        log(f"kernel A k={kk} at the serving shape: "
            f"{cuda_ms(lambda: streaming_match_topk(q, g, valid, k=kk), iters=5):.4f} ms "
            f"eager with events, "
            f"{graph_ms(lambda: streaming_match_topk(q, g, valid, k=kk), iters=3):.4f} ms "
            f"device time")
    plain_ms = cuda_ms(lambda: streaming_match_topk_plain(q, g, valid, k=k), iters=3, warmup=1)
    qb = q.to(torch.bfloat16)

    def library():
        s = torch.matmul(qb, g.T)
        return torch.topk(torch.where(valid, s, torch.finfo(s.dtype).min), k)

    library_ms = cuda_ms(library, iters=5, warmup=1)
    nbytes = q.numel() * 4 + g.numel() * 2 + valid.numel() + q.shape[0] * k * 8
    flops = 2 * q.shape[0] * GALLERY_ROWS * DIM
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    log(f"kernel A k=1 serving shape ({streaming_match_topk.last_path} path, "
        f"{match_smem_bytes(DIM, 1, streaming_match_topk.last_path)} B shared memory per CTA): "
        f"{ms:.4f} ms eager with events, {device_ms:.4f} ms device time, "
        f"plain {plain_ms:.4f}, matmul + topk {library_ms:.4f}, bound {bound:.4f}")
    return dict(name="streaming_match", route="cuda",
                source="opencv_facerecognizer_tpu_torch/csrc/streaming_match.cu",
                replaces="opencv_facerecognizer_tpu/ops/pallas_match.py:99",
                max_abs_err=max_err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS
                else "operations", library_ms=library_ms)


def _sep_args(gen, c, f, stride, dev):
    blk = embedder_mod._SepBlock(c, f, stride)
    with torch.no_grad():
        blk.dw.weight.copy_(torch.randn(c, 1, 3, 3, generator=gen) * 0.3)
        blk.pw.weight.copy_(torch.randn(f, c, 1, 1, generator=gen) / c ** 0.5)
        for gn in (blk.gn1, blk.gn2):
            gn.weight.copy_(torch.rand(gn.weight.shape, generator=gen) + 0.5)
            gn.bias.copy_(torch.randn(gn.bias.shape, generator=gen) * 0.1)
    blk = blk.to(dev).eval()
    return blk, (blk.dw.weight, blk.gn1.weight, blk.gn1.bias, blk.pw.weight,
                 blk.gn2.weight, blk.gn2.bias)


def _sep_case(x, args, stride, res, what: str) -> float:
    """Kernel B against its plain version; returns the max error."""
    got = fused_sep_block(x, *args, stride=stride, residual=res)
    want = fused_sep_block_plain(x, *args, stride=stride, residual=res)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if got.dtype != x.dtype or not (err <= SEP_RTOL * want.float().abs().clamp(min=1.0)).all():
        raise AssertionError(f"kernel B {what}: max err {err.max().item()}")
    return err.max().item()


def _sep_streams(x, args, stride, res, what: str) -> None:
    """Kernel B over more samples than two per CTA of its grid against the
    same samples launched 100 at a time (one per CTA): a sample's
    arithmetic does not depend on the CTA or turn that runs it, so the two
    must agree bit for bit."""
    got = fused_sep_block(x, *args, stride=stride, residual=res)
    alone = torch.cat([fused_sep_block(x[i:i + 100], *args, stride=stride, residual=res)
                       for i in range(0, x.shape[0], 100)])
    if not torch.equal(got, alone):
        raise AssertionError(f"kernel B {what}: streamed samples differ from samples "
                             f"run alone (max {(got.float() - alone.float()).abs().max()})")


def check_sepblock(dev, gen) -> dict:
    """Kernel B vs its plain version at the six serving shapes and at
    OTHER_BLOCKS; the entry sums one forward's six calls."""
    b = SEP_BATCHES[0]
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, t_ops=0.0)
    max_err = 0.0
    for h, w, c, f, stride in SERVING_BLOCKS + OTHER_BLOCKS:
        res = stride == 1 and c == f
        blk, args = _sep_args(gen, c, f, stride, dev)
        what = f"{h}x{w}x{c}->{h // stride}x{w // stride}x{f} s{stride}"
        errs, xs = {}, {}
        for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            xs[name] = torch.randn(max(SEP_BATCHES), h, w, c, generator=gen).to(dev, dtype)
            for nb in SEP_BATCHES:
                errs[f"{name} B={nb}"] = _sep_case(xs[name][:nb], args, stride, res,
                                                   f"{what} {name} B={nb}")
            _sep_streams(xs[name], args, stride, res, f"{what} {name} B={max(SEP_BATCHES)}")
        max_err = max(max_err, *errs.values())
        x = xs["bf16"][:b]
        if (h, w, c, f, stride) not in SERVING_BLOCKS:
            log(f"kernel B {what} (checked only): max err "
                + ", ".join(f"{t} {e:.3e}" for t, e in errs.items())
                + f"; {sepblock_launch_info(x, f, stride)}")
            continue
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view: the cuDNN path's input
        plan = sepblock_launch_info(x, f, stride)
        with torch.no_grad():
            ms = cuda_ms(lambda: fused_sep_block(x, *args, stride=stride, residual=res))
            dev_ms = graph_ms(lambda: fused_sep_block(x, *args, stride=stride, residual=res))
            plain = cuda_ms(lambda: fused_sep_block_plain(x, *args, stride=stride,
                                                          residual=res), iters=5)
            lib = cuda_ms(lambda: blk(x_nchw, torch.bfloat16), iters=10)
        p = (h // stride) * (w // stride)
        nbytes = x.numel() * 2 + b * p * f * 2 + (9 * c + 2 * c + 2 * f) * 4 + c * f * 4
        t_ops = 2 * b * p * c * f / BF16_FLOPS + (2 * 9 * b * p * c + 10 * b * p * (c + f)) / F32_FLOPS
        log(f"kernel B {what}: max err " + ", ".join(f"{t} {e:.3e}" for t, e in errs.items())
            + f"; {ms:.4f} ms eager with events, {dev_ms:.4f} ms device time (plain "
            f"{plain:.4f}, cuDNN block {lib:.4f}, bound "
            f"{max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3:.4f}); {plan}")
        tot["ms"] += ms
        tot["device_ms"] += dev_ms
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bytes"] += nbytes
        tot["t_ops"] += t_ops
    t_bytes = tot["bytes"] / HBM_BYTES_PER_S
    log(f"kernel B, one forward (six blocks, B={b}): {tot['ms']:.4f} ms eager with events, "
        f"{tot['device_ms']:.4f} ms device time")
    return dict(name="sepblock", route="cuda",
                source="opencv_facerecognizer_tpu_torch/csrc/sepblock.cu",
                replaces="opencv_facerecognizer_tpu/ops/pallas_sepblock.py:150",
                max_abs_err=max_err, ms=tot["ms"], device_ms=tot["device_ms"],
                plain_ms=tot["plain_ms"], bound_ms=max(t_bytes, tot["t_ops"]) * 1e3,
                bound_by="bytes" if t_bytes > tot["t_ops"] else "operations",
                library_ms=tot["library_ms"])


def build_stack(device, seed: int, gallery, dtype=torch.bfloat16) -> RecognitionPipeline:
    """The serving stack on ``device``, compute in ``dtype``, weights from
    ``seed`` (the same weights on every device and dtype), fused embedder."""
    det = detector_mod.CNNFaceDetector(device=device, dtype=dtype,
                                       generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        det.net.heatmap.bias.fill_(HEATMAP_BIAS)
        det.net.size.bias.fill_(SIZE_BIAS)
    net = embedder_mod.FaceEmbedNet(**embedder_mod.SERVING_EMBEDDER_KWARGS,
                                    input_size=embedder_mod.SERVING_FACE_SIZE,
                                    dtype=dtype,
                                    generator=torch.Generator().manual_seed(seed + 1))
    return RecognitionPipeline(det, net.to(device), gallery,
                               face_size=embedder_mod.SERVING_FACE_SIZE,
                               fused_embedder=True, device=device)


def bf16_gallery(device, rows: np.ndarray, labels: np.ndarray) -> ShardedGallery:
    gallery = ShardedGallery(len(rows), DIM, store_dtype=torch.bfloat16, device=device)
    gallery.add(rows, labels)
    return gallery


def _iou(a, b) -> float:
    ih = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iw = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ih * iw
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(union, 1e-12)


def cross_check_frame(a, b, i, threshold: float, iou_threshold: float):
    """Pair the valid faces of frame ``i`` in two unpacked results by box
    (slot order may differ where two scores tie to rounding noise).
    Returns (pairs [(slot a, slot b, box diff)], boundary swaps); raises on
    a face without a partner that is not a boundary swap (see
    XCHECK_SCORE)."""
    ia = list(np.flatnonzero(a.valid[i]))
    ib = list(np.flatnonzero(b.valid[i]))
    pairs, lone = [], []
    for j in ia:
        d = [np.abs(a.boxes[i, j] - b.boxes[i, m]).max() for m in ib]
        if d and min(d) <= XCHECK_BOX_PX:
            pairs.append((j, ib.pop(int(np.argmin(d))), min(d)))
        else:
            lone.append((a, j))
    lone += [(b, m) for m in ib]
    kept = [r.boxes[i, j] for r in (a, b) for j in np.flatnonzero(r.valid[i])]
    for r, j in lone:
        score = float(r.det_scores[i, j])
        cutoff = float(r.det_scores[i][r.valid[i]].min())
        near_score = min(abs(score - threshold), abs(score - cutoff)) <= XCHECK_SCORE
        near_iou = any(abs(_iou(r.boxes[i, j], k) - iou_threshold) <= XCHECK_IOU
                       for k in kept if not np.array_equal(k, r.boxes[i, j]))
        if not (near_score or near_iou):
            raise AssertionError(f"CPU cross-check: frame {i} face at "
                                 f"{r.boxes[i, j].tolist()} (score {score}) on one "
                                 "device only, not at a decision boundary")
    return pairs, len(lone)


def step_time_ms(pipeline, batch, iters: int = 20) -> float:
    """Host-clock ms of one serving step, result back on the host."""
    for _ in range(3):
        pipeline.recognize_batch_packed(batch).cpu()
    t0 = time.perf_counter()
    for _ in range(iters):
        pipeline.recognize_batch_packed(batch).cpu()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_step(pipeline, batch, steps: int = 3) -> None:
    """Device time by kernel over a few serving steps (torch.profiler), and
    the card's busy share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    pipeline.recognize_batch_packed(batch).cpu()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            pipeline.recognize_batch_packed(batch).cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    log(f"profile over {steps} steps: device {device_ms:.3f} ms per step, wall "
        f"{wall_ms:.3f} ms under the profiler, card busy {device_ms / wall_ms:.1%}; "
        f"{sum(e.count for e in rows) // steps} device ops per step")
    for e in rows[:12]:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms  x{e.count // steps:<5d} "
            f"{e.key[:90]}")


def run_service(pipeline, frames):
    """Serve ``frames`` through a ``RecognizerService`` over
    ``FakeConnector``; the kernels' launch counts and the two-stage match
    count are set to 0 after the warm-up and read after the drain. Fails
    unless every frame gets one result and both kernels launched. Returns
    (results, launches, service, seconds)."""
    conn = FakeConnector()
    service = RecognizerService(pipeline, conn, batch_size=BATCH, frame_shape=FRAME,
                                transfer_dtype=np.uint8, flush_timeout=0.05)
    service.start(warmup=True)
    # the path's launches: counted from here to the end of the drain
    streaming_match_topk.launches = 0
    fused_sep_block.launches = 0
    ivf_match_topk.calls = 0
    t_serve = time.perf_counter()
    try:
        for i, frame in enumerate(frames):
            conn.inject(FRAME_TOPIC, {**encode_frame(frame), "meta": {"i": i}})
        if not service.drain(timeout=300.0):
            raise AssertionError("service did not drain")
    finally:
        service.stop()
    serve_s = time.perf_counter() - t_serve
    launches = {"streaming_match": streaming_match_topk.launches,
                "sepblock": fused_sep_block.launches}
    results = conn.messages(RESULT_TOPIC)
    if len(results) != len(frames) or sorted(r["meta"]["i"] for r in results) != list(
            range(len(frames))):
        raise AssertionError("not one result per frame")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel did not run on the serving path: {launches}")
    return results, launches, service, serve_s


def check_planted(results, n_plant: int) -> float:
    """The faces of the first batch found their planted rows (labels
    0 .. n_plant - 1) at similarity >= 0.99; returns the lowest."""
    first = sorted((r for r in results if r["meta"]["i"] < BATCH),
                   key=lambda r: r["meta"]["i"])
    found = [f for r in first for f in r["faces"]]
    if len(found) != n_plant or sorted(f["label"] for f in found) != list(range(n_plant)):
        raise AssertionError("served faces of the first batch did not find their planted rows")
    if min(f["similarity"] for f in found) < 0.99:
        raise AssertionError("a planted face matched below similarity 0.99")
    return min(f["similarity"] for f in found)


def serve(dev, seed: int, n_frames: int):
    """Phases 4-5. Returns the kernels' launches in the serving run and
    what the IVF phase reuses (the stack, the gallery rows with the
    planted faces last, the frames)."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    rows = rng.standard_normal((GALLERY_ROWS, DIM), dtype=np.float32)
    labels = np.arange(GALLERY_ROWS, dtype=np.int32) + 100000
    frames = rng.integers(0, 256, (n_frames, *FRAME), dtype=np.uint8)
    # Plant the first batch's faces (their own embeddings on the card)
    # with labels 0..n-1 in the last rows of the gallery.
    gpu = build_stack(dev, seed, ShardedGallery(GALLERY_ROWS, DIM, store_dtype=torch.bfloat16,
                                                device=dev))
    _b, _s, valid, emb = gpu.embed_frames(frames[:BATCH])
    planted = emb[valid.reshape(-1)].float().cpu().numpy()
    n_plant = len(planted)
    if n_plant < BATCH:
        raise AssertionError(f"only {n_plant} faces in the first batch: nothing to check")
    rows[GALLERY_ROWS - n_plant:] = planted
    labels[GALLERY_ROWS - n_plant:] = np.arange(n_plant)
    gpu.gallery.add(rows, labels)
    log(f"setup: {GALLERY_ROWS} bf16 gallery rows ({n_plant} planted faces), "
        f"{n_frames} frames, {time.perf_counter() - t0:.1f} s")

    results, launches, service, serve_s = run_service(gpu, frames)
    log(f"kernel A's path on the serving gallery: {streaming_match_topk.last_path}")
    log(f"served {len(results)} results for {n_frames} frames in {serve_s:.3f} s; "
        f"launches {launches}; ledger {service.ledger()}")
    summary = service.metrics.summary()
    log("service latency p50 ms:", {k: round(v, 3) for k, v in summary.items()
                                    if k.endswith("_p50_ms") and v is not None})
    min_sim = check_planted(results, n_plant)
    log(f"first batch: all {n_plant} faces matched their planted rows (min sim {min_sim:.5f})")

    # CPU cross-check of the first batch in f32 (XCHECK_*): the card's stack
    # over the 2^20-row gallery, the CPU's over the planted rows among 4096
    # random ones.
    small = np.concatenate([rows[:4096], planted])
    small_labels = np.concatenate([labels[:4096], np.arange(n_plant, dtype=np.int32)])
    gpu32 = build_stack(dev, seed, gpu.gallery, dtype=torch.float32)
    cpu32 = build_stack("cpu", seed, bf16_gallery("cpu", small, small_labels),
                        dtype=torch.float32)
    a = unpack_result(gpu32.recognize_batch_packed(frames[:BATCH]).cpu().numpy(), 1)
    b = unpack_result(cpu32.recognize_batch_packed(frames[:BATCH]).numpy(), 1)
    worst_box = worst_sim = 0.0
    n_pairs = n_swaps = 0
    for i in range(BATCH):
        pairs, swaps = cross_check_frame(a, b, i, gpu.detector.score_threshold,
                                         gpu.detector.iou_threshold)
        n_pairs += len(pairs)
        n_swaps += swaps
        for j, m, dbox in pairs:
            if a.labels[i, j, 0] != b.labels[i, m, 0]:
                raise AssertionError(f"CPU cross-check: frame {i} labels differ")
            worst_box = max(worst_box, dbox)
            worst_sim = max(worst_sim, abs(a.similarities[i, j, 0] - b.similarities[i, m, 0]))
    if worst_sim > XCHECK_SIM:
        raise AssertionError(f"CPU cross-check: sim differs by {worst_sim}")
    log(f"CPU cross-check (f32): {n_pairs} faces on both devices with equal labels, max box "
        f"diff {worst_box:.4f} px (bound {XCHECK_BOX_PX}), max sim diff {worst_sim:.2e} "
        f"(bound {XCHECK_SIM}); {n_swaps} boundary swaps; valid masks equal: "
        f"{bool((a.valid == b.valid).all())}")

    # steady-state step (host frames in, packed result back on the host),
    # fused embedder (kernel B) and unfused, in turns
    batch = frames[:BATCH]
    step_ms = {True: [], False: []}
    for fused in (True, False, False, True):
        gpu.fused_embedder = fused
        step_ms[fused].append(step_time_ms(gpu, batch))
    gpu.fused_embedder = True
    faces_per_batch = n_plant  # the first batch's faces on the serving stack
    for fused in (True, False):
        ms = float(np.mean(step_ms[fused]))
        log(f"steady-state step, {'fused' if fused else 'unfused'} embedder: "
            f"{[round(t, 3) for t in step_ms[fused]]} ms per batch of {BATCH} frames, "
            f"host clock ({BATCH * 1e3 / ms:.1f} frames/s, "
            f"{BATCH * MAX_FACES * 1e3 / ms:.1f} face slots/s, "
            f"{faces_per_batch * 1e3 / ms:.1f} detected faces/s)")
    profile_step(gpu, batch)
    return launches, dict(stack=gpu, rows=rows, labels=labels, n_plant=n_plant, frames=frames)


def _unit_rows(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _perturbed(rows: np.ndarray, n: int, rng) -> np.ndarray:
    """``n`` unit queries: gallery rows at random indices plus noise (the
    reference's serving-distribution queries)."""
    pick = rng.choice(len(rows), n, replace=False)
    return _unit_rows(_unit_rows(rows[pick]) + IVF_QUERY_NOISE * rng.standard_normal(
        (n, rows.shape[1]), dtype=np.float32)).astype(np.float32)


def ivf_recall_gate(device) -> dict:
    """The reference's ``bench.py --ivf-smoke`` through the port on
    ``device``: a gallery of IVF_SMOKE rows in mode "ivf", perturbed
    enrolled rows as queries, the tie-aware recall of the two-stage top-1
    against the exact scan (f32, ties to the lowest index), and four rows
    enrolled after the build found at once. The data is the reference
    script's, from its seed; the k-means init is the port's own."""
    c = IVF_SMOKE
    rows, dim, n_q = c["rows"], c["dim"], c["n_q"]
    rng = np.random.default_rng(c["seed"])
    emb = rng.normal(size=(rows, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    gallery = ShardedGallery(rows, dim, device=device)
    gallery.add(emb, np.arange(rows, dtype=np.int32))
    quantizer = CoarseQuantizer(nlist=c["nlist"], nprobe=c["nprobe"], seed=c["quantizer_seed"],
                                kmeans_iters=c["kmeans_iters"], train_sample=c["train_sample"])
    gallery.attach_quantizer(quantizer, mode="ivf")
    if not quantizer.rebuild_now():
        raise AssertionError("IVF smoke gate: the quantizer build failed")
    queries = emb[:n_q] + 0.05 * rng.normal(size=(n_q, dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    calls = ivf_match_topk.calls  # both matches below must go through IVF
    _l, sims_i, idx_i = gallery.match(queries, k=1)
    sims = queries @ emb.T
    idx_x = np.argmax(sims, axis=1)
    recall = tie_aware_agreement(sims_i.cpu(), idx_i.cpu(), sims[np.arange(n_q), idx_x], idx_x)
    new = rng.normal(size=(4, dim)).astype(np.float32)
    new /= np.linalg.norm(new, axis=-1, keepdims=True)
    start = gallery.size
    gallery.add(new, np.arange(rows, rows + 4, dtype=np.int32))
    _l, _s, idx_new = gallery.match(np.concatenate([new, new]), k=1)
    return dict(recall=recall, two_stage_calls=ivf_match_topk.calls - calls,
                incremental_rows_found=bool(np.array_equal(
                    idx_new[:4, 0].cpu().numpy(), np.arange(start, start + 4))),
                stats=quantizer.stats())


def build_ivf_gallery(dev, rows: np.ndarray, labels: np.ndarray, seed: int, late: int = 0):
    """A bf16 gallery of ``rows`` with a quantizer attached in mode "auto"
    (default nlist, IVF_NPROBE) and built; the last ``late`` rows are
    enrolled after the build, through the incremental path."""
    n = len(rows) - late
    gallery = ShardedGallery(len(rows), DIM, store_dtype=torch.bfloat16, device=dev)
    gallery.add(rows[:n], labels[:n])
    quantizer = CoarseQuantizer(nlist=CoarseQuantizer.default_nlist(n), nprobe=IVF_NPROBE,
                                seed=seed, auto_nlist=True, metrics=Metrics())
    gallery.attach_quantizer(quantizer, mode="auto")
    t0 = time.perf_counter()
    if not quantizer.rebuild_now():
        raise AssertionError("IVF build failed")
    build_s = time.perf_counter() - t0
    if late:
        gallery.add(rows[n:], labels[n:])
    ivf = gallery._ivf_data(gallery.data)
    if ivf is None or not gallery._ivf_enabled() or gallery.capacity != len(rows):
        raise AssertionError(f"the gallery of {len(rows)} rows does not serve through IVF")
    if quantizer.metrics.counter(IVF_INCREMENTAL_ROWS) != late:
        raise AssertionError("the late rows did not go through the incremental path")
    info = dict(rows=len(rows), nlist=ivf.nlist, max_cell=ivf.max_cell, spill_cap=ivf.spill_cap,
                spill_rows=quantizer.spill_count,
                list_bytes=sum(t.numel() * t.element_size() for t in ivf[:7]),
                build_s=build_s, **{f"{k}_s": v for k, v in quantizer.last_build_s.items()})
    log(f"IVF gallery of {len(rows)} rows: nlist {ivf.nlist}, max_cell {ivf.max_cell}, "
        f"spill {quantizer.spill_count} of {ivf.spill_cap}, lists {info['list_bytes']} B on "
        f"the card; build {build_s:.3f} s (" + ", ".join(
            f"{k} {v:.3f} s" for k, v in quantizer.last_build_s.items())
        + f"); {late} rows enrolled after the build")
    return gallery, info


def check_ivf(gallery, queries: torch.Tensor) -> float:
    """The two-stage match with kernel A as the rerank against the same
    match with the plain rerank, on the gallery's IVFDeviceData: top-1
    indices equal, the other indices equal except ties within MATCH_ATOL
    (the rule of phase 3), sims within MATCH_ATOL. Returns the max error."""
    data = gallery.data
    ivf = gallery._ivf_data(data)
    max_err = 0.0
    for qn in IVF_QS:
        q = queries[:qn]
        for k in IVF_KS:
            got_v, got_i = ivf_match_topk(q, data.valid, ivf, k=k, nprobe=IVF_NPROBE)
            want_v, want_i = ivf_match_topk(q, data.valid, ivf, k=k, nprobe=IVF_NPROBE,
                                            rerank=streaming_match_topk_plain)
            torch.cuda.synchronize()
            err = (got_v - want_v).abs().max().item()
            beyond_ties = ((got_i != want_i) & ((got_v - want_v).abs() > MATCH_ATOL)).sum().item()
            if (err > MATCH_ATOL or beyond_ties
                    or not torch.equal(got_i[:, 0], want_i[:, 0])):
                raise AssertionError(f"IVF Q={qn} k={k}: kernel A rerank differs from the "
                                     f"plain rerank (max sim err {err}, {beyond_ties} index "
                                     "mismatches beyond ties)")
            log(f"IVF two-stage Q={qn} k={k}: kernel A rerank vs plain rerank, max |sim| err "
                f"{err:.3e}, index agreement {(got_i == want_i).float().mean().item():.6f}")
            max_err = max(max_err, err)
    return max_err


def time_ivf(gallery, q: torch.Tensor, with_plain: bool = False) -> dict:
    """``gallery.match`` through IVF and through the exact kernel (mode
    "exact"), k = 1: CUDA events around eager calls (``*_ms``) and the
    device time of a CUDA graph of the calls (``*_device_ms``); the IVF
    time split into stage 1, the bucket and the rerank (kernel A), and
    kernel A's time, bound and library call at the rerank shape."""
    data = gallery.data
    ivf = gallery._ivf_data(data)
    calls = ivf_match_topk.calls
    out = dict(q=q.shape[0], rows=data.capacity)
    out["ivf_ms"] = cuda_ms(lambda: gallery.match(q, k=1), iters=10)
    if ivf_match_topk.calls == calls:
        raise AssertionError("gallery.match did not take the IVF path")
    out["ivf_device_ms"] = _graph_ms_or_none(lambda: gallery.match(q, k=1), "IVF match")
    out["stage1_ms"] = cuda_ms(lambda: shortlist_cells(q, ivf.centroids, IVF_NPROBE), iters=10)
    sel = shortlist_cells(q, ivf.centroids, IVF_NPROBE)
    out["bucket_ms"] = cuda_ms(lambda: gather_bucket(sel, data.valid, ivf), iters=10)
    _ids, bucket, bvalid = gather_bucket(sel, data.valid, ivf)
    out["rerank_ms"] = cuda_ms(lambda: streaming_match_topk(q, bucket, bvalid, k=1), iters=10)
    gallery.match_mode = "exact"
    try:
        out["exact_ms"] = cuda_ms(lambda: gallery.match(q, k=1), iters=10)
        out["exact_device_ms"] = _graph_ms_or_none(lambda: gallery.match(q, k=1),
                                                   "exact match")
    finally:
        gallery.match_mode = "auto"
    n = bucket.shape[0]
    nbytes = q.numel() * 4 + bucket.numel() * 2 + n + q.shape[0] * 8
    flops = 2 * q.shape[0] * DIM * n
    out.update(cells=int((sel < ivf.nlist).sum().item()), union_slots=sel.shape[0],
               rerank_rows=n, rerank_bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                                  flops / BF16_FLOPS) * 1e3,
               rerank_bound_by="bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS
               else "operations")
    qb = q.to(torch.bfloat16)

    def library():
        s = torch.matmul(qb, bucket.T)
        return torch.topk(torch.where(bvalid, s, torch.finfo(s.dtype).min), 1)

    out["rerank_library_ms"] = cuda_ms(library, iters=5, warmup=1)
    if with_plain:
        out["rerank_plain_ms"] = cuda_ms(
            lambda: streaming_match_topk_plain(q, bucket, bvalid, k=1), iters=3, warmup=1)
    del bucket, bvalid
    log(f"IVF match timing, {out['rows']} rows, Q={out['q']}: IVF {out['ivf_ms']:.4f} ms "
        f"(stage 1 {out['stage1_ms']:.4f}, bucket {out['bucket_ms']:.4f}, rerank "
        f"{out['rerank_ms']:.4f}; device {out['ivf_device_ms']}), exact kernel "
        f"{out['exact_ms']:.4f} ms (device {out['exact_device_ms']}); {out['cells']} of "
        f"{ivf.nlist} cells probed, rerank over {n} rows: bound {out['rerank_bound_ms']:.4f} ms "
        f"({out['rerank_bound_by']}), matmul + topk {out['rerank_library_ms']:.4f} ms"
        + (f", plain {out['rerank_plain_ms']:.4f} ms" if with_plain else ""))
    return out


def _graph_ms_or_none(fn, what: str):
    """``graph_ms`` of a few calls, or None (logged) where the calls
    cannot be captured in a CUDA graph."""
    try:
        return graph_ms(fn, iters=3)
    except RuntimeError as exc:
        log(f"{what}: device time not measured (CUDA graph capture failed: {exc})")
        torch.cuda.synchronize()
        return None


def time_random_ivf(dev, n_rows: int, seed: int) -> list:
    """``time_ivf`` at IVF_TIME_QS on a gallery of ``n_rows`` random unit
    rows (match alone), built and freed here."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + n_rows)
    rows = rng.standard_normal((n_rows, DIM), dtype=np.float32)
    q = torch.from_numpy(_perturbed(rows, max(IVF_TIME_QS), rng)).to(dev)
    gallery, build = build_ivf_gallery(dev, rows, np.arange(n_rows, dtype=np.int32), seed)
    del rows
    log(f"IVF gallery of {n_rows} rows set up in {time.perf_counter() - t0:.1f} s")
    timing = [time_ivf(gallery, q[:qn]) for qn in IVF_TIME_QS]
    del gallery
    torch.cuda.empty_cache()
    return build, timing


def ivf_phase(dev, seed: int, ctx: dict) -> dict:
    """Phase 6 (module docstring); returns the ``{"ivf": ...}`` numbers."""
    rows, labels, n_plant = ctx["rows"], ctx["labels"], ctx["n_plant"]
    gallery, build = build_ivf_gallery(dev, rows, labels, seed, late=n_plant)
    rng = np.random.default_rng(seed + 1)
    queries = torch.from_numpy(_perturbed(rows[:-n_plant], max(IVF_TIME_QS), rng)).to(dev)
    max_err = check_ivf(gallery, queries)

    stack = ctx["stack"]
    pipeline = RecognitionPipeline(stack.detector, stack.embed_net, gallery,
                                   face_size=embedder_mod.SERVING_FACE_SIZE,
                                   fused_embedder=True, device=dev)
    frames = ctx["frames"]
    results, launches, service, serve_s = run_service(pipeline, frames)
    steps = int(service.metrics.counter(BATCHES_DISPATCHED))
    if not gallery.quantizer.ready or ivf_match_topk.calls != steps or steps < 1:
        raise AssertionError(f"IVF serving: {ivf_match_topk.calls} two-stage matches in "
                             f"{steps} steps (quantizer ready: {gallery.quantizer.ready})")
    min_sim = check_planted(results, n_plant)
    log(f"IVF serving: {len(results)} results for {len(frames)} frames in {serve_s:.3f} s, "
        f"{steps} steps all through the two-stage match, launches {launches}; first batch: "
        f"all {n_plant} faces matched their planted rows (min sim {min_sim:.5f})")

    # two-stage recall against the exact scan on random rows (not gated)
    _l, sims_i, idx_i = gallery.match(queries, k=1)
    gallery.match_mode = "exact"
    _l, sims_x, idx_x = gallery.match(queries, k=1)
    gallery.match_mode = "auto"
    recall = tie_aware_agreement(sims_i.cpu(), idx_i.cpu(), sims_x.cpu(), idx_x.cpu())
    log(f"IVF recall at {GALLERY_ROWS} random rows, {queries.shape[0]} perturbed rows as "
        f"queries: {recall:.4f} of the exact scan's top-1 (not gated)")

    ivf_step = step_time_ms(pipeline, frames[:BATCH])
    log(f"IVF steady-state step (fused embedder): {ivf_step:.3f} ms per batch of {BATCH} "
        "frames, host clock")
    timing = [time_ivf(gallery, queries[:qn], with_plain=qn == max(IVF_TIME_QS))
              for qn in IVF_TIME_QS]
    ctx.update(ivf_gallery=gallery, queries=queries)  # the durability phase's
    del pipeline
    builds = [build]
    for n_rows in IVF_OTHER_ROWS:
        other_build, other_timing = time_random_ivf(dev, n_rows, seed)
        builds.append(other_build)
        timing += other_timing
    for n_rows in sorted({t["rows"] for t in timing}):
        wins = [t["q"] for t in timing if t["rows"] == n_rows and t["ivf_ms"] < t["exact_ms"]]
        log(f"IVF vs exact at {n_rows} rows: IVF faster at Q = {wins or 'none of'} "
            f"{list(IVF_TIME_QS)}")

    gate = ivf_recall_gate(dev)
    if gate["recall"] < IVF_SMOKE_RECALL or not gate["incremental_rows_found"] or (
            gate["two_stage_calls"] != 2):
        raise AssertionError(f"IVF smoke gate failed: {gate}")
    log(f"IVF smoke gate ({IVF_SMOKE['rows']} x {IVF_SMOKE['dim']}, nlist "
        f"{IVF_SMOKE['nlist']}, nprobe {IVF_SMOKE['nprobe']}): recall {gate['recall']:.4f} "
        f"(gate {IVF_SMOKE_RECALL}), rows enrolled after the build found")
    return dict(build=builds, max_abs_err=max_err, serve_launches=launches,
                serve_steps=steps, step_ms=ivf_step, recall_2p20=recall,
                smoke_recall=gate["recall"], timing=timing)


def write_pgm(path: str, img: np.ndarray) -> None:
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode() + img.astype(np.uint8).tobytes())


def write_cli_inputs(dev, seed: int, root: str):
    """The port-written checkpoints of the serving detector and embedder
    (phase 4's weights), a gallery directory and a frames directory under
    ``root``; returns (paths, frames)."""
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "frames"))
    rng = np.random.default_rng(seed + 7)
    det = detector_mod.CNNFaceDetector(device=dev, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        det.net.heatmap.bias.fill_(HEATMAP_BIAS)
        det.net.size.bias.fill_(SIZE_BIAS)
    paths = dict(model=os.path.join(root, "model.ckpt"), det=os.path.join(root, "det.ckpt"),
                 gallery=os.path.join(root, "gallery"), frames=os.path.join(root, "frames"),
                 metrics=os.path.join(root, "metrics.jsonl"))
    det.save(paths["det"])
    faces = rng.integers(0, 256, (CLI_SUBJECTS * CLI_IMAGES, *embedder_mod.SERVING_FACE_SIZE))
    emb = embedder_mod.CNNEmbedding(**embedder_mod.SERVING_EMBEDDER_KWARGS,
                                    input_size=embedder_mod.SERVING_FACE_SIZE,
                                    train_steps=0, seed=seed + 1, device=dev)
    model = PredictableModel(emb, NearestNeighbor(CosineDistance(), device=dev))
    model.compute(faces.astype(np.float32), np.arange(len(faces)) // CLI_IMAGES)
    serialization.save_model(paths["model"], model)
    for i, face in enumerate(faces):
        subject = os.path.join(paths["gallery"], f"subject_{i // CLI_IMAGES}")
        os.makedirs(subject, exist_ok=True)
        write_pgm(os.path.join(subject, f"{i}.pgm"), face)
    frames = rng.integers(0, 256, (CLI_FRAMES, *FRAME), dtype=np.uint8)
    for i, frame in enumerate(frames):
        write_pgm(os.path.join(paths["frames"], f"f{i:03d}.pgm"), frame)
    return paths, frames


def cli_args(paths: dict, source: str, dev) -> list:
    """The CLI's command line; the device stays the CLI's default (the
    card) unless ``dev`` is the CPU (a rehearsal)."""
    return ["--model", paths["model"], "--detector", paths["det"], "--gallery",
            paths["gallery"], "--source", source, "--capacity", str(CLI_CAPACITY),
            "--match-mode", "exact", "--fused-embedder", "--batch-size", str(BATCH),
            "--frame-size", str(FRAME[0]), str(FRAME[1]), "--metrics-jsonl", paths["metrics"],
            *(["--device", "cpu"] if dev.type == "cpu" else [])]


def metrics_records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def messages_as_result(messages, max_faces: int):
    """Published result messages (one frame each, in order) as an unpacked
    result (boxes yxyx), for ``cross_check_frame``."""
    n = len(messages)
    packed = np.zeros((n, max_faces, 8), np.float32)
    for i, msg in enumerate(messages):
        for j, face in enumerate(msg["faces"]):
            x0, y0, x1, y1 = face["box"]
            packed[i, j, :6] = (y0, x0, y1, x1, face["detection_score"], 1.0)
            packed[i, j, 6:8] = (face["label"], face["similarity"])
    return unpack_result(packed, 1)


def run_jsonl_cli(paths: dict, frames: np.ndarray, dev) -> dict:
    """The CLI in jsonl mode in a subprocess (``python -m``), stdin a pipe:
    CLI_JSONL_FRAMES frames, ``enroll``, frames of scene 0 until
    ``enrolled`` is published, CLI_JSONL_FRAMES more of scene 0,
    ``stats``, EOF. Returns the messages it printed and its exit code."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
                             *cli_args(paths, "jsonl", dev)], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    out, err = [], []
    readers = [threading.Thread(target=lambda: out.extend(json.loads(l) for l in proc.stdout),
                                daemon=True),
               threading.Thread(target=lambda: err.extend(proc.stderr), daemon=True)]
    for r in readers:
        r.start()

    def send(topic, data):
        proc.stdin.write(json.dumps({"topic": topic, "data": data}) + "\n")
        proc.stdin.flush()

    def enrolled():
        return any(m["topic"] == STATUS_TOPIC and m["data"]["status"] == "enrolled" for m in out)

    seq = 0
    try:
        for i in range(CLI_JSONL_FRAMES):
            send(FRAME_TOPIC, {**encode_frame(frames[i]), "meta": {"seq": seq}})
            seq += 1
        send(CONTROL_TOPIC, {"cmd": "enroll", "subject": CLI_NEW_NAME, "count": CLI_ENROL_COUNT})
        deadline = time.monotonic() + 300
        while not enrolled() and time.monotonic() < deadline and proc.poll() is None:
            send(FRAME_TOPIC, {**encode_frame(frames[0]), "meta": {"seq": seq, "scene": 0}})
            seq += 1
            time.sleep(0.2)
        first_after = seq
        for _ in range(CLI_JSONL_FRAMES):
            send(FRAME_TOPIC, {**encode_frame(frames[0]), "meta": {"seq": seq, "scene": 0}})
            seq += 1
        send(CONTROL_TOPIC, {"cmd": "stats"})
        proc.stdin.close()
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for r in readers:
        r.join(timeout=10)
    if rc != 0:
        log("".join(err[-40:]))
    return dict(messages=out, rc=rc, sent=seq, first_after=first_after)


def cli_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 7 (module docstring); returns the ``{"cli": ...}`` numbers and
    leaves its inputs in ``ctx`` for phase 8."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli_smoke")
    paths, frames = write_cli_inputs(dev, seed, root)
    ctx.update(cli_paths=paths, cli_frames=frames)
    # the native loader's one-time g++ build, timed on its own; the CLI's
    # _load_stack times the checkpoint load and the gallery embed itself
    # and logs them as its `startup` record
    t_build = time.perf_counter()
    if not native.available():
        raise AssertionError("the native image loader did not build")
    native_build_s = time.perf_counter() - t_build
    log(f"cli: native loader built in {native_build_s:.3f} s")

    streaming_match_topk.launches = 0
    fused_sep_block.launches = 0
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        # batches fill to BATCH (no deadline flush), so the first batch is
        # the first BATCH files, as the direct call below takes them
        rc = recognize_app.main(cli_args(paths, "dir", dev)
                                + ["--dir", paths["frames"], "--flush-ms", "1000"])
    launches = {"streaming_match": streaming_match_topk.launches,
                "sepblock": fused_sep_block.launches}
    results = [json.loads(line) for line in stdout.getvalue().splitlines() if line.startswith("{")]
    files = sorted(os.listdir(paths["frames"]))
    if rc != 0 or sorted(r["meta"]["file"] for r in results) != files:
        raise AssertionError(f"cli dir run: rc {rc}, {len(results)} results for {len(files)} frames")
    if dev.type == "cuda" and min(launches.values()) < 1:  # the CPU launches no kernel
        raise AssertionError(f"cli dir run: a kernel did not launch: {launches}")
    records = {r["event"]: r for r in metrics_records(paths["metrics"])}
    startup, replay, ledger = records["startup"], records["dir_replay"], \
        records["shutdown"]["ledger"]
    if ledger["in_system"] != 0 or ledger["completed"] != len(files):
        raise AssertionError(f"cli dir run: the ledger does not close: {ledger}")
    log(f"cli dir run's startup: checkpoints loaded in {startup['checkpoint_load_s']:.4f} s, "
        f"gallery directory of {startup['gallery_images']} images embedded in "
        f"{startup['gallery_embed_s']:.4f} s ({card})")

    # the first batch against a direct RecognitionPipeline call on the
    # same checkpoints and gallery directory, loaded here again
    model = serialization.load_model(paths["model"], device=dev)
    det = detector_mod.CNNFaceDetector.load(paths["det"], device=dev)
    images, labels, _ = dataset_utils.read_images(paths["gallery"],
                                                  image_size=model.feature.input_size)
    gallery_emb = model.feature.extract(images).cpu().numpy()
    gallery = ShardedGallery(CLI_CAPACITY, DIM, store_dtype=torch.bfloat16, device=dev)
    gallery.add(gallery_emb, labels)
    direct = RecognitionPipeline(det, model.feature.net, gallery,
                                 face_size=model.feature.input_size, fused_embedder=True,
                                 device=dev)
    by_file = {r["meta"]["file"]: r for r in results}
    first = [by_file[f] for f in files[:BATCH]]
    batch = frames[:BATCH].astype(np.float32)
    want = unpack_result(direct.recognize_batch_packed(batch).cpu().numpy(), 1)
    # the service's rule: a face below the similarity threshold is label -1
    threshold = recognize_app.build_parser().get_default("similarity_threshold")
    want = want._replace(labels=np.where(want.similarities >= threshold, want.labels, -1))
    got = messages_as_result(first, det.max_faces)
    worst_box = worst_sim = 0.0
    n_pairs = n_swaps = 0
    for i in range(BATCH):
        pairs, swaps = cross_check_frame(got, want, i, det.score_threshold, det.iou_threshold)
        n_pairs += len(pairs)
        n_swaps += swaps
        for j, m, dbox in pairs:
            if got.labels[i, j, 0] != want.labels[i, m, 0]:
                raise AssertionError(f"cli vs direct pipeline: frame {i} labels differ")
            worst_box = max(worst_box, dbox)
            worst_sim = max(worst_sim, abs(got.similarities[i, j, 0] - want.similarities[i, m, 0]))
    if worst_sim > XCHECK_SIM or n_pairs < BATCH:
        raise AssertionError(f"cli vs direct pipeline: {n_pairs} faces paired, sim diff {worst_sim}")
    log(f"cli dir run: {len(results)} results for {len(files)} frames, {replay['answered']} "
        f"answered in {replay['seconds']:.3f} s ({len(files) / replay['seconds']:.1f} frames/s, "
        f"{card}); launches {launches}; ledger {ledger}; first batch vs the direct pipeline: "
        f"{n_pairs} faces, labels equal, max box diff {worst_box:.4f} px, max sim diff "
        f"{worst_sim:.2e}, {n_swaps} boundary swaps")
    del direct, gallery
    torch.cuda.empty_cache()

    os.remove(paths["metrics"])
    run = run_jsonl_cli(paths, frames, dev)
    out = run["messages"]
    results = {m["data"]["meta"]["seq"]: m["data"] for m in out if m["topic"] == RESULT_TOPIC}
    statuses = [m["data"] for m in out if m["topic"] == STATUS_TOPIC]
    enrolled = [s for s in statuses if s["status"] == "enrolled"]
    if run["rc"] != 0 or sorted(results) != list(range(run["sent"])):
        raise AssertionError(f"cli jsonl run: rc {run['rc']}, {len(results)} results for "
                             f"{run['sent']} frames")
    if not enrolled or enrolled[0]["subject"] != CLI_NEW_NAME:
        raise AssertionError(f"cli jsonl run: no enrolment: {statuses}")
    later = [results[s] for s in range(run["first_after"], run["sent"])]
    if not all(CLI_NEW_NAME in {f["name"] for f in r["faces"]} for r in later):
        raise AssertionError("cli jsonl run: the enrolled subject did not come back by name")
    if not any(s["status"] == "stats" for s in statuses):
        raise AssertionError("cli jsonl run: no stats reply")
    records = {r["event"]: r for r in metrics_records(paths["metrics"])}
    jsonl_startup, shutdown = records["startup"], records["shutdown"]
    if shutdown["ledger"]["in_system"] != 0:
        raise AssertionError(f"cli jsonl run: the ledger does not close: {shutdown['ledger']}")
    e2e_p50 = shutdown["summary"]["e2e_latency_p50_ms"]
    stages = {k: round(shutdown["summary"][f"{k}_p50_ms"], 3) for k in (
        "queue_wait", "dispatch", "ready_wait", "publish", "batch_latency")}
    log(f"cli jsonl run: {len(results)} results for {run['sent']} frames, enrolled "
        f"{CLI_NEW_NAME!r} as label {enrolled[0]['label']}, named on all {len(later)} later "
        f"frames of its scene; e2e latency p50 {e2e_p50:.3f} ms, stage p50 ms {stages}; "
        f"startup in a new process: checkpoints loaded in "
        f"{jsonl_startup['checkpoint_load_s']:.4f} s, gallery "
        f"embedded in {jsonl_startup['gallery_embed_s']:.4f} s ({card}); "
        f"ledger {shutdown['ledger']}")
    return dict(card=card, native_build_s=native_build_s,
                checkpoint_load_s=startup["checkpoint_load_s"],
                gallery_embed_s=startup["gallery_embed_s"],
                gallery_images=startup["gallery_images"], dir_frames=len(files),
                dir_seconds=replay["seconds"], dir_frames_per_s=len(files) / replay["seconds"],
                dir_launches=launches, dir_ledger=ledger, xcheck_faces=n_pairs,
                xcheck_max_box_px=worst_box, xcheck_max_sim=worst_sim, xcheck_swaps=n_swaps,
                jsonl_frames=run["sent"], jsonl_e2e_p50_ms=e2e_p50, jsonl_stage_p50_ms=stages,
                jsonl_checkpoint_load_s=jsonl_startup["checkpoint_load_s"],
                jsonl_gallery_embed_s=jsonl_startup["gallery_embed_s"],
                jsonl_enrolled_label=enrolled[0]["label"], jsonl_ledger=shutdown["ledger"])

class RssPeak:
    """Peak resident set size of this process while the block runs,
    sampled from ``/proc/self/statm`` every 5 ms: ``base`` and ``peak``
    in bytes."""

    PAGE = os.sysconf("SC_PAGE_SIZE")

    @classmethod
    def now(cls) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * cls.PAGE

    def __enter__(self):
        self.base = self.peak = self.now()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, self.now())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.now())

    def numbers(self) -> dict:
        return dict(rss_start_bytes=self.base, rss_peak_bytes=self.peak,
                    rss_peak_above_start_bytes=self.peak - self.base)


def wait_for(pred, timeout: float, what: str, poll: float = 0.05):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(poll)


def enrol_through_control(conn, frame: np.ndarray, subject: str) -> None:
    """``enroll`` on the control topic, then the frame DUR_ENROL_COUNT
    times; returns once ``enrolled`` names the subject."""
    conn.inject(CONTROL_TOPIC, {"cmd": "enroll", "subject": subject, "count": DUR_ENROL_COUNT})
    for j in range(DUR_ENROL_COUNT):
        conn.inject(FRAME_TOPIC, {**encode_frame(frame), "meta": {"enrol": subject, "j": j}})
    wait_for(lambda: any(m["status"] in ("enrolled", "enroll_failed") and m["subject"] == subject
                         for m in conn.messages(STATUS_TOPIC) if "subject" in m),
             300, f"the enrolment of {subject}")
    if not any(m["status"] == "enrolled" and m.get("subject") == subject
               for m in conn.messages(STATUS_TOPIC)):
        raise AssertionError(f"enrolment of {subject} failed: {conn.messages(STATUS_TOPIC)[-3:]}")


def timed_wal_appends(state) -> list:
    """Seconds of each WAL append of ``state`` (its fsync included)."""
    seconds = []
    real = state.wal.append_enroll

    def timed(*args, **kwargs):
        t = time.perf_counter()
        real(*args, **kwargs)
        seconds.append(time.perf_counter() - t)

    state.wal.append_enroll = timed
    return seconds


def checkpoint_file(state_dir: str) -> str:
    names = sorted(n for n in os.listdir(os.path.join(state_dir, "checkpoints"))
                   if n.endswith(".ckpt"))
    return os.path.join(state_dir, "checkpoints", names[-1])


def durable_service(dev, ctx: dict, root: str, card: str) -> dict:
    """Steps 1-3 of phase 8: checkpoint, enrol, forced checkpoint, enrol,
    "crash". Returns the crashed service's state and the numbers."""
    stack, gallery, frames = ctx["stack"], ctx["ivf_gallery"], ctx["frames"]
    if not gallery.quantizer.ready or gallery.capacity != GALLERY_ROWS:
        raise AssertionError("durability: phase 6's gallery is not the built 2^20-row one")
    pipeline = RecognitionPipeline(stack.detector, stack.embed_net, gallery,
                                   face_size=embedder_mod.SERVING_FACE_SIZE,
                                   fused_embedder=True, device=dev)
    names = [f"planted_{i}" for i in range(ctx["n_plant"])]
    # the thresholds never fire: the phase takes its checkpoints itself
    state = StateLifecycle(root, keep_checkpoints=2, checkpoint_wal_rows=1 << 30,
                           checkpoint_every_s=1e9)
    wal_s = timed_wal_appends(state)
    conn = FakeConnector()
    service = RecognizerService(pipeline, conn, batch_size=BATCH, frame_shape=FRAME,
                                transfer_dtype=np.uint8, flush_timeout=0.05,
                                subject_names=names, state_store=state)
    t0 = time.perf_counter()
    if not state.checkpoint_now(wait=True):
        raise AssertionError("durability: the first checkpoint failed")
    first = dict(state.last_checkpoint_s, seconds=time.perf_counter() - t0)
    subjects = [f"durable_{i}" for i in range(DUR_SUBJECTS_CHECKPOINTED + DUR_SUBJECTS_WAL)]
    service.start(warmup=True)
    try:
        for i, subject in enumerate(subjects[:DUR_SUBJECTS_CHECKPOINTED]):
            # frames past the first batch: their faces are not planted rows
            enrol_through_control(conn, frames[BATCH + i], subject)
        if gallery.capacity != 2 * GALLERY_ROWS:
            raise AssertionError(f"durability: the gallery did not grow ({gallery.capacity})")
        with RssPeak() as rss:
            t0 = time.perf_counter()
            if not state.checkpoint_now(wait=True):
                raise AssertionError("durability: the forced checkpoint failed")
            ckpt_seconds = time.perf_counter() - t0
        ckpt_path = checkpoint_file(root)
        ckpt = dict(state.last_checkpoint_s, seconds=ckpt_seconds,
                    file_bytes=os.path.getsize(ckpt_path), **rss.numbers())
        if (not os.path.exists(state.sidecar_path)
                or ckpt["payload_bytes"] < gallery.capacity * DIM * 4):
            raise AssertionError(f"durability: checkpoint {ckpt} without its sidecar or rows")
        for i, subject in enumerate(subjects[DUR_SUBJECTS_CHECKPOINTED:]):
            enrol_through_control(conn, frames[BATCH + DUR_SUBJECTS_CHECKPOINTED + i], subject)
        if not service.drain(timeout=300):
            raise AssertionError("durability: the service did not drain")
    finally:
        service.stop()
    state.wal.close()  # the "crash": no graceful shutdown, no final checkpoint
    log(f"durability: first checkpoint ({GALLERY_ROWS} rows) {first}; forced checkpoint of "
        f"{gallery.capacity} rows: {ckpt} ({card})")
    return dict(gallery=gallery, names=list(service.subject_names), ckpt_path=ckpt_path,
                first=first, ckpt=ckpt, wal_s=wal_s, subjects=subjects,
                ledger=service.ledger())


def recover_and_compare(dev, seed: int, ctx: dict, root: str, crashed: dict):
    """Steps 4-5: recover into a fresh gallery and quantizer on the card;
    hold the mirrors, names and matches to the crashed service's."""
    gallery = crashed["gallery"]
    g2 = ShardedGallery(8, DIM, store_dtype=torch.bfloat16, device=dev)
    g2.attach_quantizer(CoarseQuantizer(nlist=CoarseQuantizer.default_nlist(GALLERY_ROWS),
                                        nprobe=IVF_NPROBE, seed=seed, auto_nlist=True,
                                        metrics=Metrics()), mode="auto")
    names2 = []
    state2 = StateLifecycle(root, keep_checkpoints=2)
    with RssPeak() as rss:
        t0 = time.perf_counter()
        report = state2.recover(g2, names2)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    rec = dict(state2.last_recovery_s, seconds=seconds, **rss.numbers())
    if (report["recovered_checkpoint"] != crashed["ckpt_path"]
            or report["replayed_records"] != DUR_SUBJECTS_WAL
            or report.get("quantizer_sidecar") != "loaded"):
        raise AssertionError(f"durability: recovery report {report}")
    for what, a, b in zip(("embeddings", "labels", "valid", "size"), gallery.snapshot(),
                          g2.snapshot()):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"durability: recovered {what} differ")
    if g2.capacity != gallery.capacity or names2 != crashed["names"]:
        raise AssertionError(f"durability: capacity {g2.capacity} / names {names2[-8:]} differ")
    # queries: perturbed gallery rows and the enrolled subjects' own rows
    n_enrolled = len(crashed["subjects"]) * DUR_ENROL_COUNT
    size = g2.size
    enrolled = torch.from_numpy(g2.snapshot()[0][size - n_enrolled:size]).to(dev)
    q = torch.cat([ctx["queries"][:DUR_Q - n_enrolled], enrolled])
    streaming_match_topk.launches = 0
    ivf_match_topk.calls = 0
    for mode in ("exact", "auto"):
        for g in (gallery, g2):
            g.match_mode = mode
        for k in DUR_KS:
            la, sa, ia = gallery.match(q, k=k)
            lb, sb, ib = g2.match(q, k=k)
            if not (torch.equal(ia, ib) and torch.equal(sa, sb) and torch.equal(la, lb)):
                raise AssertionError(f"durability: {mode} match k={k} differs after recovery "
                                     f"({(ia != ib).sum().item()} indices)")
    launches = dict(streaming_match=streaming_match_topk.launches,
                    ivf_match_calls=ivf_match_topk.calls)
    if launches["ivf_match_calls"] != 2 * len(DUR_KS) or (
            dev.type == "cuda" and launches["streaming_match"] < 4 * len(DUR_KS)):
        raise AssertionError(f"durability: the matches did not take both paths: {launches}")
    top = ia[-n_enrolled:, 0].cpu().numpy()
    if not (top >= size - n_enrolled).all():
        raise AssertionError("durability: an enrolled row is not its own top-1 after recovery")
    log(f"durability: recovered {report['recovered_checkpoint']} + {report['replayed_records']} "
        f"WAL records, sidecar {report.get('quantizer_sidecar')}: {rec}; mirrors, capacity "
        f"{g2.capacity}, size {size} and {len(names2)} names equal; gallery.match Q={q.shape[0]} "
        f"k={list(DUR_KS)} equal bit for bit, exact and two-stage; launches {launches}")
    return g2, names2, state2, report, rec, launches


def supervised_serve(dev, ctx: dict, g2, names2, state2) -> dict:
    """Step 6: the frames again through the recovered gallery under the
    supervisor, in three waves. Wave 1: a result
    subscriber raises once, so the readback worker dies. Wave 2: the
    state tick raises once with the wave's batch in hand, so the dispatch
    loop dies and settles that batch as crashed drops (the whole wave
    unless a slow host split it). Wave 3 is served with the launch counts
    reset."""
    stack, frames, n_plant = ctx["stack"], ctx["frames"], ctx["n_plant"]
    if len(frames) < 3 * BATCH:
        raise AssertionError(f"durability: {len(frames)} frames, fewer than three batches")
    pipeline = RecognitionPipeline(stack.detector, stack.embed_net, g2,
                                   face_size=embedder_mod.SERVING_FACE_SIZE,
                                   fused_embedder=True, device=dev)
    conn = FakeConnector()
    raised = []

    def subscriber(_topic, message):
        # the last frame of wave 1: its result is recorded, then the
        # readback worker dies
        if message["meta"]["i"] == BATCH - 1 and "readback" not in raised:
            raised.append("readback")
            raise RuntimeError("injected: a result subscriber fails once")

    conn.subscribe(RESULT_TOPIC, subscriber)
    service = RecognizerService(pipeline, conn, batch_size=BATCH, frame_shape=FRAME,
                                transfer_dtype=np.uint8, flush_timeout=0.05,
                                subject_names=names2, state_store=state2)
    get_batch, tick = service.batcher.get_batch, state2.tick
    dropped = []

    def failing_tick():
        state2.tick = tick
        raised.append("dispatch")
        raise RuntimeError("injected: the state tick fails once")

    def get_batch_arming(*args, **kwargs):
        # arms the failing tick once wave 2's batch is in the loop's hands
        batch = get_batch(*args, **kwargs)
        if batch is not None and batch.metas[0]["i"] == BATCH:
            dropped.extend(m["i"] for m in batch.metas[:batch.count])
            state2.tick = failing_tick
        return batch

    service.batcher.get_batch = get_batch_arming
    sup = ServiceSupervisor(service, state=state2, poll_interval_s=0.05)
    sup.start(warmup=True)
    try:
        for wave, (lo, hi) in enumerate(((0, BATCH), (BATCH, 2 * BATCH)), 1):
            for i in range(lo, hi):
                conn.inject(FRAME_TOPIC, {**encode_frame(frames[i]), "meta": {"i": i}})
            wait_for(lambda: service.metrics.counter(SUPERVISOR_RESTARTS) >= wave, 300,
                     f"the supervisor's restart {wave}")
            if not service.drain(timeout=300):
                raise AssertionError(f"durability: wave {wave} did not drain")
        streaming_match_topk.launches = 0
        fused_sep_block.launches = 0
        for i in range(2 * BATCH, len(frames)):
            conn.inject(FRAME_TOPIC, {**encode_frame(frames[i]), "meta": {"i": i}})
        if not service.drain(timeout=300):
            raise AssertionError("durability: wave 3 did not drain")
        launches = {"streaming_match": streaming_match_topk.launches,
                    "sepblock": fused_sep_block.launches}
    finally:
        sup.stop()
    g2.quantizer.rebuild_now(wait=True, skip_if_ready=True)  # the restore's retrain
    results = conn.messages(RESULT_TOPIC)
    served = [i for i in range(len(frames)) if i not in dropped]
    if not dropped or sorted(r["meta"]["i"] for r in results) != served:
        raise AssertionError(f"durability: {len(results)} results for the {len(served)} "
                             f"frames outside the dropped batch {dropped}")
    ledger = service.ledger()
    # the batch the dispatch loop held, and wave 1's frame whose
    # subscriber raised
    if (ledger["drops_by_reason"] != {FRAMES_DROPPED_CRASHED: len(dropped) + 1}
            or ledger["in_system"] != 0 or ledger["admitted"] != len(frames)):
        raise AssertionError(f"durability: ledger after the crashes {ledger}")
    crashes = service.metrics.counter(LOOP_CRASHES)
    if raised != ["readback", "dispatch"] or sup.restarts != 2 or crashes != 2 or (
            dev.type == "cuda" and min(launches.values()) < 1):  # the CPU launches none
        raise AssertionError(f"durability: crashes {raised} / {crashes}, restarts "
                             f"{sup.restarts}, launches after them {launches}")
    min_sim = check_planted(results, n_plant)
    log(f"durability: supervised serving on the recovered gallery: {len(results)} results for "
        f"{len(frames)} frames, 2 loop crashes (readback worker, dispatch loop), 2 restarts, "
        f"launches after them {launches}; planted faces found (min sim {min_sim:.5f}); "
        f"ledger {ledger} (the batch the dispatch loop held, {len(dropped)} frames, and the "
        "raising subscriber's frame are crashed drops)")
    return dict(restarts=sup.restarts, launches_after_restart=launches, min_planted_sim=min_sim)


class CliProcess:
    """The CLI in jsonl mode in a subprocess (``python -m``) with
    ``--state-dir``; stdout messages and stderr lines are collected."""

    def __init__(self, paths: dict, dev, state_dir: str):
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
             *cli_args(paths, "jsonl", dev), "--state-dir", state_dir, "--flush-ms", "5"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        self.out, self.err = [], []
        self.first_result_s = None
        self._readers = [threading.Thread(target=self._read_out, daemon=True),
                         threading.Thread(target=lambda: self.err.extend(self.proc.stderr),
                                          daemon=True)]
        for r in self._readers:
            r.start()

    def _read_out(self):
        for line in self.proc.stdout:
            msg = json.loads(line)
            if msg["topic"] == RESULT_TOPIC and self.first_result_s is None:
                self.first_result_s = time.perf_counter() - self.t0
            self.out.append(msg)

    def send(self, topic, data):
        self.proc.stdin.write(json.dumps({"topic": topic, "data": data}) + "\n")
        self.proc.stdin.flush()

    def results(self):
        return [m["data"] for m in self.out if m["topic"] == RESULT_TOPIC]

    def named(self, seqs) -> bool:
        got = {r["meta"]["seq"]: r for r in self.results()}
        return all(s in got and CLI_NEW_NAME in {f["name"] for f in got[s]["faces"]}
                   for s in seqs)

    def finish(self, timeout: float = 300) -> int:
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        for r in self._readers:
            r.join(timeout=10)
        return rc

    def stderr(self) -> str:
        return "".join(self.err)


def cli_restarts(dev, ctx: dict, root: str) -> dict:
    """Step 7: the CLI with ``--state-dir``: SIGKILL after ``enrolled``, a
    second writer refused, a restart named through WAL replay, SIGTERM
    clean, a third start from the final checkpoint."""
    frames = ctx["cli_frames"]
    state_dir = os.path.join(root, "cli")
    starts = []

    def start(tag):
        metrics = os.path.join(root, f"cli_{tag}.jsonl")
        return CliProcess(dict(ctx["cli_paths"], metrics=metrics), dev, state_dir), metrics

    def startup(proc, metrics, tag):
        records = {r["event"]: r for r in metrics_records(metrics)}
        starts.append(dict(start=tag, first_result_s=proc.first_result_s,
                           checkpoint_load_s=records["startup"]["checkpoint_load_s"],
                           gallery_embed_s=records["startup"]["gallery_embed_s"],
                           recovery_s=records["recovery"]["seconds"],
                           recovery_stages=records["recovery"]["stages"],
                           replayed_records=records["recovery"]["replayed_records"]))

    def scene(proc, seqs):
        for s in seqs:
            proc.send(FRAME_TOPIC, {**encode_frame(frames[0]), "meta": {"seq": s}})

    p1, m1 = start("first")
    try:
        scene(p1, range(CLI_JSONL_FRAMES))
        p1.send(CONTROL_TOPIC, {"cmd": "enroll", "subject": CLI_NEW_NAME,
                                "count": CLI_ENROL_COUNT})
        seq = CLI_JSONL_FRAMES
        deadline = time.monotonic() + 300
        while not any(m["topic"] == STATUS_TOPIC and m["data"]["status"] == "enrolled"
                      for m in p1.out):
            if time.monotonic() > deadline or p1.proc.poll() is not None:
                raise AssertionError("cli: no 'enrolled' before the kill:\n" + p1.stderr()[-3000:])
            scene(p1, [seq])
            seq += 1
            time.sleep(0.2)
        try:
            recognize_app.main(cli_args(ctx["cli_paths"], "jsonl", dev)
                               + ["--state-dir", state_dir])
            raise AssertionError("cli: a second writer started on a held state dir")
        except SystemExit as exc:
            if "writer lease" not in str(exc):
                raise AssertionError(f"cli: second writer: {exc}")
            second_writer = str(exc)
        p1.proc.send_signal(signal.SIGKILL)
    finally:
        p1.finish(60)
    startup(p1, m1, "first")

    p2, m2 = start("after_sigkill")
    try:
        scene(p2, range(CLI_JSONL_FRAMES))
        wait_for(lambda: p2.named(range(CLI_JSONL_FRAMES)) or p2.proc.poll() is not None, 300,
                 "the restarted CLI's results")
        if not p2.named(range(CLI_JSONL_FRAMES)):
            raise AssertionError("cli: after SIGKILL the subject is not named:\n"
                                 + p2.stderr()[-3000:])
        p2.proc.send_signal(signal.SIGTERM)
        rc2 = p2.finish(300)
    finally:
        p2.finish(60)
    err2 = p2.stderr()
    if rc2 != 0 or "shutdown: clean" not in err2 or "final checkpoint: written" not in err2:
        raise AssertionError(f"cli: SIGTERM rc {rc2}:\n{err2[-3000:]}")
    startup(p2, m2, "after_sigkill")

    p3, m3 = start("after_sigterm")
    try:
        scene(p3, range(CLI_JSONL_FRAMES))
        wait_for(lambda: len(p3.results()) >= CLI_JSONL_FRAMES or p3.proc.poll() is not None,
                 300, "the third start's results")
        p3.proc.stdin.close()
        rc3 = p3.finish(300)
    finally:
        p3.finish(60)
    startup(p3, m3, "after_sigterm")
    if rc3 != 0 or not p3.named(range(CLI_JSONL_FRAMES)):
        raise AssertionError(f"cli: third start rc {rc3}, named {p3.named(range(8))}:\n"
                             + p3.stderr()[-3000:])
    replayed = [s["replayed_records"] for s in starts]
    if replayed != [0, 1, 0]:
        raise AssertionError(f"cli: replayed records by start {replayed}")
    log(f"durability cli: SIGKILL after 'enrolled', the restart named {CLI_NEW_NAME!r} by WAL "
        f"replay, SIGTERM exited 0 clean, the third start recovered its checkpoint; second "
        f"writer refused: {second_writer}; startups {starts}")
    return dict(starts=starts, second_writer_refused=True)


def durability_phase(dev, seed: int, card: str, ctx: dict) -> dict:
    """Phase 8 (module docstring); returns the ``{"durability": ...}``
    numbers."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "state_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    steps = {}
    t = time.perf_counter()
    crashed = durable_service(dev, ctx, os.path.join(root, "service"), card)
    steps["service_s"], t = time.perf_counter() - t, time.perf_counter()
    g2, names2, state2, _report, rec, match_launches = recover_and_compare(
        dev, seed, ctx, os.path.join(root, "service"), crashed)
    del crashed["gallery"], ctx["ivf_gallery"]
    steps["recover_compare_s"], t = time.perf_counter() - t, time.perf_counter()
    supervised = supervised_serve(dev, ctx, g2, names2, state2)
    state2.close()
    del g2
    torch.cuda.empty_cache()
    steps["supervised_s"], t = time.perf_counter() - t, time.perf_counter()
    cli = cli_restarts(dev, ctx, root)
    steps["cli_s"] = time.perf_counter() - t
    wal_ms = np.asarray(crashed["wal_s"]) * 1e3
    return dict(card=card, first_checkpoint=crashed["first"], checkpoint=crashed["ckpt"],
                recovery=rec, wal_appends=len(wal_ms), wal_append_p50_ms=float(
                    np.median(wal_ms)), wal_append_max_ms=float(wal_ms.max()),
                match_launches=match_launches, supervised=supervised, cli=cli,
                service_ledger=crashed["ledger"], phase_steps=steps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=4 * BATCH)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {', '.join(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name in _build.KERNELS:
        log_ptxas(name)
    gen = torch.Generator().manual_seed(args.seed)
    entries = [check_match(dev, gen), check_sepblock(dev, gen)]
    launches, ctx = serve(dev, args.seed, args.frames)
    ivf = ivf_phase(dev, args.seed, ctx)
    cli = cli_phase(dev, args.seed, card, ctx)
    durability = durability_phase(dev, args.seed, card, ctx)
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"ivf": ivf}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"durability": durability}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
