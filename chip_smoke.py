#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--frames N]

Phases (any failure exits nonzero before the result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``opencv_facerecognizer_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel);
3. hold each kernel against its plain PyTorch version on the card:
   the streaming match (kernel A) at Q = 512, D = 256, N = 2^20 bf16 with
   duplicate and invalid rows, k = 1 and 5, plus a small ragged case with
   fewer valid rows than k; the fused separable block (kernel B) at the
   six serving block shapes, B = 512 (and once in f32). Time each beside
   its plain version and beside one PyTorch call computing the same
   function;
4. serve: a ``RecognizerService`` over ``FakeConnector`` with the serving
   detector and embedder (random weights from ``--seed``), a 2^20-row
   bf16 gallery, batches of 32 256x256 uint8 frames and the fused
   embedder. Every frame must get one result, both kernels' launch counts
   must rise during the run, and the faces of the first batch must find
   their own planted gallery rows; the first batch through the same stack
   in f32 must agree with the CPU (smaller gallery; see XCHECK_*);
5. time the steady-state serving step, fused and unfused embedder in
   turns, and profile it (device time by kernel, the card's busy share).

The line before the last is the per-kernel JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.models import detector as detector_mod
from opencv_facerecognizer_tpu_torch.models import embedder as embedder_mod
from opencv_facerecognizer_tpu_torch.ops import _build
from opencv_facerecognizer_tpu_torch.ops.sepblock import (
    fused_sep_block, fused_sep_block_plain)
from opencv_facerecognizer_tpu_torch.ops.streaming_match import (
    NEG_INF, streaming_match_topk, streaming_match_topk_plain)
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery
from opencv_facerecognizer_tpu_torch.parallel.pipeline import (
    RecognitionPipeline, unpack_result)
from opencv_facerecognizer_tpu_torch.runtime.connector import (
    FakeConnector, encode_frame)
from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
    FRAME_TOPIC, RESULT_TOPIC, RecognizerService)

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
#: kernel B: bf16 outputs; the kernel and the plain version may round an
#: intermediate to neighbouring bf16 values: two bf16 ulps of the output
SEP_RTOL = 2.0 ** -6
#: the six (H, W, C, F, stride) blocks of the serving embedder at 64x64
SERVING_BLOCKS = [(32, 32, 32, 64, 2), (16, 16, 64, 64, 1),
                  (16, 16, 64, 128, 2), (8, 8, 128, 128, 1),
                  (8, 8, 128, 256, 2), (4, 4, 256, 256, 1)]
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

def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters`` runs
    after ``warmup`` runs."""
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
    max_err = 0.0
    for k in (1, 5):
        got_v, got_i = streaming_match_topk(q, g, valid, k=k)
        want_v, want_i = streaming_match_topk_plain(q, g, valid, k=k)
        torch.cuda.synchronize()
        err = (got_v - want_v).abs().max().item()
        ties_only = ((got_i != want_i) & ((got_v - want_v).abs() > MATCH_ATOL)).sum().item()
        if err > MATCH_ATOL or ties_only:
            raise AssertionError(f"kernel A k={k}: max sim err {err}, {ties_only} "
                                 "index mismatches beyond ties")
        planted = torch.where(valid[100000:100512], 100000, 900000) + torch.arange(512, device=dev)
        if not torch.equal(got_i[:, 0].long(), planted):
            raise AssertionError(f"kernel A k={k}: planted rows not found at the lowest index")
        max_err = max(max_err, err)
        log(f"kernel A k={k}: max |sim - plain| {err:.3e}, index agreement "
            f"{(got_i == want_i).float().mean().item():.6f}")
    # ragged, fewer valid rows than k
    q2 = torch.randn(37, 64, generator=gen).to(dev)
    g2 = torch.randn(301, 64, generator=gen).to(dev)
    v2 = torch.zeros(301, dtype=torch.bool, device=dev)
    v2[[3, 200, 250]] = True
    for gg in (g2, g2.to(torch.bfloat16)):
        got_v, got_i = streaming_match_topk(q2, gg, v2, k=5)
        want_v, want_i = streaming_match_topk_plain(q2, gg, v2, k=5)
        torch.cuda.synchronize()
        if not (torch.equal(got_i, want_i) and (got_i[:, 3:] == -1).all()
                and (got_v[:, 3:] == NEG_INF).all()):
            raise AssertionError("kernel A ragged case: sentinels or indices differ")
        max_err = max(max_err, (got_v - want_v).abs().max().item())
    log("kernel A ragged (Q=37, N=301, 3 valid rows, k=5): indices and -1 sentinels equal")

    k = 1  # the serving top_k
    ms = cuda_ms(lambda: streaming_match_topk(q, g, valid, k=k))
    plain_ms = cuda_ms(lambda: streaming_match_topk_plain(q, g, valid, k=k), iters=3, warmup=1)
    qb = q.to(torch.bfloat16)

    def library():
        s = torch.matmul(qb, g.T)
        return torch.topk(torch.where(valid, s, torch.finfo(s.dtype).min), k)

    library_ms = cuda_ms(library, iters=5, warmup=1)
    nbytes = q.numel() * 4 + g.numel() * 2 + valid.numel() + q.shape[0] * k * 8
    flops = 2 * q.shape[0] * GALLERY_ROWS * DIM
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    return dict(name="streaming_match", route="cuda",
                source="opencv_facerecognizer_tpu_torch/csrc/streaming_match.cu",
                replaces="opencv_facerecognizer_tpu/ops/pallas_match.py:99",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS
                else "operations", library_ms=library_ms)


def check_sepblock(dev, gen) -> dict:
    """Kernel B vs its plain version at the six serving shapes; the entry
    sums one forward's six calls."""
    b = 512
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, t_ops=0.0)
    max_err = 0.0
    for h, w, c, f, stride in SERVING_BLOCKS:
        res = stride == 1 and c == f
        x = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
        blk = embedder_mod._SepBlock(c, f, stride)
        with torch.no_grad():
            blk.dw.weight.copy_(torch.randn(c, 1, 3, 3, generator=gen) * 0.3)
            blk.pw.weight.copy_(torch.randn(f, c, 1, 1, generator=gen) / c ** 0.5)
            for gn in (blk.gn1, blk.gn2):
                gn.weight.copy_(torch.rand(gn.weight.shape, generator=gen) + 0.5)
                gn.bias.copy_(torch.randn(gn.bias.shape, generator=gen) * 0.1)
        blk = blk.to(dev).eval()
        args = (blk.dw.weight, blk.gn1.weight, blk.gn1.bias, blk.pw.weight,
                blk.gn2.weight, blk.gn2.bias)
        got = fused_sep_block(x, *args, stride=stride, residual=res)
        want = fused_sep_block_plain(x, *args, stride=stride, residual=res)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if not (err <= SEP_RTOL * want.float().abs().clamp(min=1.0)).all():
            raise AssertionError(f"kernel B {h}x{w}x{c}->{f}/s{stride}: max err "
                                 f"{err.max().item()}")
        max_err = max(max_err, err.max().item())
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view: the cuDNN path's input
        with torch.no_grad():
            ms = cuda_ms(lambda: fused_sep_block(x, *args, stride=stride, residual=res))
            plain = cuda_ms(lambda: fused_sep_block_plain(x, *args, stride=stride,
                                                          residual=res), iters=5)
            lib = cuda_ms(lambda: blk(x_nchw, torch.bfloat16), iters=10)
        p = (h // stride) * (w // stride)
        nbytes = x.numel() * 2 + b * p * f * 2 + (9 * c + 2 * c + 2 * f) * 4 + c * f * 2
        t_ops = 2 * b * p * c * f / BF16_FLOPS + (2 * 9 * b * p * c + 10 * b * p * (c + f)) / F32_FLOPS
        log(f"kernel B {h}x{w}x{c}->{h // stride}x{w // stride}x{f} s{stride}: "
            f"max err {err.max().item():.3e}, {ms:.4f} ms (plain {plain:.4f}, "
            f"cuDNN block {lib:.4f}, bound {max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3:.4f})")
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bytes"] += nbytes
        tot["t_ops"] += t_ops
    # the f32 path (the CPU cross-check's dtype), at the residual block
    h, w, c, f, stride = SERVING_BLOCKS[1]
    x = torch.randn(b, h, w, c, generator=gen).to(dev)
    args = (torch.randn(c, 1, 3, 3, generator=gen) * 0.3, torch.rand(c, generator=gen) + 0.5,
            torch.randn(c, generator=gen) * 0.1, torch.randn(f, c, 1, 1, generator=gen) / c ** 0.5,
            torch.rand(f, generator=gen) + 0.5, torch.randn(f, generator=gen) * 0.1)
    args = tuple(a.to(dev) for a in args)
    got = fused_sep_block(x, *args, stride=stride, residual=True)
    want = fused_sep_block_plain(x, *args, stride=stride, residual=True)
    torch.cuda.synchronize()
    err = (got - want).abs()
    if got.dtype != torch.float32 or not (err <= SEP_RTOL * want.abs().clamp(min=1.0)).all():
        raise AssertionError(f"kernel B f32 {h}x{w}x{c}: max err {err.max().item()}")
    max_err = max(max_err, err.max().item())
    log(f"kernel B f32 {h}x{w}x{c}->{f} s{stride}: max err {err.max().item():.3e}, "
        f"mean {err.mean().item():.3e}")
    t_bytes = tot["bytes"] / HBM_BYTES_PER_S
    return dict(name="sepblock", route="cuda",
                source="opencv_facerecognizer_tpu_torch/csrc/sepblock.cu",
                replaces="opencv_facerecognizer_tpu/ops/pallas_sepblock.py:150",
                max_abs_err=max_err, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=max(t_bytes, tot["t_ops"]) * 1e3,
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


def serve(dev, seed: int, n_frames: int) -> dict:
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

    conn = FakeConnector()
    service = RecognizerService(gpu, conn, batch_size=BATCH, frame_shape=FRAME,
                                transfer_dtype=np.uint8, flush_timeout=0.05)
    service.start(warmup=True)
    # the main path's launches: counted from here to the end of the drain
    streaming_match_topk.launches = 0
    fused_sep_block.launches = 0
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
    log(f"served {len(results)} results for {n_frames} frames in {serve_s:.3f} s; "
        f"launches {launches}; ledger {service.ledger()}")
    summary = service.metrics.summary()
    log("service latency p50 ms:", {k: round(v, 3) for k, v in summary.items()
                                    if k.endswith("_p50_ms") and v is not None})
    if len(results) != n_frames or sorted(r["meta"]["i"] for r in results) != list(range(n_frames)):
        raise AssertionError("not one result per frame")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel did not run on the serving path: {launches}")
    first = sorted((r for r in results if r["meta"]["i"] < BATCH),
                   key=lambda r: r["meta"]["i"])
    found = [f for r in first for f in r["faces"]]
    if len(found) != n_plant or sorted(f["label"] for f in found) != list(range(n_plant)):
        raise AssertionError("served faces of the first batch did not find their planted rows")
    if min(f["similarity"] for f in found) < 0.99:
        raise AssertionError("a planted face matched below similarity 0.99")
    log(f"first batch: all {n_plant} faces matched their planted rows "
        f"(min sim {min(f['similarity'] for f in found):.5f})")

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
    return launches


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
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    gen = torch.Generator().manual_seed(args.seed)
    entries = [check_match(dev, gen), check_sepblock(dev, gen)]
    launches = serve(dev, args.seed, args.frames)
    for e in entries:
        e["launches"] = launches[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
