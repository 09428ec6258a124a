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
   Its numbers are one ``{"ivf": ...}`` line.

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
    FRAME_TOPIC, RESULT_TOPIC, RecognizerService)
from opencv_facerecognizer_tpu_torch.utils.metrics import (
    BATCHES_DISPATCHED, IVF_INCREMENTAL_ROWS, Metrics)

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
    del gallery, pipeline
    torch.cuda.empty_cache()
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
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"ivf": ivf}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
