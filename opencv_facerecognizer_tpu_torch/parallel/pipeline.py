"""The serving step: detect -> align -> embed -> match for one frame batch.

Port of ``opencv_facerecognizer_tpu/parallel/pipeline.py``, on one device
or over the gallery's (dp, tp) mesh (below). Every frame contributes
exactly ``max_faces`` slots; empty slots ride
along as invalid work, so every batch has the same shapes. The outputs
leave the device as one packed ``[B, K, 6 + 2k]`` array with the
reference's byte layout. The match is the gallery's choice: the exact
scan, or the two-stage IVF match once the gallery's quantizer is ready;
each call reads the gallery snapshot and the quantizer snapshot once and
pins the choice for the batch.

Steps are cached per step key, the reference's tuple (batch, H, W, frame
dtype, gallery capacity, ``kernel_enabled(capacity)``, IVF shape
signature or None). On the card a cached step is one captured
``torch.cuda.CUDAGraph`` of the whole packed step, from the uint8 cast to
``pack_result``, with static slots: the frames, the gallery's ``valid``
and ``labels`` (filled from the call's snapshot before each replay, a
device copy), and the packed output. The graph reads the embeddings
tensor (and the IVF lists) it was captured over, by address: an entry
remembers their addresses and is captured again when the call's
snapshot holds other tensors (a ``reset``, ``load_snapshot``,
``swap_from``, or a quantizer publish); in-place appends keep the
address. All step graphs of a pipeline share one memory pool: they replay
one at a time on the serving stream. A graph tallies at capture the launches
of the kernel wrappers it holds (``ops._build.capture_tally``) and adds
them to the wrappers' counters on every replay. On
the CPU (or with ``cuda_graphs=False``) a cached step is the eager
callable under the same key. A capture or replay that fails raises; no
path falls back to eager.

**Over a mesh** (``gallery.mesh`` of more than one slot, as the
reference's frames are dp-sharded, its nets replicated and its match
tp-sharded): dp row ``r`` takes frames ``[r B / dp, (r + 1) B / dp)`` and
detects, aligns and embeds them on its first slot, on that slot's stream
(forked from the caller's stream by an event and joined back), with its
own copies of the detector and embedder nets (``mesh._replicas``: row 0's
are the pipeline's own). The embeddings are gathered on the mesh's first
slot and matched by ``gallery.match_fn`` over the snapshot's shards:
``match_pod`` (kernel A on each shard's slot) once the slots are cards and
a shard holds ``KERNEL_MIN_CAPACITY`` rows, else ``match_global``. The
packed output lands on the first slot, which is ``device``. A batch dp
does not divide is refused, and so is ``fused_embedder`` (the reference's
``ValueError``). A mesh of one slot is the single-device step. Graphs: a
CUDA graph belongs to one device, so each step key of a mesh is captured
level by level, one graph per card and level (``_LevelStep``: the rows'
embed, the shards' top-k, the rows' merge, the pack), replayed on each
card's current stream with device-to-device copies queued between the
levels; each card's work forks from the serving stream and joins back
before the call returns. Slots of one card take the same form (one graph a
level), so a mesh on one card runs the code a mesh over several runs.
Across processes (``parallel.mesh``'s contract) each process runs the
levels of its own rows and slots; the candidates of a row spanning
processes and the packed rows of other processes cross between levels by
eager collectives (``_capture_levels``), captured in no graph. That
form was chosen over one multi-device capture, which was not tried:
PyTorch's capture registers its memory pool on the capturing card only.
Over slots of one card and over four cards it gives the eager step's bytes
(``tests/test_torch_gpu.py``). A shard on another card is a copy made when
the tier is placed: a grow captures its steps again at the first call of
the new tier. The steps' graphs share one pool a card; a capture made
when no cached step holds a graph of those pools takes fresh ones, since
capturing into a pool whose graphs were all freed trips the caching
allocator.

**The cascade's stage 1** (``cascade=``, a ``models.cascade.FaceGate``):
``cascade_scores`` maps a batch of frames to ``[B]`` face-possible
probabilities on the device, one captured graph per (batch, H, W, frame
dtype); the gallery never enters it. Its graphs have a pool of their own,
made again when an install of another architecture drops them (capturing
into a pool whose graphs were all freed trips the caching allocator). The
pipeline serves its own copy of the gate's net, so an install never
touches the gate object it was given.

**Installs are atomic against the step.** ``install_detector_params`` and
``install_cascade`` copy the new weights into the served parameters (and
their cached casts) in place, on the stream the steps are queued on (on a
mesh, into each other dp row's copy on that row's stream, forked from and
joined to it), holding ``_weights_lock``; a step or a stage-1 pass is queued (its graph
replayed, or its kernels launched eagerly) holding the same lock. So a
queued step sits wholly before the first copy or wholly after the last
in stream order, and reads all-old or all-new weights, never a mix. Each
queued step records the model versions it ran (``last_model_versions``,
``last_cascade_info["version"]``), which the service stamps on its
results.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.models import cascade as cascade_mod
from opencv_facerecognizer_tpu_torch.models import detector as detector_mod
from opencv_facerecognizer_tpu_torch.models import embedder as embedder_mod
from opencv_facerecognizer_tpu_torch.ops import _build
from opencv_facerecognizer_tpu_torch.ops import image as image_ops
from opencv_facerecognizer_tpu_torch.parallel.gallery import (
    GalleryData, ShardedGallery, _gather_candidates, _handoff, empty_data, merge_candidates,
    shard_topk)
from opencv_facerecognizer_tpu_torch.parallel.mesh import (
    DP_AXIS, _replicas, on_slot, record_event)
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, disable_tf32, resolve_device)

#: eager runs of a new step on the capture stream before its capture, so
#: cuDNN and cuBLAS choose their algorithms and workspaces outside it
CAPTURE_WARMUP_RUNS = 2

class RecognitionResult(NamedTuple):
    boxes: torch.Tensor  # [B, K, 4] pixel yxyx
    det_scores: torch.Tensor  # [B, K]
    valid: torch.Tensor  # [B, K] bool
    labels: torch.Tensor  # [B, K, k] gallery labels, best first
    similarities: torch.Tensor  # [B, K, k] cosine similarity


def pack_result(result: RecognitionResult) -> torch.Tensor:
    """[B, K, 6 + 2k] f32: boxes | det_score | valid | labels | sims (one
    array, so the serving loop reads back once per batch; labels ride as
    f32, exact below 2^24)."""
    return torch.cat([
        result.boxes.float(),
        result.det_scores.float()[..., None],
        result.valid.float()[..., None],
        result.labels.float(),
        result.similarities.float(),
    ], dim=-1)


def unpack_result(packed: np.ndarray, top_k: int) -> RecognitionResult:
    """Host-side inverse of ``pack_result`` (numpy views, no copies)."""
    return RecognitionResult(
        boxes=packed[..., 0:4],
        det_scores=packed[..., 4],
        valid=packed[..., 5] > 0.5,
        labels=packed[..., 6:6 + top_k].astype(np.int32),
        similarities=packed[..., 6 + top_k:6 + 2 * top_k],
    )


def _unpack_device(packed: torch.Tensor, top_k: int) -> RecognitionResult:
    """``unpack_result`` on the device, as new tensors (never views of a
    graph's static output)."""
    return RecognitionResult(
        boxes=packed[..., 0:4].clone(),
        det_scores=packed[..., 4].clone(),
        valid=packed[..., 5] > 0.5,
        labels=packed[..., 6:6 + top_k].to(torch.int32),
        similarities=packed[..., 6 + top_k:6 + 2 * top_k].clone(),
    )


class _EagerStep:
    """A cached step that runs eagerly (the CPU, or ``cuda_graphs=False``):
    ``forward(frames, data, ivf)`` reads whatever snapshot the call brings,
    so it binds to none."""

    binding = None

    def __init__(self, forward):
        self._forward = forward

    def __call__(self, frames: torch.Tensor, data: GalleryData, ivf) -> torch.Tensor:
        return self._forward(frames, data, ivf)


class _GraphStep:
    """A captured step: the graph, its static input slots and output, the
    snapshot tensors it reads by address (``binding``), and the launches a
    replay adds to the wrappers' counters (``{(fn, attr): n}``)."""

    def __init__(self, graph, frames, valid, labels, out, binding, deltas):
        self.graph = graph
        self.frames = frames
        self.valid = valid
        self.labels = labels
        self.out = out
        self.binding = binding
        self.deltas = deltas

    def __call__(self, frames: torch.Tensor, data: GalleryData, ivf) -> torch.Tensor:
        # frames on the card (the ingest upload) copy device to device, on
        # the serving stream: a queued replay has read the slot before the
        # next call's copy overwrites it
        self.frames.copy_(frames)
        self.valid.copy_(data.valid)
        self.labels.copy_(data.labels)
        self.graph.replay()
        for (fn, attr), n in self.deltas.items():
            setattr(fn, attr, getattr(fn, attr) + n)
        return self.out


class _LevelStep:
    """A step over a mesh, captured level by level: each level is one
    graph per card (a CUDA graph belongs to one device; a card's slots
    fork from its capture stream and join back inside it),
    replayed on that card's current stream; between levels, the hops are
    device-to-device copies from one level's outputs into the next level's
    static inputs, which PyTorch orders against both cards' current
    streams. The call forks every other card's current stream from the
    first slot's and joins them back, so all of a step's work lies between
    two points of the serving stream. Static inputs: each dp row's frames,
    each shard's ``valid`` and each row's labels (filled from the call's
    snapshot); the shards' rows are read by address (``binding``)."""

    def __init__(self, device, devices, frames, valid, labels, binding):
        self.device = device
        #: this process's cards of the mesh other than the home slot's
        self.others = [d for d in devices if d != device]
        #: static inputs; ``None`` where a row or slot is another process's
        self.frames = frames
        self.valid = valid
        self.labels = labels
        self.binding = binding
        self.levels: list = []  # [[(device, graph)]]
        self.hops: list = []  # [[(dst, src)]] after each level
        #: eager callables after each level's hops: across processes, the
        #: collectives, which write into the next level's static inputs
        self.afters: list = []
        self.deltas: Counter = Counter()
        self.out = None

    def level(self, pipeline, jobs, pool_of) -> list:
        """Capture ``jobs`` ([(slot, fn)], each ``fn`` returning a tuple of
        tensors) as one graph per card, replay them once, and return the
        jobs' outputs in order (the graphs' static outputs)."""
        by_dev: Dict = {}
        for i, (slot, fn) in enumerate(jobs):
            by_dev.setdefault(slot.device, []).append((i, slot, fn))
        outs, graphs = [None] * len(jobs), []
        for dev, group in by_dev.items():
            def run(group=group, dev=dev):
                start = [e for e in (record_event(dev),) if e is not None]
                found, done = [], []
                for _i, slot, fn in group:
                    with on_slot(slot, start):
                        found.append(fn())
                        done += [e for e in (record_event(slot.device),) if e is not None]
                for ev in done:
                    torch.cuda.current_stream(dev).wait_event(ev)
                return found

            graph, found, deltas = pipeline._capture_graph(run, pool_of(dev), dev)
            self.deltas.update(deltas)
            graphs.append((dev, graph))
            graph.replay()
            for (i, _slot, _fn), res in zip(group, found):
                outs[i] = res
        self.levels.append(graphs)
        self.hops.append([])
        self.afters.append([])
        return outs

    def hop(self, moves) -> list:
        """Static inputs of the next level: for each ``(src, device)`` a
        tensor like ``src`` on ``device``, filled now and after every
        replay of the level that made ``src``."""
        dsts = []
        for src, dev in moves:
            dst = torch.empty_like(src, device=dev)
            dst.copy_(src)
            self.hops[-1].append((dst, src))
            dsts.append(dst)
        return dsts

    def after(self, fn) -> None:
        """Run ``fn`` now and after every replay of the last level (once
        its hops are queued)."""
        fn()
        self.afters[-1].append(fn)

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor, data: GalleryData, ivf) -> torch.Tensor:
        cuda = self.device.type == "cuda"
        if cuda:
            fork = record_event(self.device)
            for dev in self.others:
                torch.cuda.current_stream(dev).wait_event(fork)
        per = frames.shape[0] // len(self.frames)
        for r, slot in enumerate(self.frames):
            if slot is not None:
                slot.copy_(frames[r * per:(r + 1) * per], non_blocking=True)
        for row, src_row in zip(self.valid, data.shards.valid):
            for dst, src in zip(row, src_row):
                if dst is not None:
                    dst.copy_(src, non_blocking=True)
        for dst, src in zip(self.labels, data.shards.labels):
            if dst is not None:
                dst.copy_(src, non_blocking=True)
        for graphs, hops, afters in zip(self.levels, self.hops, self.afters):
            for _dev, graph in graphs:
                graph.replay()
            for dst, src in hops:
                dst.copy_(src, non_blocking=True)
            for fn in afters:
                fn()
        if cuda:
            cur = torch.cuda.current_stream(self.device)
            for dev in self.others:
                cur.wait_event(record_event(dev))
        for (fn, attr), n in self.deltas.items():
            setattr(fn, attr, getattr(fn, attr) + n)
        return self.out


class _GraphScores:
    """A captured stage-1 pass: the graph, its static frames slot and its
    ``[B]`` output."""

    def __init__(self, graph, frames, out):
        self.graph = graph
        self.frames = frames
        self.out = out

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        # host frames copy in stream order; the caller reads the scores
        # (which waits for this stream) before it writes their buffer again
        self.frames.copy_(frames, non_blocking=True)
        self.graph.replay()
        return self.out


class RecognitionPipeline:
    """Holds the nets and the gallery and runs the per-batch step on
    ``device`` (the card unless the caller asks for the CPU; with a mesh
    gallery, its home slot's device (``Mesh.home``: the mesh's first slot
    on one process), the step over the whole mesh),
    each step key as captured CUDA graphs on the card (``cuda_graphs``);
    with a ``cascade`` gate also the stage-1 pass (``cascade_scores``), on
    ``device``."""

    def __init__(self, detector: detector_mod.CNNFaceDetector,
                 embed_net: embedder_mod.FaceEmbedNet,
                 gallery: ShardedGallery,
                 face_size: Tuple[int, int] = embedder_mod.SERVING_FACE_SIZE,
                 top_k: int = 1, fused_embedder: bool = False,
                 device: DeviceLike = DEFAULT_DEVICE, cuda_graphs: bool = True,
                 cascade: Optional[cascade_mod.FaceGate] = None):
        mesh = gallery.mesh
        if fused_embedder and mesh.size > 1:
            raise ValueError("fused_embedder=True requires a single-device mesh "
                             f"(got {mesh.size} devices)")
        self.device = resolve_device(device)
        if any(s.device.type == "cuda" for s in mesh.devices.flat):
            disable_tf32()  # the f32 heads, f32 stacks and the crop stay full f32
        for name, dev in (("detector", detector.device),
                          ("gallery", gallery.device),
                          ("embed_net", next(embed_net.parameters()).device)):
            if dev != self.device:
                raise ValueError(f"{name} lives on {dev}, pipeline on {self.device}")
        self.detector = detector
        self.embed_net = embed_net.eval()
        self.gallery = gallery
        #: the gallery's mesh; on more than one slot, each dp row's first
        #: slot (``_rows``) detects, aligns and embeds the row's frames with
        #: its own copies of the nets (row 0's are ``detector.net`` and
        #: ``embed_net``), and the cards the mesh spans, the first slot's first
        self.mesh = mesh
        self._rows = ([mesh.row_home(r) for r in range(mesh.shape[DP_AXIS])]
                      if mesh.size > 1 else [])
        self._det_nets = _replicas(detector.net, self._rows) if self._rows else [detector.net]
        self._emb_nets = _replicas(self.embed_net, self._rows) if self._rows else [self.embed_net]
        #: across processes a row of another process is ``None`` in
        #: ``_rows`` and the nets' lists; ``embed_frames`` runs this
        #: process's first row's nets
        self._own_row = next((r for r, s in enumerate(self._rows) if s is not None), 0)
        self._devices = list(dict.fromkeys(s.device for s in mesh.local_slots))
        self.face_size = tuple(face_size)
        self.top_k = int(top_k)
        # The fused embed schedule (ops.sepblock, one kernel per stage
        # block): same parameters and math, off by default as in the
        # reference. It is part of every cached step: flip it only before
        # the first step, or clear ``_step_cache``. Like the reference's,
        # it refuses dense blocks and the light norm (no unfused fallback).
        if fused_embedder:
            embedder_mod.check_fusable(embed_net)
        self.fused_embedder = bool(fused_embedder)
        #: capture each step key as a CUDA graph (on a CUDA device)
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self._step_cache: Dict[Tuple, object] = {}
        # one capture at a time: graphs share the pool, and the grow
        # worker's captures race the serving thread's misses
        self._capture_lock = threading.Lock()
        self._pool = torch.cuda.graph_pool_handle() if self.cuda_graphs else None
        #: the graph pools of the mesh's other cards (one per card)
        self._pools: Dict[torch.device, tuple] = {}
        #: graphs captured, those that replaced an entry bound to other
        #: tensors, and each key's latest capture time (ms, host clock)
        self.captures = 0
        self.recaptures = 0
        self.capture_ms: Dict[Tuple, float] = {}
        #: the last packed call's provenance: {"cache_hit", "mode"}, and the
        #: gallery snapshot it matched against
        self.last_dispatch_info: dict = {}
        self.last_snapshot: Optional[GalleryData] = None
        # held while weights are copied in and while a step is queued
        # (module docstring); the stream steps are queued on, for the copies
        self._weights_lock = threading.Lock()
        self._serving_stream = None
        #: {role: version} of the installed weights, as the installs name
        #: them ("detector", "cascade"), and what the last step ran
        self.model_versions: Dict[str, int] = {}
        self.last_model_versions: Dict[str, int] = {}
        #: the stage-1 gate, the net this pipeline serves for it, its cached
        #: passes ((batch, H, W, frame dtype) -> graph or eager callable),
        #: stage-1 graphs captured, and the last pass's {"cache_hit",
        #: "version"}
        self.cascade: Optional[cascade_mod.FaceGate] = None
        self._cascade_net: Optional[cascade_mod.CascadeNet] = None
        self._cascade_cache: Dict[Tuple, object] = {}
        self._cascade_pool = None
        self.cascade_captures = 0
        self.last_cascade_info: dict = {}
        if cascade is not None:
            self.install_cascade(cascade)
        # The gallery's grow machinery captures this pipeline's steps for
        # a new tier before it publishes, and drops stale tiers after.
        gallery.prewarm_hooks.append(self.prewarm_capacity)
        gallery.evict_hooks.append(self.evict_below)

    def _frames_tensor(self, frames) -> torch.Tensor:
        """uint8 frames stay uint8 (4x fewer bytes to the device; the cast
        is in the step); anything else becomes float32."""
        t = torch.as_tensor(frames)
        return t if t.dtype == torch.uint8 else t.to(torch.float32)

    def _step_key(self, frames: torch.Tensor, data: GalleryData, ivf=None) -> Tuple:
        """The reference's cache key, from the call's own snapshots: a
        concurrent grow can never pair one tier's step with another's
        arrays."""
        capacity = data.capacity
        return (*frames.shape, str(frames.dtype).removeprefix("torch."), capacity,
                self.gallery.kernel_enabled(capacity),
                None if ivf is None else ivf.shape_signature())

    @staticmethod
    def _binding(data: GalleryData, ivf) -> Tuple:
        """The tensors a captured graph reads by address (with a mesh, each
        shard's rows too)."""
        shards = (() if data.shards is None
                  else tuple(None if t is None else t.data_ptr()
                             for row in data.shards.emb for t in row))
        return (data.embeddings.data_ptr(), shards,
                None if ivf is None else tuple(t.data_ptr() for t in tuple(ivf)[:7]))

    def _embed(self, frames: torch.Tensor, row: int = 0):
        """Detect -> align -> embed on float32 device frames, with dp row
        ``row``'s nets."""
        det = self.detector
        boxes, det_scores, valid = detector_mod.decode_detections(
            self._det_nets[row](frames), det.max_faces, det.score_threshold,
            det.iou_threshold)
        crops = image_ops.batched_crop_resize(frames, boxes, self.face_size)
        faces = embedder_mod.normalize_faces(
            crops.reshape(-1, *self.face_size), self.face_size)
        if self.fused_embedder:
            emb = embedder_mod.fused_forward(self.embed_net, faces)
        else:
            emb = self._emb_nets[row](faces)
        return boxes, det_scores, valid, emb

    @torch.no_grad()
    def embed_frames(self, frames) -> Tuple[torch.Tensor, ...]:
        """Detect -> align -> embed: [B, H, W] frames -> (boxes [B, K, 4],
        det_scores [B, K], valid [B, K], embeddings [B*K, E] unit-norm)."""
        frames = self._frames_tensor(frames).to(self.device).to(torch.float32)
        return self._embed(frames, self._own_row)

    @torch.no_grad()
    def _forward(self, frames, g_emb, g_valid, g_labels, ivf, match) -> torch.Tensor:
        """The packed step on device frames (uint8 or float32)."""
        boxes, det_scores, valid, emb = self._embed(frames.to(torch.float32))
        args = (emb, g_emb, g_valid, g_labels)
        labels, sims, _ = match(*args, ivf) if ivf is not None else match(*args)
        b, k = valid.shape
        return pack_result(RecognitionResult(
            boxes=boxes, det_scores=det_scores, valid=valid,
            labels=labels.reshape(b, k, -1), similarities=sims.reshape(b, k, -1)))

    def _row_batch(self, batch: int) -> int:
        """Frames per dp row; a batch dp does not divide is refused."""
        dp = len(self._rows)
        if batch % dp:
            raise ValueError(f"frame batch {batch} not divisible by dp={dp}")
        return batch // dp

    @torch.no_grad()
    def _mesh_forward(self, frames, g_emb, g_valid, g_labels, shards, match) -> torch.Tensor:
        """The packed step over the mesh: dp row ``r`` detects, aligns and
        embeds frames ``[r B / dp, (r + 1) B / dp)`` on its first slot of
        this process (that slot's device and stream, forked from and
        joined to the caller's); the embeddings are gathered on this
        process's home slot and matched by ``match`` over ``shards``
        (``match_pod``: kernel A on each shard's slot; or
        ``match_global``). Across processes each process embeds and
        matches only the rows it holds (zeros stand in for the others'),
        and the packed rows come back from their processes by the dp
        result gather (``Mesh.gather_rows``)."""
        per = self._row_batch(frames.shape[0])
        out = self.device
        caller = torch.cuda.current_stream(out) if out.type == "cuda" else None
        start = [e for e in (record_event(out),) if e is not None]
        parts, done = [], []
        for r, slot in enumerate(self._rows):
            if slot is None:
                parts.append(None)
                continue
            with on_slot(slot, start):
                f = frames[r * per:(r + 1) * per].to(slot.device, non_blocking=True)
                parts.append(tuple(_handoff(x.to(out, non_blocking=True), caller)
                                   for x in self._embed(f.to(torch.float32), r)))
                done += [e for e in (record_event(slot.device),) if e is not None]
        for ev in done:
            caller.wait_event(ev)
        held = next(p for p in parts if p is not None)
        parts = [tuple(map(torch.zeros_like, held)) if p is None else p for p in parts]
        boxes, det_scores, valid, emb = (torch.cat(p, dim=0) for p in zip(*parts))
        cross = self.mesh.cross_process
        labels, sims, _ = (match(emb, g_emb, g_valid, g_labels, shards=shards, gather=False)
                           if cross else match(emb, g_emb, g_valid, g_labels, shards=shards))
        b, k = valid.shape
        return self.mesh.gather_rows(pack_result(RecognitionResult(
            boxes=boxes, det_scores=det_scores, valid=valid,
            labels=labels.reshape(b, k, -1), similarities=sims.reshape(b, k, -1))))

    def _build_step(self, key: Tuple, data: GalleryData, ivf):
        """A new cache entry for ``key`` over the snapshots ``data`` and
        ``ivf``: a captured graph on the card (level by level over a mesh),
        else the eager callable."""
        match = self.gallery.match_fn(self.top_k, data.capacity, use_ivf=ivf is not None)
        if not self.cuda_graphs:
            if self._rows:
                return _EagerStep(lambda f, d, iv: self._mesh_forward(
                    f, d.embeddings, d.valid, d.labels, d.shards, match))
            return _EagerStep(lambda f, d, iv: self._forward(
                f, d.embeddings, d.valid, d.labels, iv, match))
        if self._rows:
            return self._capture_levels(key, data)
        return self._capture(key, data, ivf, match)

    def _capture(self, key: Tuple, data: GalleryData, ivf, match) -> _GraphStep:
        """Capture the packed step for ``key`` on a side stream
        (``thread_local`` mode: another thread may allocate or replay
        meanwhile), after ``CAPTURE_WARMUP_RUNS`` eager runs there."""
        batch, height, width, dtype_name = key[:4]
        dev = self.device
        frames = torch.zeros((batch, height, width), dtype=getattr(torch, dtype_name),
                             device=dev)
        valid = data.valid.clone()
        labels = data.labels.clone()

        def run():
            return self._forward(frames, data.embeddings, valid, labels, ivf, match)

        with self._capture_lock:
            held = self._hold_pools()  # noqa: F841 - alive through the capture
            t0 = time.perf_counter()
            graph, out, deltas = self._capture_graph(run)
            self.captures += 1
            self.capture_ms[key] = (time.perf_counter() - t0) * 1e3
        return _GraphStep(graph, frames, valid, labels, out, self._binding(data, ivf),
                          deltas)

    def _hold_pools(self) -> list:
        """Under ``_capture_lock``, before a step capture: the cached steps,
        which the caller holds through the capture so that their graphs keep
        the pools in use; with none, fresh pools for every card, as a
        capture into a pool whose graphs were all freed (``evict_below``
        of every tier, a cleared cache) trips the caching allocator."""
        held = list(self._step_cache.values())
        if not held and self.cuda_graphs:
            self._pool = torch.cuda.graph_pool_handle()
            self._pools = {}
        return held

    def _pool_on(self, device: torch.device):
        """The graph pool of ``device``: the steps' own on the first slot's
        card, one more per other card of the mesh."""
        if device == self.device:
            return self._pool
        if device not in self._pools:
            self._pools[device] = torch.cuda.graph_pool_handle()
        return self._pools[device]

    @torch.no_grad()
    def _capture_levels(self, key: Tuple, data: GalleryData) -> _LevelStep:
        """Capture the mesh step for ``key`` over ``data`` (``_LevelStep``),
        in four levels with a hop after each of the first
        three: (1) each dp row's detect, align and embed on its first slot;
        its embeddings to every slot of the row (the gathered queries' rows
        of that row); (2) each shard's local top-k (``shard_topk``, kernel A
        when the key's kernel flag is set); its candidates to the row's
        first slot; (3) each row's merge (``merge_candidates``); the row's
        boxes, scores, flags, labels and sims to the first slot; (4) the
        packed output there. The same functions on the same inputs as
        ``_mesh_forward``, so the same bits. Across processes the levels
        hold this process's rows and slots only (its first slot of each row
        it holds, its home slot for the pack), and two collectives run
        eagerly between levels, each on its row's or home slot's stream:
        the candidates' all-gather of each row spanning processes after
        level 2, into level 3's static inputs, and the dp result gather
        after level 4, into the step's output."""
        mesh, rows, out_dev = self.mesh, self._rows, self.device
        dp, tp = mesh.devices.shape
        batch, height, width, dtype_name = key[:4]
        per = self._row_batch(batch)
        pod, k, shards, pad = key[5], self.top_k, data.shards, self.gallery.labels_pad
        chunk = shards.chunk
        slots = [mesh.devices[r, t] for r in range(dp) for t in range(tp)]
        local = [i for i, s in enumerate(slots) if mesh.is_local(s)]
        held = [r for r in range(dp) if rows[r] is not None]
        frames = [None if s is None else
                  torch.zeros((per, height, width), dtype=getattr(torch, dtype_name),
                              device=s.device) for s in rows]
        step = _LevelStep(out_dev, self._devices, frames,
                          [[None if v is None else v.clone() for v in row]
                           for row in shards.valid],
                          [None if lab is None else lab.clone() for lab in shards.labels],
                          self._binding(data, None))
        with self._capture_lock:
            held_pools = self._hold_pools()  # noqa: F841 - alive through the capture
            t0 = time.perf_counter()
            found = dict(zip(held, step.level(
                self, [(rows[r], lambda r=r: self._embed(frames[r].to(torch.float32), r))
                       for r in held], self._pool_on)))
            q = dict(zip(local, step.hop([(found[i // tp][3], slots[i].device)
                                          for i in local])))
            cand = step.level(self, [
                (slots[i], lambda i=i: shard_topk(q[i], shards.emb[i // tp][i % tp],
                                                  step.valid[i // tp][i % tp], min(k, chunk),
                                                  (i % tp) * chunk, pod))
                for i in local], self._pool_on)
            moved = step.hop([(x, rows[i // tp].device) for i, c in zip(local, cand) for x in c])
            row_cand = {r: [tuple(moved[2 * j:2 * j + 2]) for j, i in enumerate(local)
                            if i // tp == r] for r in held}
            for r in held:
                if len(mesh.row_ranks(r)) > 1:
                    row_cand[r] = [self._gathered_candidates(step, r, row_cand[r], min(k, chunk))]
            merged = dict(zip(held, step.level(self, [
                (rows[r], lambda r=r: merge_candidates(row_cand[r], k, step.labels[r], pad, pod))
                for r in held], self._pool_on)))
            parts = step.hop([(x, out_dev) for r in held
                              for x in (*found[r][:3], *merged[r][:2])])
            parts = {r: parts[5 * j:5 * j + 5] for j, r in enumerate(held)}

            def pack():
                blank = parts[held[0]]
                boxes, det_scores, valid, labels, sims = (
                    torch.cat([parts[r][j] if r in parts else torch.zeros_like(blank[j])
                               for r in range(dp)], dim=0) for j in range(5))
                b, kf = valid.shape
                return (pack_result(RecognitionResult(
                    boxes=boxes, det_scores=det_scores, valid=valid,
                    labels=labels.reshape(b, kf, -1),
                    similarities=sims.reshape(b, kf, -1))),)

            step.out = step.level(self, [(mesh.home, pack)], self._pool_on)[0][0]
            if mesh.cross_process:
                packed, step.out = step.out, torch.empty_like(step.out)
                step.after(lambda: self._eager_on(
                    mesh.home, lambda: step.out.copy_(mesh.gather_rows(packed))))
            self.captures += 1
            self.capture_ms[key] = (time.perf_counter() - t0) * 1e3
        return step

    @staticmethod
    def _eager_on(slot, fn) -> None:
        """Run ``fn`` eagerly on ``slot``'s stream, forked from and joined
        to its card's current stream (where the levels replay)."""
        with on_slot(slot, [e for e in (record_event(slot.device),) if e is not None]):
            fn()
            done = record_event(slot.device)
        if done is not None:
            torch.cuda.current_stream(slot.device).wait_event(done)

    def _gathered_candidates(self, step: _LevelStep, r: int, mine: list, lk: int) -> tuple:
        """Level 3's static inputs for dp row ``r``, which spans processes:
        (sims, indices) ``[Q, tp * lk]`` of every shard of the row, filled
        by ``_gather_candidates`` over the row's group from this process's
        candidates ``mine`` (level 2's, moved to the row's slot) now and
        after every replay of level 2."""
        home = self._rows[r]
        tp = self.mesh.shape["tp"]
        sims = torch.empty((mine[0][0].shape[0], tp * lk), dtype=torch.float32,
                           device=home.device)
        idx = torch.empty_like(sims, dtype=torch.int32)

        def collect():
            got = _gather_candidates(self.mesh, r, mine, lk)
            sims.copy_(torch.cat([v for v, _ in got], dim=1))
            idx.copy_(torch.cat([i for _, i in got], dim=1))

        step.after(lambda: self._eager_on(home, collect))
        return sims, idx

    def _capture_graph(self, run, pool=None, device=None):
        """(graph, output, launch deltas) of ``run`` captured into ``pool``
        (the steps' by default) on a side stream of ``device`` (the
        pipeline's by default) in ``thread_local`` mode after
        ``CAPTURE_WARMUP_RUNS`` eager runs there; the caller holds
        ``_capture_lock``."""
        dev = self.device if device is None else device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP_RUNS):
                run()
        graph = torch.cuda.CUDAGraph()
        # capture_begin/end, not ``torch.cuda.graph``: its entry runs a
        # device synchronize and ``gc.collect()``, which holds the GIL
        # and so stalls a serving thread while a grow worker captures.
        # The capture launches nothing: its counts go to the replays.
        with _build.capture_tally() as deltas, torch.cuda.device(dev), torch.cuda.stream(side):
            graph.capture_begin(pool=self._pool if pool is None else pool,
                                capture_error_mode="thread_local")
            try:
                out = run()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        return graph, out, deltas

    def _evict_stale_ivf(self, key: Tuple) -> None:
        """Drop cached steps of the same (batch, frame, capacity, kernel)
        whose IVF shape signature a retrain superseded (``evict_below``
        never sees same-capacity churn)."""
        sig = key[6]
        if sig is None:
            return
        for stale in [k for k in list(self._step_cache)
                      if k[:6] == key[:6] and k[6] not in (None, sig)]:
            self._step_cache.pop(stale, None)

    def _step_for(self, frames: torch.Tensor, data: GalleryData, ivf):
        """(cached step, cache hit) for one call's snapshots; a miss
        builds (captures) and caches the step."""
        key = self._step_key(frames, data, ivf)
        step = self._step_cache.get(key)  # fetch once: a grow may evict it
        binding = self._binding(data, ivf) if self.cuda_graphs else None
        if step is not None and step.binding == binding:
            return step, True
        if step is not None:
            self.recaptures += 1
        self._evict_stale_ivf(key)
        step = self._step_cache[key] = self._build_step(key, data, ivf)
        return step, False

    def recognize_batch_packed(self, frames) -> torch.Tensor:
        """The serving step: [B, H, W] frames (float32 or uint8; host
        memory, or a tensor already on the pipeline's device, which no
        path copies through the host again) -> one [B, K, 6 + 2k] f32
        array on the device (``pack_result``; decode on the host with
        ``unpack_result``). On the card it is the graph's static output:
        read it (``_Readback`` copies it on the same stream) before the
        next call of the same key. ``last_snapshot`` is the gallery
        snapshot the step matched against: its ``embedder_version`` stamps
        the results, and holding it keeps its tensors alive while the step
        is queued."""
        frames = self._frames_tensor(frames)
        if frames.device.type == "cuda" and frames.device != self.device:
            raise ValueError(f"frames on {frames.device}, pipeline on {self.device}")
        if self._rows:
            self._row_batch(frames.shape[0])
        data = self.gallery.data  # one snapshot read
        ivf = self.gallery._ivf_data(data)  # one epoch-checked quantizer read
        step, hit = self._step_for(frames, data, ivf)
        self.last_dispatch_info = {"cache_hit": hit,
                                   "mode": "ivf" if ivf is not None else "exact"}
        self.last_snapshot = data
        if not self.cuda_graphs:
            frames = frames.to(self.device)
        with self._weights_lock:
            self._note_serving_stream()
            self.last_model_versions = dict(self.model_versions)
            return step(frames, data, ivf)

    def recognize_batch(self, frames) -> RecognitionResult:
        """The same step, unpacked on the device into new tensors."""
        return _unpack_device(self.recognize_batch_packed(frames), self.top_k)

    # ---- the cascade's stage 1 ----

    def cascade_scores(self, frames) -> torch.Tensor:
        """Stage 1: [B, H, W] frames (uint8 or float32, host or this
        device) -> [B] face-possible probabilities on the device. On the
        card the pass is the graph of its (batch, H, W, dtype), and the
        result is its static output: read it before the next call of the
        same key. Host frames are copied in stream order, so reading the
        scores also fences the frames' buffer. ``last_cascade_info`` is
        ``{"cache_hit", "version"}`` (the recompile watchdog reads the
        first, the result stamps the second)."""
        if self.cascade is None:
            raise RuntimeError("cascade_scores called with no cascade gate")
        frames = self._frames_tensor(frames)
        if frames.device.type == "cuda" and frames.device != self.device:
            raise ValueError(f"frames on {frames.device}, pipeline on {self.device}")
        key = (*frames.shape, str(frames.dtype).removeprefix("torch."))
        with self._weights_lock:
            fn = self._cascade_cache.get(key)
            self.last_cascade_info = {"cache_hit": fn is not None,
                                      "version": self.model_versions.get("cascade")}
            if fn is None:
                fn = self._cascade_cache[key] = self._build_scores(key)
            self._note_serving_stream()
            return fn(frames if self.cuda_graphs else frames.to(self.device))

    def _build_scores(self, key: Tuple):
        """A stage-1 cache entry over the served net: a captured graph on
        the card, else the eager callable. Under ``_weights_lock``."""
        net = self._cascade_net
        if not self.cuda_graphs:
            return torch.no_grad()(lambda f: cascade_mod.frame_scores(net, f.float()))
        batch, height, width, dtype_name = key
        frames = torch.zeros((batch, height, width), dtype=getattr(torch, dtype_name),
                             device=self.device)

        @torch.no_grad()
        def run():
            return cascade_mod.frame_scores(net, frames.float())

        if self._cascade_pool is None:
            self._cascade_pool = torch.cuda.graph_pool_handle()
        with self._capture_lock:
            t0 = time.perf_counter()
            graph, out, _deltas = self._capture_graph(run, self._cascade_pool)
            self.cascade_captures += 1
            self.capture_ms[("cascade", *key)] = (time.perf_counter() - t0) * 1e3
        return _GraphScores(graph, frames, out)

    # ---- installs (the registry's swaps) ----

    def _note_serving_stream(self) -> None:
        if self.device.type == "cuda":
            self._serving_stream = torch.cuda.current_stream(self.device)

    def _on_serving_stream(self):
        """The stream steps are queued on, for an install's copies."""
        if self.device.type != "cuda" or self._serving_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._serving_stream)

    def install_detector_params(self, params: Dict[str, torch.Tensor],
                                version: Optional[int] = None) -> None:
        """Publish new detector weights in place (same architecture),
        atomically against the steps (module docstring): the parameters
        and their cached casts keep their addresses, so every captured
        step runs the new weights on its next replay and none recaptures.
        ``version`` is what the next steps record having run."""
        with self._weights_lock, self._on_serving_stream():
            self.detector.load_params(params)
            if self._rows:  # each other dp row's copy, on the row's stream
                start = [e for e in (record_event(self.device),) if e is not None]
                done = []
                for slot, net in zip(self._rows, self._det_nets):
                    if slot is None or net is self.detector.net:
                        continue  # another process's row, or the one loaded above
                    with on_slot(slot, start):
                        net.load_state_dict(params)
                        done += [e for e in (record_event(slot.device),) if e is not None]
                for ev in done:
                    torch.cuda.current_stream(self.device).wait_event(ev)
            if version is not None:
                self.model_versions["detector"] = int(version)

    def install_cascade(self, gate: Optional[cascade_mod.FaceGate],
                        version: Optional[int] = None) -> None:
        """Serve ``gate`` at stage 1 (None: no stage 1), atomically against
        the passes. A gate of the served architecture (``features``,
        ``downsample``, compute dtype) is copied into the served net in
        place, so its graphs stay; another architecture gets a new net and
        its passes are built again. ``version`` is what the next passes
        record having run."""
        with self._weights_lock, self._on_serving_stream():
            old = self._cascade_net
            if gate is None:
                self._cascade_net = None
                self._cascade_cache.clear()
                self._cascade_pool = None
            elif old is not None and (old.features, old.downsample, old.dtype) == (
                    tuple(gate.net.features), gate.net.downsample, gate.net.dtype):
                old.load_state_dict(gate.net.state_dict())
            else:
                net = cascade_mod.CascadeNet(gate.net.features, gate.net.downsample,
                                             dtype=gate.net.dtype)
                net.load_state_dict(gate.net.state_dict())
                self._cascade_net = net.to(self.device).eval()
                self._cascade_cache.clear()
                self._cascade_pool = None
            self.cascade = gate
            if version is not None:
                self.model_versions["cascade"] = int(version)

    def prewarm_batch_shapes(self, batch_sizes: Sequence[int], frame_shape,
                             dtype=np.float32) -> int:
        """Build (capture) the step of every batch size up front on zero
        frames, and with a cascade gate its stage-1 pass too, so no serving
        batch of these sizes pays a kernel build, an algorithm search or a
        capture. Returns the number of sizes."""
        sizes = sorted({int(b) for b in batch_sizes})
        for b in sizes:
            zeros = np.zeros((b, *frame_shape), dtype)
            self.recognize_batch_packed(zeros).cpu()  # warmup precedes serving: wait
            if self.cascade is not None:
                self.cascade_scores(zeros).cpu()
        return len(sizes)

    def prewarm_capacity(self, capacity: int, data: Optional[GalleryData] = None) -> None:
        """Build the steps of every (batch, frame, dtype) this pipeline has
        served for gallery tier ``capacity``, exact path (a grow's splice
        invalidates the quantizer, so the first call at the new tier is
        exact). ``data`` is the snapshot to capture over: the gallery's
        grow passes one over the tensor it will publish; without it a zero
        scratch gallery of that tier stands in (its graphs would be
        captured again at the first serving call)."""
        g = self.gallery
        served = {key[:4] for key in list(self._step_cache)}
        if not served:
            return
        if data is None:
            data = empty_data(capacity, g.dim, g.store_dtype, g.labels_pad, self.device,
                              g._epoch, mesh=g.mesh)
        binding = self._binding(data, None) if self.cuda_graphs else None
        for batch, height, width, dtype in served:
            key = (batch, height, width, dtype, capacity, g.kernel_enabled(capacity), None)
            step = self._step_cache.get(key)
            if step is not None and step.binding == binding:
                continue
            self._step_cache[key] = self._build_step(key, data, None)

    def evict_below(self, min_capacity: int) -> None:
        """Drop cached steps of gallery tiers strictly below
        ``min_capacity`` (the gallery's ``evict_hooks``); an in-flight call
        already holds its step."""
        for key in [k for k in list(self._step_cache) if k[4] < min_capacity]:
            self._step_cache.pop(key, None)

    def graph_pool_bytes(self) -> Optional[int]:
        """Device bytes of the segments in this pipeline's graph pool
        (``torch.cuda.memory_snapshot``), None without CUDA graphs."""
        if self._pool is None:
            return None
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
