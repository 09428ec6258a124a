"""Pipeline parallelism: port of ``opencv_facerecognizer_tpu/parallel/pp.py``.

Detect and align on the slots of ``mesh_a``; embed and match on the
gallery's mesh (``mesh_b``), whose tp axis still shards the gallery. The
slots of the two meshes must be disjoint (``split_mesh`` halves a mesh
along dp).

- **Stage A**, for each dp row ``r`` of ``mesh_a`` on its first slot (its
  device and stream): the row's frames cast on the device, ``DetectorNet``,
  ``decode_detections`` (kernel C's keep-mask on a card) and
  ``batched_crop_resize``. Each dp row runs its own copy of the detector
  (and in stage B of the embedder) on its slot's device.
- **The hop** moves each row's crops, boxes, scores and valid flags to the
  first slot of the same dp row of ``mesh_b`` (the two meshes have one
  dp): the copies are queued on stage A's stream behind its work
  (``non_blocking``) and stage B waits on an event recorded after them. A
  tensor read on another stream than the one it was made on is handed to
  that stream (``record_stream``), so the caching allocator does not give
  its memory to the next batch while it is read.
- **Stage B**, for each dp row on ``mesh_b``'s first slot of the row:
  ``normalize_faces`` and the unfused ``FaceEmbedNet``; then the embeddings
  of all rows on ``mesh_b``'s first slot go through ``gallery.match_fn``
  (kernel A on each shard's slot once a shard holds
  ``KERNEL_MIN_CAPACITY`` rows on cards, ``parallel.gallery``). Each batch
  reads one ``gallery.data`` snapshot (live: enrolments and swaps land on
  the next batch) and keeps it as ``last_snapshot``.
- ``recognize_stream`` keeps at most one batch in each stage: stage A of
  batch i+1 is queued before batch i is yielded (depth 2), so the two
  stages overlap on their own slots with no host thread.

**Across processes** (a mesh from ``make_mesh`` after
``initialize_multihost``; ``parallel.mesh``'s contract: every process
calls the same methods with the same frames): each process runs stage A
on its rows of ``mesh_a`` and stage B on its rows of ``mesh_b``. Where a
stage-A row and its stage-B row belong to different processes, the hop
sends the row's (boxes, scores, valid, crops) point to point (packed in
one f32 tensor; the reference's ``jax.device_put`` onto stage B's
shardings); within a process it stays a ``.to(device)``. Stage B packs the
rows it holds, and the packed batch comes back to every process by the dp
result gather, landing on this process's home slot (``device``).

The steps run eagerly (no CUDA graphs). Results match the single-mesh
``RecognitionPipeline`` for the same inputs (``tests/test_torch_pp.py``;
across processes ``tests/test_torch_multiprocess.py``).
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Iterator, NamedTuple, Optional, Tuple

import torch

from opencv_facerecognizer_tpu_torch.models import detector as detector_mod
from opencv_facerecognizer_tpu_torch.models import embedder as embedder_mod
from opencv_facerecognizer_tpu_torch.ops import image as image_ops
from opencv_facerecognizer_tpu_torch.parallel.gallery import (
    GalleryData, ShardedGallery, empty_data)
from opencv_facerecognizer_tpu_torch.parallel.mesh import (
    DP_AXIS, Mesh, _handoff, _replicas, on_slot, record_event)
from opencv_facerecognizer_tpu_torch.parallel.pipeline import (
    RecognitionResult, _unpack_device, pack_result)
from opencv_facerecognizer_tpu_torch.utils.device import disable_tf32


def split_mesh(mesh: Mesh) -> Tuple[Mesh, Mesh]:
    """Split a (dp, tp) mesh into two equal stage meshes along dp (an odd
    or single dp is refused: one batch size must be valid on both)."""
    slots = mesh.devices
    dp = slots.shape[0]
    if dp < 2 or dp % 2:
        raise ValueError(
            f"PP needs an even dp >= 2 to split equally (got dp={dp}); "
            "build the mesh with make_mesh(dp=2*n) or use the fused "
            "single-mesh pipeline")
    half = dp // 2
    return Mesh(slots[:half], mesh.comm), Mesh(slots[half:], mesh.comm)


class _StageA(NamedTuple):
    """Stage A's outputs: per dp row of ``mesh_a`` (boxes, scores, valid,
    crops) on the row's first slot, the event behind each row, and the
    frames a row takes."""

    rows: list
    events: list
    per: int


class _Hopped(NamedTuple):
    """The stage boundary on ``mesh_b``: per dp row (boxes, scores, valid,
    crops) on the row's first slot, the events stage B waits for, and the
    frames a row takes."""

    rows: list
    events: list
    per: int


class TwoStagePipeline:
    """Detect and align on ``mesh_a``; embed and match on ``gallery.mesh``
    (module docstring). ``embed_params`` is a state dict for ``embed_net``
    (None: its own weights). A drop-in pipeline for ``RecognizerService``:
    ``recognize_batch_packed`` returns one packed array on ``device``, the
    first slot of ``mesh_b`` (across processes, this process's home
    slot)."""

    def __init__(self, detector: detector_mod.CNNFaceDetector,
                 embed_net: embedder_mod.FaceEmbedNet,
                 embed_params: Optional[Dict[str, torch.Tensor]],
                 gallery: ShardedGallery, mesh_a: Mesh,
                 face_size: Tuple[int, int] = embedder_mod.SERVING_FACE_SIZE,
                 top_k: int = 1):
        mesh_b = gallery.mesh
        overlap = ({s.id for s in mesh_a.devices.flat}
                   & {s.id for s in mesh_b.devices.flat})
        if overlap:
            raise ValueError(
                f"stage meshes share devices {sorted(overlap)}; PP requires "
                "disjoint subsets (use split_mesh, and build the gallery on "
                "the second half)")
        if mesh_a.shape[DP_AXIS] != mesh_b.shape[DP_AXIS]:
            raise ValueError(
                f"stage meshes need one dp (got {mesh_a.shape[DP_AXIS]} and "
                f"{mesh_b.shape[DP_AXIS]}): a dp row of stage A hands its frames to "
                "the same row of stage B (use split_mesh)")
        self.detector = detector
        self.gallery = gallery
        self.face_size = tuple(face_size)
        self.top_k = int(top_k)
        self.mesh_a = mesh_a
        self.mesh_b = mesh_b
        #: where the results (and ``recognize_batch_packed``'s array) land:
        #: this process's first slot of ``mesh_b``, or of ``mesh_a`` where
        #: it holds none of ``mesh_b`` (on one process, ``mesh_b``'s first)
        self.device = (mesh_b.local_slots or mesh_a.local_slots)[0].device
        if any(s.device.type == "cuda" for m in (mesh_a, mesh_b) for s in m.devices.flat):
            disable_tf32()  # the f32 heads and the crop stay full f32
        self.embed_params = embed_params
        if embed_params is not None:
            embed_net = copy.deepcopy(embed_net)
            embed_net.load_state_dict(embed_params)
        #: each dp row's first slot of this process (``None``: another
        #: process's row), and its row of the other stage
        self._rows_a = [mesh_a.row_home(r) for r in range(mesh_a.shape[DP_AXIS])]
        self._rows_b = [mesh_b.row_home(r) for r in range(mesh_b.shape[DP_AXIS])]
        self._peers = [(mesh_a.devices[r, 0].rank, mesh_b.devices[r, 0].rank)
                       for r in range(mesh_a.shape[DP_AXIS])]
        self._det_nets = _replicas(detector.net, self._rows_a)
        self._emb_nets = _replicas(embed_net.eval(), self._rows_b)
        #: the embedder of this process's first stage-B row (dp row 0's on
        #: one process): the service's enrolment path runs it
        self.embed_net = next((n for n in self._emb_nets if n is not None), embed_net)
        #: the gallery snapshot the last batch matched against (its
        #: ``embedder_version`` stamps the results; holding it keeps its
        #: tensors alive while the batch is queued)
        self.last_snapshot: Optional[GalleryData] = None
        #: crop shapes stage B has served, and the tiers ``prewarm_capacity``
        #: ran stage B at (``evict_below`` forgets the stale ones)
        self._served_crop_shapes: set = set()
        self.warmed_capacities: set = set()
        gallery.prewarm_hooks.append(self.prewarm_capacity)
        gallery.evict_hooks.append(self.evict_below)

    # ---- the stages ----

    @torch.no_grad()
    def _submit_a(self, frames) -> _StageA:
        """Stage A on each dp row of ``mesh_a``: host frames (uint8 ride
        as-is and are cast on the device) or a device tensor."""
        frames = torch.as_tensor(frames)
        if frames.dtype != torch.uint8:
            frames = frames.to(torch.float32)
        dp = len(self._rows_a)
        if frames.shape[0] % dp:
            raise ValueError(f"frame batch {frames.shape[0]} not divisible by dp={dp}")
        per = frames.shape[0] // dp
        start = [e for e in (record_event(frames.device),) if e is not None]
        det = self.detector
        rows, events = [], []
        for r, slot in enumerate(self._rows_a):
            if slot is None:  # another process's row
                rows.append(None)
                events.append(None)
                continue
            with on_slot(slot, start):
                f = frames[r * per:(r + 1) * per].to(slot.device, non_blocking=True)
                f = f.to(torch.float32)
                boxes, scores, valid = detector_mod.decode_detections(
                    self._det_nets[r](f), det.max_faces, det.score_threshold,
                    det.iou_threshold)
                crops = image_ops.batched_crop_resize(f, boxes, self.face_size)
                rows.append((boxes, scores, valid, crops))
                events.append(record_event(slot.device))
        return _StageA(rows, events, per)

    @torch.no_grad()
    def _hop(self, a_out: _StageA) -> _Hopped:
        """Move each dp row of stage A to the same dp row of ``mesh_b``:
        the copies are queued on the stage-A stream behind the stage
        (``non_blocking``) and handed to the stage-B stream that reads
        them, with an event after them. A row whose stages belong to two
        processes goes point to point (``_send_rows``)."""
        rows, events, across = [], [], []
        for r, (a, b, row, ev) in enumerate(zip(self._rows_a, self._rows_b, a_out.rows,
                                                a_out.events)):
            rows.append(None)
            events.append([])
            if a is None or b is None:
                across.append(r)
                continue
            with on_slot(a, [e for e in (ev,) if e is not None]):
                rows[r] = tuple(_handoff(x.to(b.device, non_blocking=True), b.stream)
                                for x in row)
                events[r] = [e for e in (record_event(a.device),) if e is not None]
        if across:
            for r, (got, ev) in self._send_rows(a_out, across).items():
                rows[r], events[r] = got, [e for e in (ev,) if e is not None]
        return _Hopped(rows, events, a_out.per)

    def _send_rows(self, a_out: _StageA, across: list) -> dict:
        """The hop between processes: each row of ``across`` this process
        holds in stage A is sent, as one f32 tensor of (boxes, scores,
        valid, crops), to its stage-B process, and each it holds in stage
        B is received from its stage-A process; every send and receive is
        posted before any is awaited, on the current streams (which wait
        for stage A's). Returns {row: ((boxes, scores, valid, crops) on the
        stage-B slot, the event stage B waits for)}."""
        sends, recvs, want = [], [], []
        k = self.detector.max_faces
        for r in across:
            (rank_a, rank_b), a, b = self._peers[r], self._rows_a[r], self._rows_b[r]
            if a is not None:
                row = a_out.rows[r]
                with on_slot(a, [e for e in (a_out.events[r],) if e is not None]):
                    flat = torch.cat([x.float().reshape(-1) for x in row])
                    done = record_event(a.device)
                if done is not None:
                    cur = torch.cuda.current_stream(a.device)
                    cur.wait_event(done)
                    _handoff(flat, cur)
                sends.append((flat, rank_b))
            if b is not None:
                per = a_out.per
                n = per * k * (6 + self.face_size[0] * self.face_size[1])
                recvs.append((torch.empty(n, device=b.device), rank_a))
                want.append((r, per))
        flats = self.mesh_b.comm.exchange(sends, recvs, "hop")
        out = {}
        for (r, per), flat in zip(want, flats):
            fh, fw = self.face_size
            b = self._rows_b[r]
            boxes, scores, valid, crops = flat.split(
                [per * k * 4, per * k, per * k, per * k * fh * fw])
            got = (boxes.view(per, k, 4), scores.view(per, k), valid.view(per, k) > 0.5,
                   crops.view(per, k, fh, fw))
            out[r] = (tuple(_handoff(x, b.stream) for x in got), record_event(b.device))
        return out

    @torch.no_grad()
    def _submit_b(self, hopped: _Hopped, data: Optional[GalleryData] = None
                  ) -> RecognitionResult:
        """Stage B: embed each dp row on its slot, then match the whole
        batch's embeddings against one gallery snapshot (``data``, else
        the live one, kept as ``last_snapshot``). Across processes, this
        process's rows only, the whole batch then by the dp result
        gather."""
        if data is None:
            data = self.gallery.data  # one snapshot read per batch (live)
            self.last_snapshot = data
        out = self.device
        caller = torch.cuda.current_stream(out) if out.type == "cuda" else None
        parts, done = [], []
        for slot, net, row, evs in zip(self._rows_b, self._emb_nets, hopped.rows,
                                       hopped.events):
            if slot is None:  # another process's row
                parts.append(None)
                continue
            boxes, scores, valid, crops = row
            self._served_crop_shapes.add(tuple(crops.shape[1:]))
            with on_slot(slot, evs):
                flat = crops.reshape(-1, *self.face_size)
                emb = net(embedder_mod.normalize_faces(flat, self.face_size))
                parts.append(tuple(_handoff(x.to(out, non_blocking=True), caller)
                                   for x in (boxes, scores, valid, emb)))
                done.append(record_event(slot.device))
        if caller is not None:
            for ev in done:
                caller.wait_event(ev)
        cross = self.mesh_b.cross_process
        held = [p for p in parts if p is not None]
        if not held:  # no row of mesh_b here: the rows come back by the gather
            return _unpack_device(self.mesh_b.gather_rows(torch.zeros(
                (hopped.per * len(parts), self.detector.max_faces, 6 + 2 * self.top_k),
                device=out)), self.top_k)
        parts = [tuple(map(torch.zeros_like, held[0])) if p is None else p for p in parts]
        boxes, scores, valid, emb = (torch.cat(p, dim=0) if len(parts) > 1 else p[0]
                                     for p in zip(*parts))
        match = self.gallery.match_fn(self.top_k, data.capacity, use_ivf=False)
        args = (emb, data.embeddings, data.valid, data.labels)
        labels, sims, _ = (match(*args) if data.shards is None
                           else match(*args, shards=data.shards, gather=False) if cross
                           else match(*args, shards=data.shards))
        b, kf = valid.shape
        result = RecognitionResult(boxes=boxes, det_scores=scores, valid=valid,
                                   labels=labels.reshape(b, kf, -1),
                                   similarities=sims.reshape(b, kf, -1))
        if not cross:
            return result
        return _unpack_device(self.mesh_b.gather_rows(pack_result(result)), self.top_k)

    # ---- the pipeline surface ----

    def recognize_batch(self, frames) -> RecognitionResult:
        """One batch through both stages (no overlap)."""
        return self._submit_b(self._hop(self._submit_a(frames)))

    def recognize_batch_packed(self, frames) -> torch.Tensor:
        """One packed [B, K, 6 + 2k] array on ``device`` (``pack_result``):
        the drop-in for ``RecognizerService``'s one readback a batch."""
        with torch.no_grad():
            return pack_result(self.recognize_batch(frames))

    def recognize_stream(self, frame_batches: Iterable) -> Iterator[RecognitionResult]:
        """Depth-2 stream: stage A of batch i+1 is queued before batch i is
        yielded; at most one batch is in each stage."""
        in_flight = None
        for frames in frame_batches:
            hopped = self._hop(self._submit_a(frames))
            if in_flight is not None:
                yield in_flight
            in_flight = self._submit_b(hopped)
        if in_flight is not None:
            yield in_flight

    # ---- the gallery's grow hooks ----

    def prewarm_capacity(self, capacity: int, data: Optional[GalleryData] = None) -> None:
        """Run stage B once at every crop shape served so far over a
        gallery of ``capacity`` rows (``data``, the snapshot a grow will
        publish, or zero rows) and wait for it: kernel builds and
        algorithm choices happen before the tier serves."""
        shapes = sorted(self._served_crop_shapes)
        if not shapes:
            return
        g = self.gallery
        if data is None:
            data = empty_data(capacity, g.dim, g.store_dtype, g.labels_pad, g.device,
                              g._epoch, mesh=g.mesh)
        for k, fh, fw in shapes:
            rows = [None if s is None else
                    (torch.zeros((1, k, 4), device=s.device),
                     torch.zeros((1, k), device=s.device),
                     torch.zeros((1, k), dtype=torch.bool, device=s.device),
                     torch.zeros((1, k, fh, fw), device=s.device)) for s in self._rows_b]
            self._submit_b(_Hopped(rows, [[] for _ in rows], 1), data).labels.cpu()
        self.warmed_capacities.add(int(capacity))

    def evict_below(self, min_capacity: int) -> None:
        """Forget warmed tiers strictly below ``min_capacity`` (the
        gallery's ``evict_hooks``; eager stage B caches nothing else)."""
        self.warmed_capacities = {c for c in self.warmed_capacities if c >= min_capacity}
