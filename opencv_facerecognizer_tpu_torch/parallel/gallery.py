"""Enrolled gallery: port of ``opencv_facerecognizer_tpu/parallel/gallery.py``,
on one device (``device=``) or row-sharded over a mesh (``mesh=``).

- Fixed ``capacity`` rows; rows beyond ``size`` are invalid and never
  match. ``add`` doubles the capacity when the rows do not fit.
- Host mirrors (float32, L2-normalized) are the enrolment truth; the
  device state is published as one ``GalleryData`` snapshot (one
  attribute write), so a reader never sees a mix of old and new arrays.
- Within a tier ``add`` writes the new rows in place into the live
  embeddings tensor (it keeps its address, so a CUDA graph captured over
  it stays valid; the rows lie outside every older snapshot's ``valid``)
  and publishes new ``valid``/``labels`` tensors, so a snapshot a caller
  holds never changes what it matches. A grow, ``reset``,
  ``load_snapshot`` and ``swap_from`` publish a new embeddings tensor.
- ``async_grow=True`` (the serving configuration): an add that overflows
  the tier stages its rows and returns at once; a worker thread builds
  the next tier off the serving path (``prewarm_hooks`` capture the
  pipelines' steps for it, the old tier's rows are copied on the device,
  the staged rows are normalized, spliced and uploaded in paced chunks
  from pinned memory on a side stream) and publishes once the tier is
  resident. ``pending_rows`` and ``wait_ready`` expose the rows in
  flight; ``evict_hooks`` learn of the replaced tier. An add that fills a
  tier past ``PREWARM_FILL_FRACTION`` warms the next one early.
- ``store_dtype=torch.bfloat16`` halves the gallery's device bytes with
  no change to the match: both matchers round the operands to bf16.
- Matcher selection (``match_fn``) mirrors the reference's: the two-stage
  IVF match (``ops.ivf_match``) when a ready ``CoarseQuantizer`` is
  attached and wanted (``attach_quantizer``: mode ``"auto"`` from
  ``IVF_MIN_CAPACITY`` rows, ``"ivf"`` always, ``"exact"`` never); else
  the streaming kernel (``ops.streaming_match``) on a CUDA device at
  ``capacity >= KERNEL_MIN_CAPACITY``, else the plain matmul + stable
  top-k of ``match_global``; ``use_kernel=`` overrides the second choice.
- The quantizer is derived state the gallery drives: ``add`` assigns the
  new rows under the write lock and then triggers a build when one is
  missing or stale; ``reset``, ``load_snapshot`` and ``swap_from`` bump
  the epoch and invalidate it. Every ``GalleryData`` carries the epoch,
  and ``_ivf_data`` pairs a snapshot only with quantizer state of the
  same epoch.
- The restore paths of the state store and the supervisor:
  ``snapshot`` (host-mirror copies, the lock wait bounded),
  ``load_snapshot`` (install a snapshot, adopting its capacity) and
  ``swap_from`` (install another gallery's contents, cast to this
  gallery's ``store_dtype``).

**On a mesh** (``parallel.mesh``, more than one slot): the capacity is a
multiple of tp; the snapshot holds the whole arrays on the mesh's first
slot (``embeddings``, ``labels``, ``valid``, as reading a sharded array
gives the whole) and ``shards``, each tp shard's rows and flags on every
slot of its tp column (replicated over dp) and the labels on each dp
row's first slot. A shard on the first slot's device is a view of the
whole array, so in-place appends reach it; one on another device is a
copy that an append writes too. Queries split over dp (a count dp does
not divide is refused). The match is ``match_pod`` (kernel A on each
shard's slot, the ``[Q, k]`` candidates merged on each dp row's first
slot) when every slot is a card and a shard holds at least
``KERNEL_MIN_CAPACITY`` rows, else ``match_global`` (a plain product and
a local top-k per shard, the same merge): the two compute the same
function. The reference picks its GSPMD matcher on a mesh because its
compiler cannot partition a custom call; on the card kernel A is ~12x
matmul + top-k (ROADMAP C.18). IVF stays single-device, as the
reference's.

**On a mesh across processes** (``Mesh.cross_process``; the contract is
``parallel.mesh``'s: every process adds the same rows): each process
places only its own slots' shards, each uploaded from the host mirrors
straight to its slot (tp splits the capacity, so no card holds the whole
array): ``embeddings`` is the whole array's shape and dtype on the
``meta`` device, with no storage. ``labels`` and ``valid`` stay whole on
this process's home slot (``Mesh.home``, also ``device``), the labels on
this process's first slot of each dp row it holds; another process's
slot has ``None`` in ``shards``. The host mirrors are whole on every
process, so ``snapshot`` needs no collective. A dp row whose shards span
processes gathers its candidates over the row's group
(``_gather_candidates``) and merges them on every process holding it;
rows of other processes come back by the dp result gather
(``Mesh.gather_rows``). ``async_grow`` is refused there (ROADMAP C.30).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.ops.ivf_match import ivf_match_topk
from opencv_facerecognizer_tpu_torch.ops.nms import stable_topk
from opencv_facerecognizer_tpu_torch.ops.streaming_match import (
    NEG_INF, streaming_match_topk)
from opencv_facerecognizer_tpu_torch.parallel.mesh import (
    DP_AXIS, TP_AXIS, Mesh, _handoff, on_slot, record_event, single_slot_mesh)
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, resolve_device)


log = logging.getLogger(__name__)


def take_labels_with_sentinel(labels: torch.Tensor, idx: torch.Tensor,
                              labels_pad: int) -> torch.Tensor:
    """Gather labels for top-k indices, mapping sentinel ``idx == -1``
    slots (fewer than k valid rows) to the pad label."""
    taken = labels[idx.clamp(min=0).long()]
    return torch.where(idx < 0, torch.full_like(taken, labels_pad), taken)


def _plain_topk(q: torch.Tensor, g: torch.Tensor, valid: torch.Tensor, k: int):
    """bf16 operands, f32 accumulation, invalid rows at -1e30, then a
    stable top-k (ties to the lowest row): (sims [Q, k], rows [Q, k])."""
    sims = q.to(torch.bfloat16).float() @ g.to(torch.bfloat16).float().T
    sims = torch.where(valid[None, :], sims, torch.full_like(sims, NEG_INF))
    return stable_topk(sims, min(k, g.shape[0]))


class MeshShards(NamedTuple):
    """A gallery's arrays placed on a mesh: ``emb[r][t]`` and
    ``valid[r][t]`` tp shard ``t``'s rows and flags on slot ``(r, t)``,
    ``labels[r]`` the whole labels on dp row ``r``'s first slot."""

    chunk: int  # rows per tp shard
    emb: tuple
    valid: tuple
    labels: tuple


def _place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself (or the view it is) on its own device,
    else a copy."""
    return t if t.device == device else t.to(device)


def shard_arrays(mesh: Mesh, g: torch.Tensor, valid: torch.Tensor, labels: torch.Tensor,
                 emb: Optional[tuple] = None) -> MeshShards:
    """Place whole gallery arrays on this process's slots of ``mesh``
    (``MeshShards``; ``None`` for another process's slot or row); ``emb``
    reuses placed rows (only the flags and labels changed)."""
    dp, tp = mesh.devices.shape
    if g.shape[0] % tp:
        raise ValueError(f"capacity {g.shape[0]} is not a multiple of tp={tp}")
    chunk = g.shape[0] // tp

    def rows(x, r, t):
        slot = mesh.devices[r, t]
        return _place(x[t * chunk:(t + 1) * chunk], slot.device) if mesh.is_local(slot) else None

    if emb is None:
        emb = tuple(tuple(rows(g, r, t) for t in range(tp)) for r in range(dp))
    homes = [mesh.row_home(r) for r in range(dp)]
    return MeshShards(chunk, emb,
                      tuple(tuple(rows(valid, r, t) for t in range(tp)) for r in range(dp)),
                      tuple(None if h is None else _place(labels, h.device) for h in homes))


def shard_topk(q: torch.Tensor, g: torch.Tensor, valid: torch.Tensor, k: int, offset: int,
               pod: bool):
    """The local top-k of one shard on its own device: (sims [Q, k], row
    indices [Q, k] int32 offset to the whole gallery). ``pod``: kernel A,
    its ``-1`` sentinels kept; else the plain product."""
    if pod:
        vals, idx = streaming_match_topk(q, g, valid, k=k)
        return vals, torch.where(idx < 0, idx, idx + offset)
    vals, idx = _plain_topk(q, g, valid, k)
    return vals, (idx + offset).to(torch.int32)


def merge_candidates(cand, k: int, labels: torch.Tensor, labels_pad: int, pod: bool):
    """Merge one dp row's ``[(sims, indices)]`` candidates (in shard order)
    on the row's device: a stable top-k, so equal sims keep the lowest
    row. Returns (labels [Q, k], sims [Q, k], indices [Q, k])."""
    cand_v = torch.cat([v for v, _ in cand], dim=1)
    cand_i = torch.cat([i for _, i in cand], dim=1)
    top_v, pos = stable_topk(cand_v, min(k, cand_v.shape[1]))
    top_i = torch.gather(cand_i, 1, pos)
    top_l = (take_labels_with_sentinel(labels, top_i, labels_pad) if pod
             else labels[top_i.long()])
    return top_l, top_v, top_i


def _gather_candidates(mesh: Mesh, r: int, cand: list, lk: int) -> list:
    """Dp row ``r`` spans processes: this process's shards' candidates
    ``[(sims [Q, lk], indices [Q, lk])]`` (in shard order) -> every
    shard's, in shard order, by one all-gather over the row's group (the
    reference's ``jax.lax.all_gather`` over tp: rank order is shard
    order). Sims ride as their int32 bits, so the copy is exact."""
    members = mesh.row_ranks(r)
    counts = [sum(s.rank == m for s in mesh.devices[r]) for m in members]
    width = max(counts) * lk
    mine = torch.cat([torch.cat([v.view(torch.int32) for v, _ in cand], dim=1),
                      torch.cat([i for _, i in cand], dim=1)], dim=1)
    pad = 2 * width - mine.shape[1]
    if pad:  # fewer shards here than on another member: the widths must agree
        half = mine.shape[1] // 2
        mine = torch.nn.functional.pad(mine.view(-1, 2, half), (0, pad // 2)).view(-1, 2 * width)
    every = mesh.comm.all_gather(mine, mesh.comm.row_groups[members], "candidates")
    return [(every[g, :, :c * lk].view(torch.float32), every[g, :, width:width + c * lk])
            for g, c in enumerate(counts)]


def _match_sharded(q: torch.Tensor, shards: MeshShards, *, k: int, mesh: Mesh,
                   pod: bool, labels_pad: int, gather: bool = True):
    """Two-phase top-k over ``shards``: dp row ``r`` takes query rows
    ``r * Q / dp ..``; on each slot ``(r, t)`` of this process (its device
    and stream) a local top-k of shard ``t`` (``shard_topk``); the
    ``tp * k`` candidates (gathered over the row's group where the row
    spans processes) are merged on this process's first slot of row ``r``
    (``merge_candidates``). Results land on this process's home slot
    (``Mesh.home``); across processes the rows of other processes come
    back by the dp result gather, unless ``gather`` is False (they are
    zeros then: a caller that gathers a larger result itself)."""
    dp, tp = mesh.devices.shape
    qn = q.shape[0]
    if qn % dp:
        raise ValueError(f"query count {qn} not divisible by dp={dp}")
    per, chunk, lk = qn // dp, shards.chunk, min(k, shards.chunk)
    out_dev = mesh.home.device
    caller = torch.cuda.current_stream(out_dev) if out_dev.type == "cuda" else None
    start = [e for e in (record_event(q.device),) if e is not None]
    rows, row_done = [], []
    for r in range(dp):
        home = mesh.row_home(r)
        if home is None:
            rows.append(None)
            continue
        cand, done = [], []
        for t in range(tp):
            slot = mesh.devices[r, t]
            if not mesh.is_local(slot):
                continue
            with on_slot(slot, start):
                q_rt = q[r * per:(r + 1) * per].to(slot.device, non_blocking=True)
                found = shard_topk(q_rt, shards.emb[r][t], shards.valid[r][t], lk,
                                   t * chunk, pod)
                cand.append(tuple(_handoff(x.to(home.device, non_blocking=True),
                                           home.stream) for x in found))
                done += [e for e in (record_event(slot.device),) if e is not None]
        with on_slot(home, done):
            if len(mesh.row_ranks(r)) > 1:
                cand = _gather_candidates(mesh, r, cand, lk)
            merged = merge_candidates(cand, k, shards.labels[r], labels_pad, pod)
            rows.append(tuple(_handoff(x.to(out_dev, non_blocking=True), caller)
                              for x in merged))
            row_done += [e for e in (record_event(home.device),) if e is not None]
    if caller is not None:
        for ev in row_done:
            caller.wait_event(ev)
    if not mesh.cross_process:
        return rows[0] if dp == 1 else tuple(torch.cat(parts, dim=0) for parts in zip(*rows))
    kk = min(k, tp * lk)
    blank = (torch.zeros((per, kk), dtype=torch.int32, device=out_dev),
             torch.zeros((per, kk), dtype=torch.float32, device=out_dev),
             torch.zeros((per, kk), dtype=torch.int32, device=out_dev))
    whole = [torch.cat([blank[j] if row is None else row[j].to(blank[j].dtype) for row in rows])
             for j in range(3)]
    if not gather:
        return tuple(whole)
    every = mesh.gather_rows(torch.cat([whole[0], whole[1].view(torch.int32), whole[2]], dim=1))
    return (every[:, :kk].clone(), every[:, kk:2 * kk].view(torch.float32).clone(),
            every[:, 2 * kk:].clone())


def match_global(q: torch.Tensor, g: torch.Tensor, valid: torch.Tensor,
                 labels: torch.Tensor, *, k: int, mesh: Optional[Mesh] = None,
                 shards: Optional[MeshShards] = None, gather: bool = True):
    """The plain matcher (the reference's ``match_global``): bf16
    operands, f32 accumulation, invalid rows at -1e30, a stable top-k
    (ties to the lowest row). Without a mesh (or on one slot) the direct
    top-k on ``g``'s device; on a mesh the two-phase top-k of
    ``_match_sharded`` over ``shards`` (placed from the whole arrays when
    None). Invalid rows surface as in the reference (their rows, -1e30,
    their labels), never as sentinels. Returns (labels [Q, k], sims
    [Q, k], row indices [Q, k] int32); ``gather`` as ``_match_sharded``'s."""
    if mesh is None or not mesh.sharded:
        top_vals, top_idx = _plain_topk(q, g, valid, k)
        return labels[top_idx], top_vals, top_idx.to(torch.int32)
    if shards is None:
        shards = shard_arrays(mesh, g, valid, labels)
    return _match_sharded(q, shards, k=k, mesh=mesh, pod=False, labels_pad=0, gather=gather)


def match_pod(q: torch.Tensor, g: torch.Tensor, valid: torch.Tensor,
              labels: torch.Tensor, *, k: int, mesh: Mesh, labels_pad: int = -1,
              shards: Optional[MeshShards] = None, gather: bool = True):
    """The pod matcher (the reference's ``match_pod_pallas``): kernel A
    (``ops.streaming_match``; its plain version on CPU slots) on each
    shard's own slot, then the merge of ``_match_sharded``. A shard with
    fewer valid rows than k gives ``-1`` indices, never offset into a
    neighbour's rows, and their labels are ``labels_pad``. Returns
    (labels [Q, k], sims [Q, k], row indices [Q, k] int32); ``gather`` as
    ``_match_sharded``'s."""
    if shards is None:
        shards = shard_arrays(mesh, g, valid, labels)
    return _match_sharded(q, shards, k=k, mesh=mesh, pod=True, labels_pad=labels_pad,
                          gather=gather)


class GalleryData(NamedTuple):
    """One immutable snapshot of the device-visible gallery."""

    #: [capacity, dim] in store_dtype; on a mesh across processes a
    #: ``meta`` tensor (shape and dtype, no storage: the rows live in
    #: ``shards``, each process holding its own)
    embeddings: torch.Tensor
    labels: torch.Tensor  # [capacity] int32
    valid: torch.Tensor  # [capacity] bool
    size: int
    #: the gallery's ``_epoch`` at install (``reset`` bumps it): pairs this
    #: snapshot with quantizer state published in the same epoch
    epoch: int = 0
    #: the embedder version whose space these rows live in, published with
    #: them: a reader stamps its results from the snapshot it matched
    #: against, never from a version a concurrent cutover set meanwhile
    #: (ROADMAP C.12)
    embedder_version: int = 1
    #: the arrays placed on a mesh of more than one slot, else None
    shards: Optional[MeshShards] = None

    @property
    def capacity(self) -> int:
        return int(self.embeddings.shape[0])


def empty_data(capacity: int, dim: int, store_dtype: torch.dtype, labels_pad: int,
               device, epoch: int = 0, embeddings: Optional[torch.Tensor] = None,
               mesh: Optional[Mesh] = None) -> GalleryData:
    """A snapshot of ``capacity`` rows with none valid: zero rows (or
    ``embeddings``), pad labels, placed on ``mesh`` when it has more than
    one slot (or spans processes). What a step is warmed or captured over
    before a tier holds its rows."""
    if embeddings is None:
        embeddings = torch.zeros((capacity, dim), dtype=store_dtype, device=device)
    labels = torch.full((capacity,), labels_pad, dtype=torch.int32, device=device)
    valid = torch.zeros((capacity,), dtype=torch.bool, device=device)
    shards = (shard_arrays(mesh, embeddings, valid, labels)
              if mesh is not None and mesh.sharded else None)
    return GalleryData(embeddings=embeddings, labels=labels, valid=valid, size=0,
                       epoch=epoch, shards=shards)


class EmbeddingDimMismatchError(ValueError):
    """``swap_from`` was given a gallery of another embedding dim."""


class ShardedGallery:
    """Enrolled gallery of L2-normalized embeddings on one device, or
    row-sharded over the tp axis of ``mesh``."""

    #: capacity from which the streaming kernel serves the match. 65536 is
    #: the TPU's measured crossover (the reference's PALLAS_MIN_CAPACITY),
    #: kept until an H100 measurement sets this card's own.
    KERNEL_MIN_CAPACITY = 65536

    #: capacity from which ``match_mode="auto"`` serves two-stage (with a
    #: ready quantizer): the reference's TPU crossover, kept until an H100
    #: measurement sets this card's own
    IVF_MIN_CAPACITY = 262144

    #: start warming the next tier once an add fills the gallery past this
    #: fraction (``async_grow``), so the eventual grow finds its steps
    #: captured
    PREWARM_FILL_FRACTION = 0.75

    #: the grow worker gives up waiting for the new tier's upload after this
    #: long and publishes anyway (availability over stall avoidance)
    RESIDENCY_TIMEOUT_S = 300.0

    #: grow-worker uploads larger than 2x this go in chunks of this many
    #: bytes, each awaited before the next is queued, so a serving
    #: transfer waits behind one chunk at most
    CHUNK_UPLOAD_BYTES = 32 * 1024 * 1024

    #: per-chunk pacing deadline; an expiry stops pacing for the rest of
    #: the upload and is flagged in ``last_grow_info["chunk_pacing_timeout"]``
    CHUNK_PACING_TIMEOUT_S = 60.0

    #: poll interval of the residency and pacing waits (a CUDA event query)
    _POLL_S = 0.002

    def __init__(self, capacity: int, dim: int, labels_pad: int = -1,
                 use_kernel: Optional[bool] = None,
                 store_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = DEFAULT_DEVICE, embedder_version: int = 1,
                 async_grow: bool = False, mesh: Optional[Mesh] = None):
        #: the slots the rows live on; ``device=`` means a 1x1 mesh on it
        self.mesh = mesh if mesh is not None else single_slot_mesh(resolve_device(device))
        #: this process's home slot's device (``Mesh.home``; on one process
        #: the mesh's first slot's): the whole ``labels`` and ``valid`` and
        #: the match's results land there
        self.device = self.mesh.home.device
        if async_grow and self.mesh.cross_process:
            raise ValueError(
                "async_grow=True is refused on a mesh across processes (ROADMAP C.30): a "
                "grow would publish at a different moment on each process, so their step "
                "keys and collectives would part; grow synchronously")
        #: the embedder version whose space the rows live in: the service
        #: stamps results and identity-cache entries with it
        self.embedder_version = int(embedder_version)
        tp = self.mesh.shape[TP_AXIS]
        self.capacity = -(-int(capacity) // tp) * tp  # equal tp shards
        self.dim = int(dim)
        self.labels_pad = int(labels_pad)
        self.store_dtype = store_dtype
        self._use_kernel_cfg = use_kernel
        self._write_lock = threading.Lock()
        self.grow_count = 0
        self._epoch = 0  # bumped by reset/load_snapshot/swap_from: fences builds and grows
        # ---- asynchronous grow (off the serving path) ----
        self.async_grow = bool(async_grow)
        #: callables ``hook(capacity, data)`` run before a grow to that
        #: capacity publishes (on the grow worker or the early-warm thread):
        #: ``data`` is a ``GalleryData`` over the embeddings tensor the grow
        #: will publish, so a pipeline captures its steps over it
        self.prewarm_hooks = []
        #: callables ``hook(capacity)`` run after a grow publishes: drop
        #: cached steps of tiers strictly below ``capacity``
        self.evict_hooks = []
        self._pending: list = []  # [[rows, labels, normalized?]] staged by add
        self._pending_count = 0
        self._growing = False
        self._grow_thread: Optional[threading.Thread] = None
        self._grow_done = threading.Event()
        self._grow_done.set()
        self._warmed_capacities = set()
        self._warm_events: Dict[int, threading.Event] = {}
        #: capacity -> the embeddings tensor a grow to it will fill and
        #: publish (made by the first warm of that tier)
        self._next_tier: Dict[int, torch.Tensor] = {}
        self.last_grow_info: dict = {}
        #: optional IVF coarse quantizer and its mode (``attach_quantizer``)
        self.quantizer = None
        self.match_mode = "exact"
        self._host_emb = np.zeros((self.capacity, self.dim), np.float32)
        self._host_lab = np.full((self.capacity,), self.labels_pad, np.int32)
        self._host_val = np.zeros((self.capacity,), bool)
        self._install(0)

    # one attribute read: the only device-state read path
    @property
    def data(self) -> GalleryData:
        return self._data

    # the whole arrays of the live snapshot (on a mesh: on its first slot)
    @property
    def embeddings(self) -> torch.Tensor:
        return self._data.embeddings

    @property
    def labels(self) -> torch.Tensor:
        return self._data.labels

    @property
    def valid(self) -> torch.Tensor:
        return self._data.valid

    @property
    def size(self) -> int:
        return self._data.size

    def _shards(self, emb: torch.Tensor, valid: torch.Tensor, labels: torch.Tensor,
                placed: Optional[tuple] = None) -> Optional[MeshShards]:
        """The snapshot's placement on a mesh of more than one slot (or
        across processes)."""
        if not self.mesh.sharded:
            return None
        return shard_arrays(self.mesh, emb, valid, labels, placed)

    def _upload_rows(self, rows: np.ndarray, device=None) -> torch.Tensor:
        """Host rows cast to ``store_dtype`` on the host (the transfer
        carries the narrow bytes), as a new tensor on ``device`` (default
        the gallery's)."""
        return torch.from_numpy(rows).to(self.store_dtype).to(
            self.device if device is None else device, copy=True)

    def _place_rows(self, host: np.ndarray) -> tuple:
        """A mesh across processes: ``MeshShards.emb`` of ``host`` rows,
        this process's shards uploaded straight to their slots (one tensor
        for each shard and device), ``None`` for another process's."""
        mesh, made = self.mesh, {}
        chunk = host.shape[0] // mesh.shape[TP_AXIS]

        def shard(t, slot):
            if not mesh.is_local(slot):
                return None
            if (t, slot.device) not in made:
                made[t, slot.device] = self._upload_rows(host[t * chunk:(t + 1) * chunk],
                                                         slot.device)
            return made[t, slot.device]

        return tuple(tuple(shard(t, s) for t, s in enumerate(row)) for row in mesh.devices)

    def _sync_mesh(self) -> None:
        """Wait for the current stream of every card of this process's
        slots."""
        for dev in {s.device for s in self.mesh.local_slots}:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    def _install(self, size: int) -> None:
        """Upload the host mirrors and publish one snapshot over a new
        embeddings tensor (copies: a snapshot never aliases the mirrors);
        across processes, over new shard tensors of this process's
        slots."""
        placed = None
        if self.mesh.cross_process:
            emb = torch.empty((self.capacity, self.dim), dtype=self.store_dtype, device="meta")
            placed = self._place_rows(self._host_emb)
        else:
            emb = self._upload_rows(self._host_emb)
        labels = torch.from_numpy(self._host_lab).to(self.device, copy=True)
        valid = torch.from_numpy(self._host_val).to(self.device, copy=True)
        self._data = GalleryData(
            embeddings=emb, labels=labels, valid=valid, size=size, epoch=self._epoch,
            embedder_version=self.embedder_version,
            shards=self._shards(emb, valid, labels, placed))
        self._drop_next_tiers(self.capacity)

    def _append_locked(self, size: int, emb: np.ndarray, lab: np.ndarray) -> None:
        """Publish rows ``size .. size + n`` of the mirrors within the
        tier: the rows written in place into the live embeddings tensor
        (and into each shard copy on another device that holds them), new
        ``valid``/``labels`` tensors (clone + set, so a held snapshot keeps
        its own), one snapshot write; across processes, into this
        process's shard tensors only. Caller holds the write lock."""
        data = self._data
        n = len(emb)
        rows = torch.from_numpy(emb).to(self.store_dtype)
        if not self.mesh.cross_process:
            data.embeddings[size:size + n].copy_(rows)
        valid = data.valid.clone()
        valid[size:size + n] = True
        labels = data.labels.clone()
        labels[size:size + n] = torch.from_numpy(lab).to(self.device)
        shards = None
        if data.shards is not None:
            chunk = data.shards.chunk
            written = set()
            for row in data.shards.emb:
                for t, shard in enumerate(row):
                    lo, hi = max(size, t * chunk), min(size + n, (t + 1) * chunk)
                    if shard is None or lo >= hi or id(shard) in written:
                        continue
                    if self.mesh.cross_process:
                        written.add(id(shard))
                        shard[lo - t * chunk:hi - t * chunk].copy_(rows[lo - size:hi - size])
                    elif shard.device != self.device:
                        shard[lo - t * chunk:hi - t * chunk].copy_(data.embeddings[lo:hi])
            shards = self._shards(data.embeddings, valid, labels, data.shards.emb)
        # the writes are complete before any reader, on any stream, can
        # see the snapshot that makes them matchable
        self._sync_mesh()
        self._data = GalleryData(data.embeddings, labels, valid, size + n, self._epoch,
                                 data.embedder_version, shards)

    @staticmethod
    def _normalize_rows(embeddings: np.ndarray) -> np.ndarray:
        return embeddings / np.maximum(
            np.linalg.norm(embeddings, axis=-1, keepdims=True), 1e-12)

    def add(self, embeddings, labels) -> None:
        """Append rows (L2-normalized here), doubling capacity on overflow.

        Synchronous (default): the rows are matchable on return; within a
        tier they are written in place, a grow uploads the new tier.
        ``async_grow=True``: an add that overflows the tier (or arrives
        while rows are staged) stages its rows raw and returns at once; the
        grow worker normalizes, splices and uploads them, and they are
        matchable once ``wait_ready`` returns True."""
        emb = np.asarray(embeddings, np.float32)
        lab = np.asarray(labels, np.int32)
        if emb.ndim != 2 or emb.shape[1] != self.dim or lab.shape != emb.shape[:1]:
            raise ValueError(f"embeddings [n, {self.dim}] and labels [n] expected, "
                             f"got {emb.shape} and {lab.shape}")
        n = emb.shape[0]
        # Branch predicted outside the lock, so a large synchronous add
        # normalizes without holding it; a lost race only moves the cost.
        normalized = not (self.async_grow and (self._growing or self._pending
                                               or self.size + n > self.capacity))
        # a private copy either way: a staged buffer the caller refills
        # after add() returns must not change the staged rows
        emb = self._normalize_rows(emb) if normalized else np.array(emb, copy=True)
        start_worker = False
        evict_below = None
        with self._write_lock:
            size = self.size
            if self.async_grow and (self._growing or self._pending
                                    or size + n > self.capacity):
                # The worker owns the mirrors while a grow is in flight;
                # pending rows with no worker are a failed grow's, and
                # this add restarts the worker to retry them in order.
                self._pending.append([emb, np.array(lab, copy=True), normalized])
                self._pending_count += n
                if not self._growing:
                    self._growing = True
                    self._grow_done.clear()
                    start_worker = True
            else:
                if not normalized:  # lost the branch-predict race
                    emb = self._normalize_rows(emb)
                grow = size + n > self.capacity
                if grow:
                    evict_below = self.capacity  # the tier being replaced
                    self._grow_locked(size + n)
                self._host_emb[size:size + n] = emb
                self._host_lab[size:size + n] = lab
                self._host_val[size:size + n] = True
                if self.quantizer is not None:
                    # Under the same lock as the mirrors: the rows reach
                    # their cells (or the spill) before the snapshot below
                    # makes them matchable, so the two-stage path never
                    # misses a row the exact path finds.
                    self.quantizer.on_rows_added(emb, size)
                if grow:
                    self._install(size + n)
                else:
                    self._append_locked(size, emb, lab)
        if evict_below is not None:
            self._evict_stale(evict_below)
        if not self._growing:
            self._poke_quantizer()  # outside the lock: may start a build
        if start_worker:
            self._grow_thread = threading.Thread(target=self._grow_worker, daemon=True,
                                                 name="gallery-grow")
            self._grow_thread.start()
        elif (self.async_grow and not self._growing
              and self.size >= self.PREWARM_FILL_FRACTION * self.capacity):
            self._prewarm_async(self._next_capacity(self.capacity + 1))

    @property
    def pending_rows(self) -> int:
        """Rows staged by an asynchronous grow, not yet matchable."""
        return self._pending_count

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the current grow attempt ends (True) or ``timeout``
        passes (False). After a success ``pending_rows == 0``; a failed
        attempt leaves the rows staged and its error in
        ``last_grow_info["error"]``, and the next add retries."""
        return self._grow_done.wait(timeout)

    def _next_capacity(self, needed: int) -> int:
        """Capacity doubled until ``needed`` rows fit, then rounded up to
        a multiple of tp."""
        tp = self.mesh.shape[TP_AXIS]
        new_capacity = max(self.capacity, 1)
        while new_capacity < needed:
            new_capacity *= 2
        return -(-new_capacity // tp) * tp

    def _grow_locked(self, needed: int) -> None:
        new_capacity = self._next_capacity(needed)
        emb = np.zeros((new_capacity, self.dim), np.float32)
        lab = np.full((new_capacity,), self.labels_pad, np.int32)
        val = np.zeros((new_capacity,), bool)
        emb[:self.capacity] = self._host_emb
        lab[:self.capacity] = self._host_lab
        val[:self.capacity] = self._host_val
        self._host_emb, self._host_lab, self._host_val = emb, lab, val
        self.capacity = new_capacity
        self.grow_count += 1

    # ---- warming the next tier ----

    def _next_tier_tensor(self, capacity: int) -> torch.Tensor:
        """The embeddings tensor a grow to ``capacity`` will fill and
        publish, made (zeros, in ``store_dtype``) on first use."""
        with self._write_lock:
            t = self._next_tier.get(capacity)
            if t is None:
                t = self._next_tier[capacity] = torch.zeros(
                    (capacity, self.dim), dtype=self.store_dtype, device=self.device)
            return t

    def _drop_next_tiers(self, upto: int) -> None:
        """Forget warmed tiers of ``upto`` rows or fewer (the gallery is at
        least that large now): their tensors and warm marks go together."""
        for cap in [c for c in self._next_tier if c <= upto]:
            del self._next_tier[cap]
            self._warmed_capacities.discard(cap)

    def _run_prewarm_hooks(self, capacity: int, info: dict) -> None:
        """Warm one tier exactly once across threads: the first caller (the
        early-warm thread or the grow worker) runs the hooks over the
        tier's future embeddings tensor; a concurrent caller for the same
        tier waits for it. A raising hook is recorded in
        ``info["prewarm_errors"]`` (the step is then captured on its first
        serving call instead)."""
        with self._write_lock:
            if capacity in self._warmed_capacities:
                info["prewarm_s"] = 0.0
                return
            ev = self._warm_events.get(capacity)
            owner = ev is None
            if owner:
                ev = self._warm_events[capacity] = threading.Event()
        if not owner:
            ev.wait(timeout=600)
            info["prewarm_s"] = 0.0  # another thread paid for it
            return
        t0 = time.perf_counter()
        try:
            data = empty_data(capacity, self.dim, self.store_dtype, self.labels_pad,
                              self.device, self._epoch,
                              embeddings=self._next_tier_tensor(capacity), mesh=self.mesh)
            for hook in list(self.prewarm_hooks):
                try:
                    hook(capacity, data)
                except Exception as e:  # noqa: BLE001 - recorded; serving captures later
                    info.setdefault("prewarm_errors", []).append(repr(e))
        finally:
            with self._write_lock:
                self._warmed_capacities.add(capacity)
                self._warm_events.pop(capacity, None)
            ev.set()
        info["prewarm_s"] = round(time.perf_counter() - t0, 3)

    def _prewarm_async(self, capacity: int) -> None:
        with self._write_lock:
            started = (capacity in self._warmed_capacities
                       or capacity in self._warm_events)
        if started or not self.prewarm_hooks:
            return
        threading.Thread(target=self._run_prewarm_hooks, args=(capacity, {}),
                         daemon=True, name="gallery-prewarm").start()

    # ---- the grow worker ----

    def _wait_event(self, event, deadline: float, cancel=None, info=None) -> bool:
        """Poll a CUDA event (never a blocking wait) until it completes
        (True), ``cancel()`` turns True (True: the publish check discards
        the doomed tier) or ``deadline`` passes (False). A raising query is
        recorded once in ``info["residency_probe_error"]`` and polling goes
        on."""
        while True:
            if cancel is not None and cancel():
                return True
            try:
                if event is None or event.query():
                    return True
            except RuntimeError as e:
                if info is not None and "residency_probe_error" not in info:
                    info["residency_probe_error"] = repr(e)
            if time.monotonic() >= deadline:
                return False
            time.sleep(self._POLL_S)

    def _await_residency(self, event, timeout_s: float, cancel=None,
                         info=None) -> bool:
        """True once the new tier's uploads (recorded by ``event``) are
        done, or the grow was cancelled; False on timeout."""
        return self._wait_event(event, time.monotonic() + timeout_s, cancel, info)

    def _upload_grown(self, old: GalleryData, emb: np.ndarray, lab: np.ndarray,
                      val: np.ndarray, size: int, pos: int, epoch: int,
                      cancel=None, info=None):
        """The grown tier on the device, unpublished: (GalleryData, event
        behind its uploads or None on the CPU). The old tier's rows are
        copied on the device (they equal the mirrors: nothing writes them
        in place while a grow is in flight), the rest zeroed, and the
        spliced rows ``size .. pos`` uploaded from pinned memory in paced
        chunks of ``CHUNK_UPLOAD_BYTES``, all on a side stream. The tensor
        is the one the tier was warmed over, when it was."""
        target = emb.shape[0]
        with self._write_lock:
            dst = self._next_tier.pop(target, None)
        if dst is None:
            dst = torch.empty((target, self.dim), dtype=self.store_dtype, device=self.device)
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        ctx = torch.cuda.stream(side) if cuda else contextlib.nullcontext()
        if cuda:
            side.wait_stream(torch.cuda.current_stream(self.device))
            dst.record_stream(side)
        old_cap = old.capacity
        with ctx:
            dst[:old_cap].copy_(old.embeddings)
            dst[old_cap:].zero_()
            rows_per_chunk = max(1, self.CHUNK_UPLOAD_BYTES
                                 // (self.dim * dst.element_size()))
            chunked = (pos - size) * self.dim * dst.element_size() > 2 * self.CHUNK_UPLOAD_BYTES
            pacing = chunked and cuda
            for start in range(size, pos, rows_per_chunk):
                if cancel is not None and cancel():
                    break
                end = min(pos, start + rows_per_chunk)
                chunk = torch.from_numpy(emb[start:end]).to(self.store_dtype)
                if cuda:
                    chunk = chunk.pin_memory()
                dst[start:end].copy_(chunk, non_blocking=cuda)
                if pacing:
                    ev = torch.cuda.Event()
                    ev.record(side)
                    pacing = self._wait_event(
                        ev, time.monotonic() + self.CHUNK_PACING_TIMEOUT_S, cancel, info)
                    if not pacing and info is not None:
                        info["chunk_pacing_timeout"] = True
            labels = torch.from_numpy(lab).to(self.device, copy=True)
            valid = torch.from_numpy(val).to(self.device, copy=True)
            shards = self._shards(dst, valid, labels)  # behind the uploads
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record(side)
        data = GalleryData(embeddings=dst, labels=labels, valid=valid, size=pos, epoch=epoch,
                           embedder_version=old.embedder_version, shards=shards)
        return data, event

    def _grow_worker(self) -> None:
        """Off the serving path: warm the next tier (hooks) -> copy the
        mirrors -> normalize the staged rows -> splice -> upload -> await
        residency -> publish atomically. Serving reads the old tier until
        the new one is resident. ``reset``, ``load_snapshot`` and
        ``swap_from`` bump the epoch; it is checked at splice and at
        publish, so they win over an in-flight grow."""
        info: dict = {}
        spliced = None  # popped but unpublished entries, restored on failure
        epoch = None
        try:
            while True:
                spliced = None
                info.pop("residency_timeout", None)
                info.pop("residency_probe_error", None)
                with self._write_lock:
                    if not self._pending:
                        self._growing = False
                        self._grow_done.set()
                        self.last_grow_info = info
                        return
                    epoch = self._epoch
                    old = self._data
                    size = old.size
                    pending_n = self._pending_count
                    old_emb, old_lab, old_val = self._host_emb, self._host_lab, self._host_val
                    old_cap = self.capacity
                target = self._next_capacity(size + pending_n)
                # capture the new tier's steps before taking rows live
                self._run_prewarm_hooks(target, info)
                t0 = time.perf_counter()
                emb = np.zeros((target, self.dim), np.float32)
                lab = np.full((target,), self.labels_pad, np.int32)
                val = np.zeros((target,), bool)
                emb[:old_cap] = old_emb
                lab[:old_cap] = old_lab
                val[:old_cap] = old_val
                info["copy_s"] = round(time.perf_counter() - t0, 3)
                # Normalize the staged rows here, not on the enrolling
                # thread; entries staged after this sweep stay for the
                # next round (the splice stops at the first raw entry).
                t0 = time.perf_counter()
                with self._write_lock:
                    sweep = list(self._pending)
                for entry in sweep:
                    if not entry[2]:
                        entry[0] = self._normalize_rows(entry[0])
                        entry[2] = True
                info["normalize_s"] = round(time.perf_counter() - t0, 3)
                with self._write_lock:
                    if self._epoch != epoch:
                        continue  # superseded by reset/load_snapshot/swap_from
                    fits = []
                    n_fit = 0
                    while self._pending:
                        entry = self._pending[0]
                        if not entry[2] or size + n_fit + len(entry[0]) > target:
                            break
                        fits.append(entry)
                        n_fit += len(entry[0])
                        self._pending.pop(0)
                    spliced = fits
                    pos = size
                    for e_rows, l_rows, _ in fits:
                        emb[pos:pos + len(e_rows)] = e_rows
                        lab[pos:pos + len(e_rows)] = l_rows
                        val[pos:pos + len(e_rows)] = True
                        pos += len(e_rows)
                t0 = time.perf_counter()
                new_data, event = self._upload_grown(
                    old, emb, lab, val, size, pos, epoch,
                    cancel=lambda: self._epoch != epoch, info=info)
                if not self._await_residency(event, self.RESIDENCY_TIMEOUT_S,
                                             cancel=lambda: self._epoch != epoch,
                                             info=info):
                    info["residency_timeout"] = True
                info["upload_wait_s"] = round(time.perf_counter() - t0, 3)
                t0 = time.perf_counter()
                with self._write_lock:
                    if self._epoch != epoch:
                        continue  # the spliced rows go, as reset dropped the rest
                    self._host_emb, self._host_lab, self._host_val = emb, lab, val
                    self.capacity = target
                    self.grow_count += 1
                    self._pending_count -= n_fit
                    if self.quantizer is not None:
                        # a splice lands many rows at once: invalidate and
                        # retrain (poked below) rather than assign them all
                        # under the lock; serving is exact meanwhile
                        self.quantizer.invalidate()
                    self._data = new_data
                    self._drop_next_tiers(target)
                    spliced = None
                info["install_s"] = round(time.perf_counter() - t0, 3)
                self._evict_stale(old_cap)
                self._poke_quantizer()
        except Exception as e:  # noqa: BLE001 - never leave waiters hanging
            info["error"] = repr(e)
            with self._write_lock:
                if spliced and self._epoch == epoch:
                    # popped but never published: back at the head, in
                    # enrolment order, for the next add to retry
                    self._pending[:0] = spliced
                self._growing = False
                self._grow_done.set()
                self.last_grow_info = info

    def _evict_stale(self, below_capacity: int) -> None:
        """After a grow publishes, with the replaced tier as threshold: the
        tiers strictly below it are no longer warm, and every
        ``evict_hooks`` callable drops its cached steps for them (the
        replaced tier survives for readers still holding its snapshot)."""
        with self._write_lock:
            self._warmed_capacities = {c for c in self._warmed_capacities
                                       if c >= below_capacity}
        for hook in list(self.evict_hooks):
            try:
                hook(below_capacity)
            except Exception:  # noqa: BLE001 - a cache's bookkeeping, never serving's
                log.exception("gallery evict hook failed")

    def reset(self) -> None:
        with self._write_lock:
            self._epoch += 1  # an in-flight grow is dropped
            self._pending.clear()
            self._pending_count = 0
            if self.quantizer is not None:
                self.quantizer.invalidate()
            self._host_emb = np.zeros((self.capacity, self.dim), np.float32)
            self._host_lab = np.full((self.capacity,), self.labels_pad, np.int32)
            self._host_val = np.zeros((self.capacity,), bool)
            self._install(0)

    #: bounded wait for the write lock in ``snapshot``: a device transfer
    #: hung inside the locked region must not wedge the caller
    SNAPSHOT_LOCK_TIMEOUT_S = 5.0

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Copies of the host mirrors (embeddings, labels, valid, size),
        no device readback; staged rows are not in them. Taken under the
        write lock when it comes within ``SNAPSHOT_LOCK_TIMEOUT_S``, else
        without it."""
        acquired = self._write_lock.acquire(timeout=self.SNAPSHOT_LOCK_TIMEOUT_S)
        try:
            return (self._host_emb.copy(), self._host_lab.copy(),
                    self._host_val.copy(), self.size)
        finally:
            if acquired:
                self._write_lock.release()

    def snapshot_rows(self, start: int,
                      end: Optional[int]) -> Tuple[np.ndarray, np.ndarray, int]:
        """Rows ``[start, min(end, size))`` of the host mirrors
        (embeddings, labels) and the size, as read-only views taken under
        the write lock as ``snapshot`` takes it; ``end`` None reads to
        the size. No copy: rows below the size are never written again
        (an append writes past it, a grow or load installs new arrays),
        so a view keeps the bytes it was taken with."""
        acquired = self._write_lock.acquire(timeout=self.SNAPSHOT_LOCK_TIMEOUT_S)
        try:
            emb, lab, size = self._host_emb, self._host_lab, int(self.size)
        finally:
            if acquired:
                self._write_lock.release()
        stop = size if end is None else max(start, min(int(end), size))
        emb, lab = emb[start:stop], lab[start:stop]
        emb.flags.writeable = False
        lab.flags.writeable = False
        return emb, lab, size

    def load_snapshot(self, emb: np.ndarray, lab: np.ndarray, val: np.ndarray, size: int,
                      embedder_version: Optional[int] = None) -> None:
        """Install arrays of a prior ``snapshot()`` (or a checkpoint) as
        the live gallery, adopting their capacity; bumps the epoch (an
        in-flight grow and its staged rows are dropped), invalidates the
        quantizer, and re-stamps ``embedder_version`` when given, in the
        same publish."""
        emb = np.array(emb, np.float32, copy=True)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"snapshot must be [capacity, {self.dim}], got {emb.shape}")
        with self._write_lock:
            if embedder_version is not None:
                self.embedder_version = int(embedder_version)
            self._epoch += 1
            self._pending.clear()
            self._pending_count = 0
            if self.quantizer is not None:
                self.quantizer.invalidate()
            self.capacity = emb.shape[0]
            self._host_emb = emb
            self._host_lab = np.array(lab, np.int32, copy=True)
            self._host_val = np.array(val, bool, copy=True)
            self._install(int(size))

    def swap_from(self, other: "ShardedGallery") -> None:
        """Install ``other``'s contents (the double-buffered reload): the
        host mirrors by reference, the device arrays as they are, or
        rebuilt from the mirrors when ``other`` stores another dtype or
        lives on another device. Adopts its ``embedder_version``; drops an
        in-flight grow; a dim mismatch raises
        ``EmbeddingDimMismatchError``."""
        if other.dim != self.dim:
            raise EmbeddingDimMismatchError(
                f"swap_from refused: donor gallery dim {other.dim} != serving dim "
                f"{self.dim}; a different-D embedder rolls out through the staged "
                f"re-embed, never a swap")
        rebuild = (other.store_dtype != self.store_dtype
                   or other.mesh.layout() != self.mesh.layout())
        with self._write_lock:
            self.embedder_version = int(getattr(other, "embedder_version",
                                                self.embedder_version))
            self._epoch += 1
            self._pending.clear()
            self._pending_count = 0
            if self.quantizer is not None:
                self.quantizer.invalidate()
            self.capacity = other.capacity
            self._host_emb = other._host_emb
            self._host_lab = other._host_lab
            self._host_val = other._host_val
            if rebuild:
                self._install(other.size)
            else:
                # restamped with this gallery's epoch, or the quantizer's
                # publishes would never pair with it
                self._data = other._data._replace(epoch=self._epoch,
                                                  embedder_version=self.embedder_version)
                self._drop_next_tiers(self.capacity)
        self._poke_quantizer()

    # ---- IVF coarse quantizer (parallel.quantizer) ----

    def attach_quantizer(self, quantizer, mode: str = "auto") -> None:
        """Make ``quantizer`` this gallery's shortlist front end, in mode
        ``"auto"`` (exact below ``IVF_MIN_CAPACITY``, two-stage from it),
        ``"ivf"`` (two-stage whenever ready) or ``"exact"`` (never
        consulted)."""
        if mode not in ("auto", "ivf", "exact"):
            raise ValueError(f"match mode must be auto|ivf|exact, got {mode!r}")
        quantizer._gallery = self
        self.quantizer = quantizer
        self.match_mode = mode

    def run_locked(self, fn):
        """Run ``fn`` under the write lock: the quantizer publishes through
        it (it has no lock of its own, so the lock order stays a tree)."""
        with self._write_lock:
            return fn()

    def snapshot_quantizer(self):
        """The quantizer's sidecar payload, taken under the write lock, or
        None when there is no ready quantizer."""
        if self.quantizer is None:
            return None
        with self._write_lock:
            return self.quantizer.sidecar_payload_locked()

    def _ivf_wanted(self, capacity: Optional[int] = None) -> bool:
        """Would this gallery use a ready quantizer at ``capacity``? (Mode
        and threshold only: the build trigger asks before any build.)"""
        if self.quantizer is None or self.match_mode == "exact":
            return False
        if self.mesh.sharded:
            return False  # the two-stage path is single-device, as the reference's
        if self.match_mode == "ivf":
            return True
        return ((self.capacity if capacity is None else capacity)
                >= self.IVF_MIN_CAPACITY)

    def _ivf_enabled(self, capacity: Optional[int] = None) -> bool:
        return self._ivf_wanted(capacity) and self.quantizer.ready

    def _ivf_data(self, data: GalleryData):
        """The quantizer snapshot to pair with the gallery snapshot
        ``data``, or None for the exact path: one read of
        ``quantizer.data``, rejected unless its epoch is ``data``'s (the
        two reads are not atomic; a cross-epoch pair would score one row
        set against another's lists)."""
        if not self._ivf_wanted(data.capacity):
            return None
        ivf = self.quantizer.data  # None when invalidated or not built
        if ivf is None or ivf.gallery_epoch != data.epoch:
            return None
        return ivf

    def _poke_quantizer(self) -> None:
        """Start a background build when the quantizer is wanted but not
        ready, or stale (after enrolments; never on the match path)."""
        q = self.quantizer
        if q is None:
            return
        if not q.ready:
            if self._ivf_wanted() and self.size > 0:
                q.maybe_rebuild_async()
        elif q.stale():
            q.maybe_rebuild_async()

    def kernel_enabled(self, capacity: Optional[int] = None) -> bool:
        """Streaming-kernel selection (the reference's ``_pallas_enabled``):
        forced by ``use_kernel``, else every slot a card and each tp
        shard (the whole gallery on one device) holding at least
        ``KERNEL_MIN_CAPACITY`` rows. On a mesh it picks ``match_pod``
        over ``match_global`` (C.18)."""
        if self._use_kernel_cfg is not None:
            return bool(self._use_kernel_cfg)
        cap = self.capacity if capacity is None else capacity
        return (all(s.device.type == "cuda" for s in self.mesh.devices.flat)
                and cap // self.mesh.shape[TP_AXIS] >= self.KERNEL_MIN_CAPACITY)

    def match_fn(self, k: int, capacity: Optional[int] = None,
                 use_ivf: Optional[bool] = None):
        """Match function with the selection applied, shared by ``match``
        and the serving pipeline: ``(q, g, valid, labels) -> (labels
        [Q, k], sims [Q, k], indices [Q, k])``, or with the two-stage path
        ``(q, g, valid, labels, ivf)``, ``ivf`` the ``IVFDeviceData`` from
        ``_ivf_data`` (``g`` then rides along unused). Callers read
        ``_ivf_data`` once and pin their choice with ``use_ivf``, so an
        invalidation between the read and this call cannot change the
        arity under them; ``None`` derives it (``_ivf_enabled``)."""
        if self._ivf_enabled(capacity) if use_ivf is None else use_ivf:
            labels_pad = self.labels_pad
            nprobe = self.quantizer.nprobe

            def ivf_fn(q, g, valid, labels, ivf):
                vals, idx = ivf_match_topk(q, valid, ivf, k=k, nprobe=nprobe)
                return take_labels_with_sentinel(labels, idx, labels_pad), vals, idx

            return ivf_fn
        if self.mesh.sharded:
            mesh, labels_pad = self.mesh, self.labels_pad
            if self.kernel_enabled(capacity):
                def pod(q, g, valid, labels, shards=None, gather=True):
                    return match_pod(q, g, valid, labels, k=k, mesh=mesh,
                                     labels_pad=labels_pad, shards=shards, gather=gather)

                return pod

            def sharded(q, g, valid, labels, shards=None, gather=True):
                return match_global(q, g, valid, labels, k=k, mesh=mesh, shards=shards,
                                    gather=gather)

            return sharded
        if self.kernel_enabled(capacity):
            labels_pad = self.labels_pad

            def fn(q, g, valid, labels):
                vals, idx = streaming_match_topk(q, g, valid, k=k)
                return take_labels_with_sentinel(labels, idx, labels_pad), vals, idx

            return fn

        def plain(q, g, valid, labels):
            return match_global(q, g, valid, labels, k=k)

        return plain

    @torch.no_grad()
    def match(self, queries, k: int = 1):
        """[Q, D] L2-normalized queries -> (labels [Q, k], cosine sims
        [Q, k], row indices [Q, k]) on the gallery's device (this
        process's home slot; across processes every process calls it with
        the same queries and gets the whole result); Q must divide by the
        dp axis size."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be [Q, {self.dim}], got {tuple(q.shape)}")
        dp = self.mesh.shape[DP_AXIS]
        if q.shape[0] % dp:
            raise ValueError(f"query count {q.shape[0]} not divisible by dp={dp}")
        data = self._data  # one snapshot read
        ivf = self._ivf_data(data)  # one epoch-checked quantizer read
        fn = self.match_fn(int(k), data.capacity, use_ivf=ivf is not None)
        args = (q, data.embeddings, data.valid, data.labels)
        if ivf is not None:
            return fn(*args, ivf)
        return fn(*args) if data.shards is None else fn(*args, shards=data.shards)
