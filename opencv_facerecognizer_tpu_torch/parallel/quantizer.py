"""IVF coarse quantizer: the front end of the two-stage match for galleries
of a million identities and more.

Port of ``opencv_facerecognizer_tpu/parallel/quantizer.py`` on one device.
A seeded spherical k-means carves the gallery into ``nlist`` cells; each
cell keeps its member rows as an int8-quantized, cell-resident inverted
list (``[nlist, max_cell, D]``, so a shortlisted cell gathers as one dense
block), and rows past ``max_cell`` go to an always-scanned spill.
``ops.ivf_match`` matches against the published ``IVFDeviceData``.

The quantizer is derived state of its ``ShardedGallery``, never a second
source of truth, and the gallery drives its lifecycle:

- **rebuild** (``rebuild_now``, ``maybe_rebuild_async``): snapshot the
  host mirrors, train k-means on a row sample, assign every row, pack and
  upload, then publish under the gallery's write lock with a catch-up
  pass for rows enrolled meanwhile. An epoch fence drops a build that a
  ``reset`` overtook (and fires one fresh build). One build at a time; an
  overlapping trigger is counted and dropped; a failed build leaves the
  previous state (or the exact path) serving.
- **incremental assignment** (``on_rows_added``, from ``gallery.add``
  under its write lock): new rows go to their nearest centroid's list, or
  the spill when the cell is full; a row that fits neither invalidates
  the quantizer rather than going missing.
- **invalidate** on ``reset``: serving falls back to the exact matcher
  until a rebuild publishes.
- **sidecar** (``encode_sidecar``/``decode_sidecar``,
  ``install_from_arrays``): the trained centroids and the assignment, in
  the reference's byte format, so a quantizer trained by either package
  loads in the other.

Semantics kept from the reference: ``quantize_rows`` and
``pack_inverted_lists`` are the same numpy code, so the lists are equal
bit for bit given the same assignment; assignment is an f32 product (TF32
off) and a first-max argmax, in the same power-of-two pad tiers up to
``ASSIGN_CHUNK`` rows, so a replayed record runs the shape its live
enrolment ran. One divergence: the reference draws the k-means init with
``jax.random.permutation``; this port draws it with
``np.random.default_rng(seed)``, so one seed trains other centroids in
the two packages (``_kmeans`` takes ``init=`` to be held to the
reference given the same init, and a sidecar carries centroids across).
"""

from __future__ import annotations

import binascii
import hashlib
import json
import logging
import threading
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils.tracing import LIFECYCLE_TOPIC
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, disable_tf32, resolve_device)

#: sidecar file magic and format: the reference's, byte for byte
SIDECAR_MAGIC = b"OCVFIVF\n"
SIDECAR_FORMAT_VERSION = 1

#: assignment chunk ceiling: rows are scored against the centroids in
#: chunks padded to a power-of-two tier (8 .. ASSIGN_CHUNK), so a record
#: re-assigned on replay runs the same product shape its live enrolment
#: ran, and gets the same cells
ASSIGN_CHUNK = 8192


class SidecarError(ValueError):
    """The sidecar is corrupt, truncated or fails its checksum: the
    caller retrains, never half-loads."""


class IVFDeviceData(NamedTuple):
    """One immutable snapshot of the device-side quantizer state, read
    with one attribute load like ``GalleryData``. Row payloads are int8
    with a per-row scale; a shortlisted cell is one dense [max_cell, D]
    block."""

    centroids: torch.Tensor  # [nlist, D] f32, L2-normalized
    cell_rows: torch.Tensor  # [nlist, max_cell] int32 gallery row ids, -1 pad
    cell_q8: torch.Tensor  # [nlist, max_cell, D] int8 quantized rows
    cell_scale: torch.Tensor  # [nlist, max_cell] f32 per-row scale
    spill_rows: torch.Tensor  # [spill_cap] int32 overflow row ids, -1 pad
    spill_q8: torch.Tensor  # [spill_cap, D] int8
    spill_scale: torch.Tensor  # [spill_cap] f32
    #: gallery ``_epoch`` at publish: ``ShardedGallery._ivf_data`` pairs
    #: this snapshot only with a ``GalleryData`` of the same epoch
    gallery_epoch: int = 0

    @property
    def nlist(self) -> int:
        return int(self.cell_rows.shape[0])

    @property
    def max_cell(self) -> int:
        return int(self.cell_rows.shape[1])

    @property
    def spill_cap(self) -> int:
        return int(self.spill_rows.shape[0])

    def shape_signature(self) -> Tuple[int, int, int]:
        """(nlist, max_cell, spill_cap): the shapes a match over this
        snapshot runs at."""
        return (self.nlist, self.max_cell, self.spill_cap)


def pack_inverted_lists(ids: np.ndarray, cells: np.ndarray, q8: np.ndarray,
                        scale: np.ndarray, nlist: int,
                        cell_slack: float = 2.0, spill_floor: int = 0,
                        sizing_rows: Optional[int] = None):
    """Pack assigned rows into the cell-resident structures: ``(cell_rows,
    cell_q8, cell_scale, spill_rows, spill_q8, spill_scale, counts,
    overflow)``. Rows fill their cell in ascending row-id order; rows past
    ``max_cell`` land in the spill, also ascending: the order incremental
    inserts produce. ``max_cell`` is sized from ``sizing_rows`` (default:
    the rows packed here). The reference's numpy code, plus
    ``sizing_rows``."""
    ids = np.asarray(ids, np.int32)
    cells = np.asarray(cells, np.int32)
    q8 = np.asarray(q8, np.int8)
    scale = np.asarray(scale, np.float32)
    n, dim = q8.shape
    mean = max(1.0, (n if sizing_rows is None else int(sizing_rows)) / max(1, nlist))
    max_cell = max(8, int(np.ceil(cell_slack * mean / 8.0) * 8))
    order = np.lexsort((ids, cells))
    s_ids, s_cells = ids[order], cells[order]
    counts = np.bincount(s_cells, minlength=nlist).astype(np.int64)
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(n, dtype=np.int64) - starts[s_cells]
    in_cell = pos < max_cell
    overflow = int(n - in_cell.sum())
    spill_cap = int(np.ceil((max(overflow, spill_floor) + 256) / 256.0) * 256)
    cell_rows = np.full((nlist, max_cell), -1, np.int32)
    cell_q8 = np.zeros((nlist, max_cell, dim), np.int8)
    cell_scale = np.zeros((nlist, max_cell), np.float32)
    cr, cp = s_cells[in_cell], pos[in_cell]
    cell_rows[cr, cp] = s_ids[in_cell]
    cell_q8[cr, cp] = q8[order][in_cell]
    cell_scale[cr, cp] = scale[order][in_cell]
    spill_rows = np.full((spill_cap,), -1, np.int32)
    spill_q8 = np.zeros((spill_cap, dim), np.int8)
    spill_scale = np.zeros((spill_cap,), np.float32)
    if overflow:
        sp_order = np.argsort(s_ids[~in_cell])
        spill_rows[:overflow] = s_ids[~in_cell][sp_order]
        spill_q8[:overflow] = q8[order][~in_cell][sp_order]
        spill_scale[:overflow] = scale[order][~in_cell][sp_order]
    counts_clamped = np.minimum(counts, max_cell).astype(np.int32)
    return (cell_rows, cell_q8, cell_scale, spill_rows, spill_q8,
            spill_scale, counts_clamped, overflow)


def quantize_rows(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization, ``row ~= q8 * scale`` (numpy,
    as in the reference, so the int8 bits are the same)."""
    rows = np.asarray(rows, np.float32)
    scale = np.max(np.abs(rows), axis=-1) / 127.0
    scale = np.maximum(scale, np.float32(1e-12)).astype(np.float32)
    q8 = np.clip(np.rint(rows / scale[..., None]), -127, 127).astype(np.int8)
    return q8, scale


def kmeans_init(rows: np.ndarray, nlist: int, seed: int) -> np.ndarray:
    """The port's k-means init: ``nlist`` rows picked by a permutation
    from ``np.random.default_rng(seed)`` (the reference draws its
    permutation from ``jax.random``, which the port does not have)."""
    s = rows.shape[0]
    perm = np.random.default_rng(int(seed)).permutation(s)
    return np.asarray(rows, np.float32)[perm[np.arange(nlist) % s]]


def _kmeans(rows: np.ndarray, nlist: int, iters: int, seed: int, *,
            device: DeviceLike = DEFAULT_DEVICE,
            init: Optional[np.ndarray] = None) -> np.ndarray:
    """Seeded spherical k-means in f32 on ``device``: centroids stay
    L2-normalized; an empty cell keeps its previous centroid. The same
    rows and init give bit-identical centroids run to run: the products
    run with TF32 off, and the per-cell sums are a one-hot product over
    fixed row chunks, never float atomics (``index_add_`` on a card is
    not deterministic)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    rows = np.asarray(rows, np.float32)
    if init is None:
        init = kmeans_init(rows, nlist, seed)
    x = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    c = torch.tensor(np.asarray(init, np.float32), device=dev)
    cells = torch.arange(nlist, device=dev)
    for _ in range(max(1, int(iters))):
        assign = torch.argmax(x @ c.T, dim=1)
        sums = torch.zeros_like(c)
        counts = torch.zeros(nlist, dtype=torch.float32, device=dev)
        for off in range(0, x.shape[0], ASSIGN_CHUNK):
            onehot = (assign[off:off + ASSIGN_CHUNK, None] == cells).to(torch.float32)
            sums += onehot.T @ x[off:off + ASSIGN_CHUNK]
            counts += onehot.sum(dim=0)
        mean = sums / torch.clamp(counts, min=1.0)[:, None]
        norm = torch.linalg.vector_norm(mean, dim=1, keepdim=True)
        newc = mean / torch.clamp(norm, min=1e-12)
        c = torch.where((counts > 0)[:, None], newc, c)
    return c.cpu().numpy()


class CoarseQuantizer:
    """Seeded k-means coarse quantizer over a ``ShardedGallery``'s rows,
    with int8 cell-resident inverted lists and an always-exact spill, on
    the gallery's device.

    Attach with ``gallery.attach_quantizer(quantizer, mode=...)``; the
    gallery then drives every lifecycle edge (module docstring). The
    matcher is ``ops.ivf_match.ivf_match_topk`` over ``self.data``.
    """

    #: spill fill that marks the quantizer stale (the spill is scanned on
    #: every match, so a full spill costs time, never recall)
    SPILL_STALE_FRACTION = 0.75

    #: gallery growth past the trained row set that marks it stale
    GROWTH_STALE_FACTOR = 1.5

    #: per-cell slack over the perfectly balanced size; rows past it spill
    CELL_SLACK = 2.0

    def __init__(self, nlist: int = 1024, nprobe: int = 8, seed: int = 0,
                 kmeans_iters: int = 10, train_sample: int = 131072,
                 metrics=None, auto_nlist: bool = False):
        #: with ``auto_nlist`` the cell count follows the row count at
        #: every rebuild (and the sidecar's on install)
        self.auto_nlist = bool(auto_nlist)
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.seed = int(seed)
        self.kmeans_iters = int(kmeans_iters)
        self.train_sample = int(train_sample)
        self.metrics = metrics
        #: ``utils.tracing.Tracer``: an ``ivf_retrain`` lifecycle span per
        #: build attempt, emitted after the single-flight guard is released
        self.tracer = None
        self._gallery = None  # set by ShardedGallery.attach_quantizer
        #: the published device snapshot; None: not ready, serving takes
        #: the exact matcher
        self._data: Optional[IVFDeviceData] = None
        self.version = 0
        self.trained_size = 0
        #: seconds of each stage of the last build that reached its publish
        #: ("kmeans", "assign", "pack", "upload")
        self.last_build_s: Dict[str, float] = {}
        # host mirrors, mutated only under the gallery's write lock
        self._h_centroids: Optional[np.ndarray] = None
        self._h_assign = np.zeros((0,), np.int32)  # [capacity] cell or -1
        self._h_counts: Optional[np.ndarray] = None  # [nlist] rows per cell
        self._spill_count = 0
        self._assigned_rows = 0  # row-id high-water the lists cover
        # single-flight build guard: one build at a time; an overlapping
        # trigger is counted and dropped
        self._train_lock = threading.Lock()
        #: set when the epoch fence dropped a build: rebuild_now fires one
        #: fresh build after releasing the guard (the invalidation's own
        #: trigger was dropped as in flight)
        self._fence_refire = False
        #: device copy of ``_h_centroids``, made at the first assignment
        #: after a (re)build, not on every enrolment
        self._c_dev: Optional[torch.Tensor] = None

    @staticmethod
    def default_nlist(rows: int) -> int:
        """~4 * sqrt(rows) rounded up to a power of two, clamped to
        [64, 16384]."""
        target = 4.0 * np.sqrt(max(1, int(rows)))
        nlist = 64
        while nlist < target and nlist < 16384:
            nlist *= 2
        return nlist

    # ---- read side ----

    @property
    def ready(self) -> bool:
        return self._data is not None

    @property
    def data(self) -> Optional[IVFDeviceData]:
        return self._data

    @property
    def spill_count(self) -> int:
        return self._spill_count

    def stats(self) -> Dict[str, Any]:
        data = self._data
        return {
            "ready": data is not None,
            "version": self.version,
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "trained_size": self.trained_size,
            "assigned_rows": self._assigned_rows,
            "spill_count": self._spill_count,
            "spill_cap": 0 if data is None else data.spill_cap,
            "max_cell": 0 if data is None else data.max_cell,
        }

    def _device(self) -> torch.device:
        if self._gallery is None:
            raise RuntimeError("quantizer not attached to a gallery")
        return self._gallery.device

    # ---- assignment: the one routine every path shares ----

    @staticmethod
    def _pad_tier(n: int) -> int:
        """Power-of-two pad tier (8 .. ASSIGN_CHUNK) for a chunk of n rows."""
        tier = 8
        while tier < n:
            tier *= 2
        return min(tier, ASSIGN_CHUNK)

    def assign_rows(self, rows: np.ndarray,
                    centroids: Optional[np.ndarray] = None) -> np.ndarray:
        """Nearest-centroid cell ids of L2-normalized rows, shared by the
        bulk build, incremental enrolment and a repack: an f32 product
        with TF32 off, in pad-tier chunks (``_pad_tier``), and the first
        maximum (ties to the lowest cell id, as the stage-1 shortlist)."""
        if centroids is None:
            centroids = self._h_centroids
        if centroids is None:
            raise RuntimeError("quantizer has no centroids: build first")
        dev = self._device()
        if dev.type == "cuda":
            disable_tf32()
        if centroids is self._h_centroids:
            if self._c_dev is None:
                self._c_dev = torch.tensor(centroids, device=dev)
            c_dev = self._c_dev
        else:
            c_dev = torch.tensor(np.asarray(centroids, np.float32), device=dev)
        rows = np.asarray(rows, np.float32)
        n = rows.shape[0]
        outs = []
        for off in range(0, n, ASSIGN_CHUNK):
            chunk = rows[off:off + ASSIGN_CHUNK]
            got_n = chunk.shape[0]
            pad = self._pad_tier(got_n) - got_n
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
            outs.append(torch.argmax(x @ c_dev.T, dim=1)[:got_n])
        if not outs:
            return np.empty((0,), np.int32)
        return torch.cat(outs).to(torch.int32).cpu().numpy()

    # ---- building (bulk) ----

    def _pack(self, emb: np.ndarray, val: np.ndarray, assign: np.ndarray,
              spill_floor: int = 0, sizing_rows: Optional[int] = None):
        """Quantize the valid rows and pack them (``pack_inverted_lists``)."""
        ids = np.nonzero(val)[0].astype(np.int32)
        q8, scale = quantize_rows(emb[ids])
        return pack_inverted_lists(ids, assign[ids], q8, scale, self.nlist,
                                   cell_slack=self.CELL_SLACK,
                                   spill_floor=spill_floor, sizing_rows=sizing_rows)

    def _device_put(self, centroids, cell_rows, cell_q8, cell_scale,
                    spill_rows, spill_q8, spill_scale) -> IVFDeviceData:
        dev = self._device()
        return IVFDeviceData(*(
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (centroids, cell_rows, cell_q8, cell_scale, spill_rows,
                      spill_q8, spill_scale)))

    def rebuild_now(self, wait: bool = True,
                    skip_if_ready: bool = False) -> bool:
        """One full retrain (module docstring). Returns False when another
        build holds the single-flight guard (and ``wait`` is False), the
        epoch fence dropped it, or it failed (counted
        ``ivf_build_failures``; the previous state keeps serving).
        ``skip_if_ready`` makes it "ensure built": with ``wait`` it rides
        out a build in flight and returns True without retraining when a
        build has published."""
        if self._gallery is None:
            raise RuntimeError("quantizer not attached to a gallery")
        if not self._train_lock.acquire(blocking=wait):
            if self.metrics is not None:
                self.metrics.incr(mn.IVF_RETRAINS_SKIPPED_INFLIGHT)
            return False
        span_t0 = time.monotonic()
        outcome = "failed"
        try:
            if skip_if_ready and self._data is not None:
                outcome = "already_ready"
                return True
            ok = self._rebuild_locked()
            outcome = "ok" if ok else "fenced"
            return ok
        except Exception:  # noqa: BLE001 -- a failed build leaves the
            # previous quantizer (or the exact path) serving, and must not
            # kill the enrolment or serving thread that triggered it
            logging.getLogger(__name__).exception("ivf rebuild failed")
            if self.metrics is not None:
                self.metrics.incr(mn.IVF_BUILD_FAILURES)
            return False
        finally:
            self._train_lock.release()
            if self.tracer is not None:
                self.tracer.emit(self.tracer.new_trace(), "ivf_retrain",
                                 topic=LIFECYCLE_TOPIC, t0=span_t0,
                                 dur=time.monotonic() - span_t0, outcome=outcome,
                                 nlist=self.nlist, version=self.version)
            if self._fence_refire:
                # The fence dropped this build and the invalidation's own
                # trigger was dropped as in flight: one fresh attempt
                # against the new row set (fences only: failures must not
                # storm).
                self._fence_refire = False
                g = self._gallery
                if (g is not None and self._data is None
                        and g._ivf_wanted() and g.size > 0):
                    self.maybe_rebuild_async()

    def _rebuild_locked(self) -> bool:
        t0 = time.perf_counter()
        g = self._gallery
        # Epoch fence: a reset during this build drops it; centroids of the
        # previous row set must not publish over the new one.
        epoch0 = g.run_locked(lambda: g._epoch)
        emb, _lab, val, _size = g.snapshot()
        n_valid = int(val.sum())
        if n_valid < max(2, min(self.nlist, 8)):
            return False  # nothing meaningful to train on
        if self.auto_nlist:
            self.nlist = self.default_nlist(n_valid)
        ids = np.nonzero(val)[0]
        rows = emb[ids]
        sample = rows
        if len(rows) > self.train_sample:
            rng = np.random.default_rng(self.seed)
            pick = np.sort(rng.choice(len(rows), self.train_sample,
                                      replace=False))
            sample = rows[pick]
        times = {}
        t = time.perf_counter()
        centroids = _kmeans(sample, self.nlist, self.kmeans_iters, self.seed,
                            device=self._device())
        times["kmeans"], t = time.perf_counter() - t, time.perf_counter()
        assign_valid = self.assign_rows(rows, centroids)
        assign = np.full((emb.shape[0],), -1, np.int32)
        assign[ids] = assign_valid
        times["assign"], t = time.perf_counter() - t, time.perf_counter()
        packed = self._pack(emb, val, assign)
        (cell_rows, cell_q8, cell_scale, spill_rows, spill_q8, spill_scale,
         counts, overflow) = packed
        times["pack"], t = time.perf_counter() - t, time.perf_counter()
        data = self._device_put(centroids, cell_rows, cell_q8, cell_scale,
                                spill_rows, spill_q8, spill_scale)
        times["upload"] = time.perf_counter() - t
        published = []

        def publish():
            if g._epoch != epoch0:
                return  # superseded: the invalidation wins
            # Under the gallery's write lock: no add interleaves, so the
            # catch-up below sees a settled row set.
            self._h_centroids = centroids
            self._c_dev = None
            self._h_assign = assign
            self._h_counts = counts
            self._spill_count = overflow
            self._assigned_rows = int(ids[-1]) + 1 if len(ids) else 0
            self.trained_size = n_valid
            self._data = data._replace(gallery_epoch=g._epoch)
            self.version += 1
            self.last_build_s = times
            published.append(True)
            # Catch-up: rows enrolled between the snapshot and this publish
            # are assigned against the new centroids like any incremental
            # add. Valid rows are a prefix within an epoch, so the tail is
            # one contiguous range and one batched insert.
            tail = g._host_val.copy()
            tail[:emb.shape[0]] &= ~val[:len(tail)][:emb.shape[0]]
            tail_ids = np.nonzero(tail)[0]
            if len(tail_ids):
                lo, hi = int(tail_ids[0]), int(tail_ids[-1]) + 1
                if hi - lo == len(tail_ids):
                    self.on_rows_added(g._host_emb[lo:hi], lo)
                else:  # not contiguous (defensive): row by row
                    for rid in tail_ids:
                        self.on_rows_added(g._host_emb[rid][None, :], int(rid))

        g.run_locked(publish)
        if not published:
            self._fence_refire = True  # retry against the new row set
            return False
        if self.metrics is not None:
            self.metrics.incr(mn.IVF_BUILDS)
            self.metrics.set_gauge(mn.IVF_SPILL_ROWS, self._spill_count)
        logging.getLogger(__name__).info(
            "ivf rebuild v%d: %d rows, nlist=%d, max_cell=%d, spill=%d "
            "(%.2fs)", self.version, n_valid, self.nlist,
            cell_rows.shape[1], overflow, time.perf_counter() - t0)
        return True

    def maybe_rebuild_async(self) -> bool:
        """Start a background rebuild unless one is in flight."""
        if self._gallery is None:
            return False
        if self._train_lock.locked():
            if self.metrics is not None:
                self.metrics.incr(mn.IVF_RETRAINS_SKIPPED_INFLIGHT)
            return False
        threading.Thread(target=self.rebuild_now, kwargs={"wait": False},
                         daemon=True, name="ivf-retrain").start()
        return True

    # ---- lifecycle edges driven by the gallery ----

    def invalidate(self) -> None:
        """Drop the published state (called under the gallery's write lock
        on ``reset``); serving takes the exact matcher until a rebuild."""
        self._data = None
        self._h_centroids = None
        self._c_dev = None
        self._h_assign = np.zeros((0,), np.int32)
        self._h_counts = None
        self._spill_count = 0
        self._assigned_rows = 0
        self.trained_size = 0
        if self.metrics is not None:
            self.metrics.incr(mn.IVF_INVALIDATIONS)

    def stale(self) -> bool:
        """Spill nearly full, or the gallery grown well past the trained
        rows (checked outside locks after an add)."""
        data = self._data
        if data is None:
            return False
        if self._spill_count >= self.SPILL_STALE_FRACTION * data.spill_cap:
            return True
        size = self._gallery.size if self._gallery is not None else 0
        return size > self.GROWTH_STALE_FACTOR * max(1, self.trained_size)

    def on_rows_added(self, rows: np.ndarray, start: int) -> None:
        """Assign freshly enrolled rows ``start .. start + n`` (called by
        ``ShardedGallery.add`` under its write lock, after the host
        mirrors hold them). No-op while not ready: the next build covers
        them. One assignment and one insert per ``ASSIGN_CHUNK`` rows."""
        if self._data is None:
            return
        rows = np.asarray(rows, np.float32)
        for off in range(0, rows.shape[0], ASSIGN_CHUNK):
            if not self._add_rows_chunk(rows[off:off + ASSIGN_CHUNK],
                                        start + off):
                return  # invalidated: the remaining rows are moot

    def _add_rows_chunk(self, rows: np.ndarray, start: int) -> bool:
        """One chunk of ``on_rows_added``; False when the quantizer
        invalidated itself (overflow, or a failed insert: the host counts
        would otherwise claim placements the lists never got)."""
        try:
            return self._add_rows_chunk_inner(rows, start)
        except Exception:  # noqa: BLE001 -- enrolment must not die of
            # derived-state bookkeeping; exact serving continues
            logging.getLogger(__name__).exception(
                "ivf incremental insert failed; invalidating")
            self.invalidate()
            return False

    def _add_rows_chunk_inner(self, rows: np.ndarray, start: int) -> bool:
        data = self._data
        if data is None:
            return False
        n = rows.shape[0]
        if not n:
            return True
        cells = self.assign_rows(rows)
        q8, scale = quantize_rows(rows)
        self._grow_assign(start + n - 1)
        c_sel, c_cell, c_pos = [], [], []
        s_sel, s_pos = [], []
        for i in range(n):
            cell = int(cells[i])
            self._h_assign[start + i] = cell
            count = int(self._h_counts[cell])
            if count < data.max_cell:
                c_sel.append(i)
                c_cell.append(cell)
                c_pos.append(count)
                self._h_counts[cell] = count + 1
            elif self._spill_count < data.spill_cap:
                s_sel.append(i)
                s_pos.append(self._spill_count)
                self._spill_count += 1
            else:
                # Cell and spill full: the lists cannot hold the row, so
                # serve exact until the rebuild the staleness check fires.
                self.invalidate()
                return False
        rids = np.arange(start, start + n, dtype=np.int32)
        dev = data.cell_rows.device

        def put(dst, index, src):
            # Copy, then write: a reader holding the older snapshot keeps
            # arrays that never change under it (the reference's
            # functional update), and an insert that fails half way is
            # never seen by any reader. The copy costs one pass over the
            # lists per enrolment chunk; each (cell, position) is written
            # once, so the write is deterministic.
            out = dst.clone()
            out[index] = torch.from_numpy(np.ascontiguousarray(src)).to(dev)
            return out

        if c_sel:
            at = (torch.tensor(c_cell, dtype=torch.long, device=dev),
                  torch.tensor(c_pos, dtype=torch.long, device=dev))
            data = data._replace(cell_rows=put(data.cell_rows, at, rids[c_sel]),
                                 cell_q8=put(data.cell_q8, at, q8[c_sel]),
                                 cell_scale=put(data.cell_scale, at, scale[c_sel]))
        if s_sel:
            at = (torch.tensor(s_pos, dtype=torch.long, device=dev),)
            data = data._replace(spill_rows=put(data.spill_rows, at, rids[s_sel]),
                                 spill_q8=put(data.spill_q8, at, q8[s_sel]),
                                 spill_scale=put(data.spill_scale, at, scale[s_sel]))
        self._data = data
        self._assigned_rows = max(self._assigned_rows, start + n)
        if self.metrics is not None:
            self.metrics.incr(mn.IVF_INCREMENTAL_ROWS, n)
            self.metrics.set_gauge(mn.IVF_SPILL_ROWS, self._spill_count)
        return True

    def _grow_assign(self, max_rid: int) -> None:
        if max_rid < len(self._h_assign):
            return
        grown = np.full((max(max_rid + 1, 2 * max(1, len(self._h_assign))),),
                        -1, np.int32)
        grown[:len(self._h_assign)] = self._h_assign
        self._h_assign = grown

    # ---- sidecar: the trained state as bytes ----

    def sidecar_payload_locked(self) -> Optional[Dict[str, Any]]:
        """Host copies for the sidecar writer, taken under the gallery's
        write lock (``ShardedGallery.snapshot_quantizer``)."""
        if self._data is None or self._h_centroids is None:
            return None
        return {
            "centroids": self._h_centroids.copy(),
            "assign": self._h_assign.copy(),
            "nlist": self.nlist,
            "seed": self.seed,
            "trained_size": self.trained_size,
            "spill_count": self._spill_count,
            "version": self.version,
            "embedder_version": int(getattr(self._gallery,
                                            "embedder_version", 1)),
        }

    def install_from_arrays(self, centroids: np.ndarray, assign: np.ndarray,
                            trained_size: Optional[int] = None) -> bool:
        """Repack from a sidecar's (centroids, assignment) against the
        gallery's current host mirrors, no k-means, and publish. False
        when a pinned ``nlist`` disagrees or the assignment misses a live
        row.

        ``trained_size`` is the sidecar's: the rows of the build that
        sized ``max_cell``. Given it, the repack sizes the cells as that
        build did and keeps it as ``trained_size``, so rows enrolled after
        the build sit in the cell or spill slots their incremental inserts
        took (only the spill's padding may be longer), and a match answers
        as the live quantizer did. Without it (the reference's repack) the
        cells are sized from the rows present now, which moves late rows
        between spill and cells whenever that changes ``max_cell``."""
        if self._gallery is None:
            raise RuntimeError("quantizer not attached to a gallery")
        g = self._gallery
        emb, _lab, val, _size = g.snapshot()
        centroids = np.asarray(centroids, np.float32)
        if self.auto_nlist:
            self.nlist = int(centroids.shape[0])
        elif int(centroids.shape[0]) != self.nlist:
            return False
        assign_full = np.full((emb.shape[0],), -1, np.int32)
        n = min(len(assign), emb.shape[0])
        assign_full[:n] = assign[:n]
        assign_full[~val] = -1
        if np.any(val & (assign_full < 0)):
            return False
        n_valid = int(val.sum())
        sizing = n_valid if trained_size is None else min(int(trained_size), n_valid)
        packed = self._pack(emb, val, assign_full, sizing_rows=sizing)
        (cell_rows, cell_q8, cell_scale, spill_rows, spill_q8, spill_scale,
         counts, overflow) = packed
        data = self._device_put(centroids, cell_rows, cell_q8, cell_scale,
                                spill_rows, spill_q8, spill_scale)
        ids = np.nonzero(val)[0]

        def publish():
            self._h_centroids = centroids
            self._c_dev = None
            self._h_assign = assign_full
            self._h_counts = counts
            self._spill_count = overflow
            self._assigned_rows = int(ids[-1]) + 1 if len(ids) else 0
            self.trained_size = sizing
            self._data = data._replace(gallery_epoch=g._epoch)
            self.version += 1

        g.run_locked(publish)
        return True


def encode_sidecar(payload: Dict[str, Any], wal_seq: int) -> bytes:
    """``MAGIC + u32 header_len + header_json + sha256(header) + body``, the
    body the raw centroid f32 bytes then the assignment int32 bytes, each
    crc32'd in the header (the reference's format)."""
    cent = np.ascontiguousarray(payload["centroids"], np.float32)
    assign = np.ascontiguousarray(payload["assign"], np.int32)
    cent_b, assign_b = cent.tobytes(), assign.tobytes()
    header = {
        "format_version": SIDECAR_FORMAT_VERSION,
        "wal_seq": int(wal_seq),
        "nlist": int(payload["nlist"]),
        "dim": int(cent.shape[1]),
        "rows": int(assign.shape[0]),
        "seed": int(payload["seed"]),
        "trained_size": int(payload["trained_size"]),
        "version": int(payload["version"]),
        "embedder_version": int(payload.get("embedder_version", 1)),
        "crc32_centroids": binascii.crc32(cent_b) & 0xFFFFFFFF,
        "crc32_assign": binascii.crc32(assign_b) & 0xFFFFFFFF,
        "created_ts": time.time(),
    }
    blob = json.dumps(header, sort_keys=True).encode("utf-8")
    return (SIDECAR_MAGIC + len(blob).to_bytes(4, "big") + blob
            + hashlib.sha256(blob).digest() + cent_b + assign_b)


def decode_sidecar(blob: bytes) -> Tuple[Dict[str, Any], np.ndarray,
                                         np.ndarray]:
    """Parse and check sidecar bytes -> (header, centroids, assign);
    raises ``SidecarError`` on any framing or checksum miss."""
    if not blob.startswith(SIDECAR_MAGIC):
        raise SidecarError("bad sidecar magic")
    off = len(SIDECAR_MAGIC)
    if len(blob) < off + 4:
        raise SidecarError("truncated before header")
    hlen = int.from_bytes(blob[off:off + 4], "big")
    off += 4
    if hlen <= 0 or len(blob) < off + hlen + 32:
        raise SidecarError("truncated header")
    header_blob = blob[off:off + hlen]
    if hashlib.sha256(header_blob).digest() != blob[off + hlen:off + hlen + 32]:
        raise SidecarError("header sha256 mismatch")
    try:
        header = json.loads(header_blob.decode("utf-8"))
        version = int(header["format_version"])
        nlist, dim, rows = (int(header["nlist"]), int(header["dim"]),
                            int(header["rows"]))
    except (UnicodeDecodeError, json.JSONDecodeError, KeyError, TypeError,
            ValueError) as exc:
        raise SidecarError(f"header decode failed: {exc!r}") from exc
    if version > SIDECAR_FORMAT_VERSION:
        raise SidecarError(f"sidecar format v{version} newer than supported")
    body = blob[off + hlen + 32:]
    cent_bytes = nlist * dim * 4
    if len(body) != cent_bytes + rows * 4:
        raise SidecarError("payload truncated")
    cent_b, assign_b = body[:cent_bytes], body[cent_bytes:]
    if (binascii.crc32(cent_b) & 0xFFFFFFFF) != header["crc32_centroids"]:
        raise SidecarError("centroid crc32 mismatch")
    if (binascii.crc32(assign_b) & 0xFFFFFFFF) != header["crc32_assign"]:
        raise SidecarError("assignment crc32 mismatch")
    centroids = np.frombuffer(cent_b, np.float32).reshape(nlist, dim).copy()
    assign = np.frombuffer(assign_b, np.int32).copy()
    return header, centroids, assign
