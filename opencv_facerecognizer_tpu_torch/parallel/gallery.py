"""Enrolled gallery on one device: port of the single-device exact path
of ``opencv_facerecognizer_tpu/parallel/gallery.py``.

- Fixed ``capacity`` rows; rows beyond ``size`` are invalid and never
  match. ``add`` doubles the capacity when the rows do not fit.
- Host mirrors (float32, L2-normalized) are the enrolment truth; the
  device copy is rebuilt from them and published as one ``GalleryData``
  snapshot (one attribute write), so a reader never sees a mix of old
  and new arrays.
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

Multi-device sharding and asynchronous grow are later slices.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.ops.ivf_match import ivf_match_topk
from opencv_facerecognizer_tpu_torch.ops.nms import stable_topk
from opencv_facerecognizer_tpu_torch.ops.streaming_match import (
    NEG_INF, streaming_match_topk)
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, resolve_device)


def take_labels_with_sentinel(labels: torch.Tensor, idx: torch.Tensor,
                              labels_pad: int) -> torch.Tensor:
    """Gather labels for top-k indices, mapping sentinel ``idx == -1``
    slots (fewer than k valid rows) to the pad label."""
    taken = labels[idx.clamp(min=0).long()]
    return torch.where(idx < 0, torch.full_like(taken, labels_pad), taken)


def match_global(q: torch.Tensor, g: torch.Tensor, valid: torch.Tensor,
                 labels: torch.Tensor, *, k: int):
    """Plain small-gallery matcher (the reference's single-shard branch):
    bf16 operands, f32 accumulation, invalid rows at -1e30, then a stable
    top-k (ties to the lowest row). Returns (labels [Q, k], sims [Q, k],
    row indices [Q, k])."""
    sims = q.to(torch.bfloat16).float() @ g.to(torch.bfloat16).float().T
    sims = torch.where(valid[None, :], sims, torch.full_like(sims, NEG_INF))
    top_vals, top_idx = stable_topk(sims, min(k, g.shape[0]))
    return labels[top_idx], top_vals, top_idx.to(torch.int32)


class GalleryData(NamedTuple):
    """One immutable snapshot of the device-visible gallery."""

    embeddings: torch.Tensor  # [capacity, dim] in store_dtype
    labels: torch.Tensor  # [capacity] int32
    valid: torch.Tensor  # [capacity] bool
    size: int
    #: the gallery's ``_epoch`` at install (``reset`` bumps it): pairs this
    #: snapshot with quantizer state published in the same epoch
    epoch: int = 0

    @property
    def capacity(self) -> int:
        return int(self.embeddings.shape[0])


class EmbeddingDimMismatchError(ValueError):
    """``swap_from`` was given a gallery of another embedding dim."""


class ShardedGallery:
    """Enrolled gallery of L2-normalized embeddings on one device."""

    #: capacity from which the streaming kernel serves the match. 65536 is
    #: the TPU's measured crossover (the reference's PALLAS_MIN_CAPACITY),
    #: kept until an H100 measurement sets this card's own.
    KERNEL_MIN_CAPACITY = 65536

    #: capacity from which ``match_mode="auto"`` serves two-stage (with a
    #: ready quantizer): the reference's TPU crossover, kept until an H100
    #: measurement sets this card's own
    IVF_MIN_CAPACITY = 262144

    def __init__(self, capacity: int, dim: int, labels_pad: int = -1,
                 use_kernel: Optional[bool] = None,
                 store_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = DEFAULT_DEVICE, embedder_version: int = 1):
        self.device = resolve_device(device)
        #: the embedder version whose space the rows live in: the service
        #: stamps results and identity-cache entries with it
        self.embedder_version = int(embedder_version)
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.labels_pad = int(labels_pad)
        self.store_dtype = store_dtype
        self._use_kernel_cfg = use_kernel
        self._write_lock = threading.Lock()
        self.grow_count = 0
        self._epoch = 0  # bumped by reset: fences quantizer builds
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

    @property
    def size(self) -> int:
        return self._data.size

    def _install(self, size: int) -> None:
        """Upload the host mirrors (cast to store_dtype on the host, so the
        transfer carries the narrow bytes) and publish one snapshot."""
        emb = torch.from_numpy(self._host_emb).to(self.store_dtype)
        self._data = GalleryData(
            embeddings=emb.to(self.device),
            labels=torch.from_numpy(self._host_lab).to(self.device),
            valid=torch.from_numpy(self._host_val).to(self.device),
            size=size, epoch=self._epoch)

    def add(self, embeddings, labels) -> None:
        """Append rows (L2-normalized here), doubling capacity on overflow;
        the rows are matchable on return."""
        emb = np.asarray(embeddings, np.float32)
        lab = np.asarray(labels, np.int32)
        if emb.ndim != 2 or emb.shape[1] != self.dim or lab.shape != emb.shape[:1]:
            raise ValueError(f"embeddings [n, {self.dim}] and labels [n] expected, "
                             f"got {emb.shape} and {lab.shape}")
        emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        n = emb.shape[0]
        with self._write_lock:
            size = self.size
            if size + n > self.capacity:
                self._grow_locked(size + n)
            self._host_emb[size:size + n] = emb
            self._host_lab[size:size + n] = lab
            self._host_val[size:size + n] = True
            if self.quantizer is not None:
                # Under the same lock as the mirrors: the rows reach their
                # cells (or the spill) before the snapshot below makes
                # them matchable, so the two-stage path never misses a row
                # the exact path finds.
                self.quantizer.on_rows_added(emb, size)
            self._install(size + n)
        self._poke_quantizer()  # outside the lock: may start a build

    def _grow_locked(self, needed: int) -> None:
        new_capacity = max(self.capacity, 1)
        while new_capacity < needed:
            new_capacity *= 2
        emb = np.zeros((new_capacity, self.dim), np.float32)
        lab = np.full((new_capacity,), self.labels_pad, np.int32)
        val = np.zeros((new_capacity,), bool)
        emb[:self.capacity] = self._host_emb
        lab[:self.capacity] = self._host_lab
        val[:self.capacity] = self._host_val
        self._host_emb, self._host_lab, self._host_val = emb, lab, val
        self.capacity = new_capacity
        self.grow_count += 1

    def reset(self) -> None:
        with self._write_lock:
            self._epoch += 1
            if self.quantizer is not None:
                self.quantizer.invalidate()
            self._host_emb[:] = 0.0
            self._host_lab[:] = self.labels_pad
            self._host_val[:] = False
            self._install(0)

    #: bounded wait for the write lock in ``snapshot``: a device transfer
    #: hung inside the locked region must not wedge the caller
    SNAPSHOT_LOCK_TIMEOUT_S = 5.0

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Copies of the host mirrors (embeddings, labels, valid, size),
        no device readback. Taken under the write lock when it comes
        within ``SNAPSHOT_LOCK_TIMEOUT_S``, else without it."""
        acquired = self._write_lock.acquire(timeout=self.SNAPSHOT_LOCK_TIMEOUT_S)
        try:
            return (self._host_emb.copy(), self._host_lab.copy(),
                    self._host_val.copy(), self.size)
        finally:
            if acquired:
                self._write_lock.release()

    def load_snapshot(self, emb: np.ndarray, lab: np.ndarray, val: np.ndarray, size: int,
                      embedder_version: Optional[int] = None) -> None:
        """Install arrays of a prior ``snapshot()`` (or a checkpoint) as
        the live gallery, adopting their capacity; bumps the epoch,
        invalidates the quantizer, and re-stamps ``embedder_version`` when
        given, in the same publish."""
        emb = np.array(emb, np.float32, copy=True)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"snapshot must be [capacity, {self.dim}], got {emb.shape}")
        with self._write_lock:
            if embedder_version is not None:
                self.embedder_version = int(embedder_version)
            self._epoch += 1
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
        lives on another device. Adopts its ``embedder_version``; a dim
        mismatch raises ``EmbeddingDimMismatchError``."""
        if other.dim != self.dim:
            raise EmbeddingDimMismatchError(
                f"swap_from refused: donor gallery dim {other.dim} != serving dim "
                f"{self.dim}; a different-D embedder rolls out through the staged "
                f"re-embed, never a swap")
        rebuild = other.store_dtype != self.store_dtype or other.device != self.device
        with self._write_lock:
            self.embedder_version = int(getattr(other, "embedder_version",
                                                self.embedder_version))
            self._epoch += 1
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
                self._data = other._data._replace(epoch=self._epoch)
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
        forced by ``use_kernel``, else a CUDA device at
        ``capacity >= KERNEL_MIN_CAPACITY``."""
        if self._use_kernel_cfg is not None:
            return bool(self._use_kernel_cfg)
        cap = self.capacity if capacity is None else capacity
        return self.device.type == "cuda" and cap >= self.KERNEL_MIN_CAPACITY

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
        [Q, k], row indices [Q, k]) on the gallery's device."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be [Q, {self.dim}], got {tuple(q.shape)}")
        data = self._data  # one snapshot read
        ivf = self._ivf_data(data)  # one epoch-checked quantizer read
        fn = self.match_fn(int(k), data.capacity, use_ivf=ivf is not None)
        args = (q, data.embeddings, data.valid, data.labels)
        return fn(*args, ivf) if ivf is not None else fn(*args)
