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
- Matcher selection (``match_fn``) mirrors the reference's
  ``_pallas_enabled``: the streaming kernel (``ops.streaming_match``) on a
  CUDA device at ``capacity >= KERNEL_MIN_CAPACITY``, else the plain
  matmul + stable top-k of ``match_global``; ``use_kernel=`` overrides.

Multi-device sharding, IVF and asynchronous grow are later slices.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

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

    @property
    def capacity(self) -> int:
        return int(self.embeddings.shape[0])


class ShardedGallery:
    """Enrolled gallery of L2-normalized embeddings on one device."""

    #: capacity from which the streaming kernel serves the match. 65536 is
    #: the TPU's measured crossover (the reference's PALLAS_MIN_CAPACITY),
    #: kept until an H100 measurement sets this card's own.
    KERNEL_MIN_CAPACITY = 65536

    def __init__(self, capacity: int, dim: int, labels_pad: int = -1,
                 use_kernel: Optional[bool] = None,
                 store_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.labels_pad = int(labels_pad)
        self.store_dtype = store_dtype
        self._use_kernel_cfg = use_kernel
        self._write_lock = threading.Lock()
        self.grow_count = 0
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
            size=size)

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
            self._install(size + n)

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
            self._host_emb[:] = 0.0
            self._host_lab[:] = self.labels_pad
            self._host_val[:] = False
            self._install(0)

    def kernel_enabled(self, capacity: Optional[int] = None) -> bool:
        """Streaming-kernel selection (the reference's ``_pallas_enabled``):
        forced by ``use_kernel``, else a CUDA device at
        ``capacity >= KERNEL_MIN_CAPACITY``."""
        if self._use_kernel_cfg is not None:
            return bool(self._use_kernel_cfg)
        cap = self.capacity if capacity is None else capacity
        return self.device.type == "cuda" and cap >= self.KERNEL_MIN_CAPACITY

    def match_fn(self, k: int, capacity: Optional[int] = None):
        """Match function ``(q, g, valid, labels) -> (labels [Q, k], sims
        [Q, k], indices [Q, k])`` with the selection applied; shared by
        ``match`` and the serving pipeline."""
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
        return self.match_fn(int(k), data.capacity)(
            q, data.embeddings, data.valid, data.labels)
