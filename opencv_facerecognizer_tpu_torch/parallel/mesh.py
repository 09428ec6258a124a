"""Device meshes: port of ``opencv_facerecognizer_tpu/parallel/mesh.py``.

One process drives every device of a mesh, as the reference's single
controller drives every chip ``jax.devices()`` lists. A ``Mesh`` is a
``(dp, tp)`` array of slots: ``dp`` splits frame and query batches,
``tp`` splits the gallery's rows. A slot is a position in the device list
the mesh was made from, with its ``torch.device`` and, on a CUDA device,
a stream of its own. A list may name one device more than once (the
tests' ``["cpu"] * 8``, or eight slots of one card): the slots stay apart
by their position (``Slot.id``), so one card runs the sharded paths with
its slots' work on separate streams.

``initialize_multihost`` joins a ``torch.distributed`` process group.
Unlike ``jax.distributed``, that does not make other hosts' devices
visible here: a mesh spans the devices of this process only (a mesh
across processes is ROADMAP A.11.2).
"""

from __future__ import annotations

import contextlib
import copy
import os
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.utils.device import DeviceLike, resolve_device

DP_AXIS = "dp"
TP_AXIS = "tp"


class Slot(NamedTuple):
    """One place of a mesh: ``id`` its position in the mesh's device list,
    ``device``, and ``stream`` (None off CUDA)."""

    id: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"]


class Mesh:
    """A ``(dp, tp)`` array of ``Slot``s (``devices``); ``shape`` is
    ``{"dp": dp, "tp": tp}``."""

    axis_names = (DP_AXIS, TP_AXIS)

    def __init__(self, slots: np.ndarray):
        if slots.ndim != 2 or slots.size == 0:
            raise ValueError(f"a mesh is a non-empty (dp, tp) array of slots, got "
                             f"shape {slots.shape}")
        self.devices = slots

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.devices.shape[0], TP_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> Slot:
        """The slot of dp row 0 and tp shard 0: whole-array reads and
        results land there."""
        return self.devices[0, 0]

    def layout(self) -> tuple:
        """The mesh's shape and each slot's device: two meshes with equal
        layouts hold the same tensors in the same places."""
        return (self.devices.shape, tuple(s.device for s in self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(s.device) for s in self.devices.flat]})"


def _local_devices() -> list:
    """Every CUDA device this process sees; raises without one (no CPU
    fallback: the CPU is named explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: torch.cuda is not available; pass devices=['cpu'] "
                           "(or a list of CPU slots) explicitly to run the plain path")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Build a (dp, tp) mesh over ``devices`` (default: every CUDA device).

    With neither axis given, everything goes to ``tp``; given one axis,
    the other takes the remainder; given both, they must factor the
    device count exactly (the reference's rules and errors)."""
    devs = [resolve_device(d) for d in (devices if devices is not None
                                        else _local_devices())]
    n = len(devs)
    if dp is None and tp is None:
        dp, tp = 1, n
    elif dp is None:
        if n % tp:
            raise ValueError(f"tp={tp} does not divide device count {n}")
        dp = n // tp
    elif tp is None:
        if n % dp:
            raise ValueError(f"dp={dp} does not divide device count {n}")
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != device count {n}")
    slots = np.empty(n, dtype=object)
    for i, dev in enumerate(devs):
        slots[i] = Slot(i, dev, torch.cuda.Stream(dev) if dev.type == "cuda" else None)
    return Mesh(slots.reshape(dp, tp))


def single_slot_mesh(device: torch.device) -> Mesh:
    """The 1x1 mesh a gallery made with ``device=`` stands on (no stream:
    the one-device path runs on the caller's)."""
    slots = np.empty((1, 1), dtype=object)
    slots[0, 0] = Slot(0, device, None)
    return Mesh(slots)


@contextlib.contextmanager
def on_slot(slot: Slot, after: Iterable = ()):
    """Run the block on ``slot``'s device and stream, after the CUDA
    events ``after``. Tensors the block allocates belong to the slot's
    stream: one read on another stream needs ``record_stream`` (or a
    reference held until that stream is done)."""
    if slot.stream is None:
        yield
        return
    with torch.cuda.device(slot.device), torch.cuda.stream(slot.stream):
        for ev in after:
            slot.stream.wait_event(ev)
        yield


def record_event(device: torch.device):
    """An event on ``device``'s current stream (None off CUDA)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _replicas(module: torch.nn.Module, slots) -> list:
    """One copy of ``module`` for each slot, on its device (the first
    slot's is ``module`` itself where it lives there), for the dp rows of
    ``parallel.pp`` and ``parallel.pipeline``. Rows never share a module: a
    module's compute-dtype casts are made at its first forward, on the
    stream of the row that runs it, and another row's stream would not
    wait for them; and an install copies into each row's copy on that
    row's stream."""
    home = next(module.parameters()).device
    return [module if i == 0 and s.device == home else copy.deepcopy(module).to(s.device).eval()
            for i, s in enumerate(slots)]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> bool:
    """Join a ``torch.distributed`` process group when running multi-host.

    The reference's contract: arguments default from
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``;
    any argument given explicitly also triggers initialization. Returns
    True when the group is (already) initialized, False when neither
    arguments nor environment ask for multi-host. The backend is ``nccl``
    with a card and ``gloo`` without; the rendezvous is
    ``tcp://<coordinator>`` (without a coordinator, torch's ``env://``).
    A mesh still spans this process's devices only (module docstring)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if (coordinator_address is None and env_np is None
            and num_processes is None and process_id is None):
        return False  # nothing asked for multi-host; stay single-process
    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=None if coordinator_address is None else f"tcp://{coordinator_address}",
        world_size=(num_processes if num_processes is not None
                    else int(env_np) if env_np else -1),
        rank=(process_id if process_id is not None
              else int(env_pid) if env_pid else -1))
    return True
