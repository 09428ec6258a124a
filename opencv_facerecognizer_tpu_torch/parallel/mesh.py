"""Device meshes: port of ``opencv_facerecognizer_tpu/parallel/mesh.py``.

A ``Mesh`` is a ``(dp, tp)`` array of slots: ``dp`` splits frame and
query batches, ``tp`` splits the gallery's rows. A slot is a position in
the device list the mesh was made from, with its ``torch.device``, the
process (``torch.distributed`` rank) that drives it, and, on a CUDA
device of this process, a stream of its own. A list may name one device
more than once (the tests' ``["cpu"] * 8``, or eight slots of one card):
the slots stay apart by their position (``Slot.id``), so one card runs the
sharded paths with its slots' work on separate streams.

**One process** (no process group, or a group of one): the process drives
every slot, as the reference's single controller drives every chip
``jax.devices()`` lists.

**Across processes** (after ``initialize_multihost`` joined a group of
more than one): ``make_mesh`` spans every process's devices, rank-major,
as ``jax.devices()`` lists every host's chips after
``jax.distributed.initialize``. A slot belongs to the process whose rank
it carries, whatever its device says (on the CPU every slot is ``cpu``;
two processes on one card both name ``cuda:0``). The contract is the
reference's multi-controller model:

- every process of the group runs the same program and calls the same
  methods in the same order with the same host inputs
  (``ShardedGallery.add``, ``recognize_batch_packed``,
  ``TwoStagePipeline.recognize_batch``: what ``jax.device_put`` of a host
  array onto a global sharding assumes);
- each process computes only on its own slots;
- every process gets the whole result back, equal to what one process
  driving the same layout returns.

The collectives between processes run on the groups the mesh makes when
it is made (``_Comm``): one for each dp row whose tp shards span more than
one process (the candidates' all-gather, the reference's
``jax.lax.all_gather`` over ``tp``; the training step's softmax and
embedding-gradient sums over ``tp``), one for each dp column (a tp index
down the dp rows) spanning more than one process (the training step's
gradient sums over ``dp``) and one over every process (the dp result
gather). ``gloo`` takes the all-gathers' and all-reduces' card tensors (it
copies them through host memory itself) but sends only host tensors (its
send of a card tensor aborts the process), so over gloo the pp hop's
point-to-point transfer is staged through host memory explicitly; ``nccl``
never stages.

**Reductions over slots** (``Mesh.reduce``, what GSPMD's all-reduces do
for the reference's sharded training step): in one process the members of
a row or column combine as explicit copies and adds (or maxima) on the
first member's stream, in a fixed order (a balanced tree in slot order),
and every member gets a copy of the one result, so every copy is the same
bit for bit. Across processes each process combines its own members the
same way and ``_Comm.all_reduce`` combines the processes' partial results;
where each process holds a contiguous half of the members (two processes,
as in the tests) that is the same tree, so it gives the one-process bits.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from collections import Counter
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.utils.device import DeviceLike, resolve_device

DP_AXIS = "dp"
TP_AXIS = "tp"

#: ``Mesh.reduce``'s ops: how two members combine in one process
_COMBINE = {"sum": torch.add, "max": torch.maximum}

class Slot(NamedTuple):
    """One place of a mesh: ``id`` its position in the mesh's device list,
    ``device``, ``stream`` (None off CUDA and on another process's slot)
    and ``rank``, the process that drives it (0 on a mesh of one
    process)."""

    id: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"]
    rank: int = 0


class _Comm:
    """The process group of a mesh across processes: this process's
    ``rank``, ``home`` (its first slot of the mesh made by ``make_mesh``),
    ``group`` over every process (the result gather), ``row_groups``
    (ranks -> group) for each dp row spanning more than one process and
    ``col_groups`` likewise for each dp column.
    ``stats`` counts each named collective's calls, bytes, bytes staged
    through host memory and host-clock seconds; ``sync_timing`` waits for
    the cards before and after each one, so its seconds are its own (the
    wait for the other members included), its transfer on NCCL too."""

    def __init__(self, rank: int, home: Slot, group, row_groups: dict, col_groups: dict):
        self.rank = rank
        self.home = home
        self.group = group
        self.row_groups = row_groups
        self.col_groups = col_groups
        self.stats = {"calls": Counter(), "bytes": Counter(), "staged_bytes": Counter(),
                      "seconds": Counter()}
        self.sync_timing = False

    def _sync(self, tensors) -> float:
        """With ``sync_timing``, wait for the cards of ``tensors``; returns
        the host clock."""
        if self.sync_timing:
            for dev in {t.device for t in tensors if t.is_cuda}:
                torch.cuda.current_stream(dev).synchronize()
        return time.perf_counter()

    def _note(self, name: str, tensors, staged: bool, t0: float) -> None:
        t1 = self._sync(tensors)
        n = sum(t.numel() * t.element_size() for t in tensors)
        self.stats["calls"][name] += 1
        self.stats["bytes"][name] += n
        self.stats["staged_bytes"][name] += n if staged else 0
        self.stats["seconds"][name] += t1 - t0

    def all_gather(self, t: torch.Tensor, group, name: str) -> torch.Tensor:
        """``[G, *t.shape]``: every member's ``t`` (at least 1-d) in rank
        order, on ``t``'s device."""
        dist = torch.distributed
        t0 = self._sync([t])
        t = t.contiguous()
        out = t.new_empty((dist.get_world_size(group), *t.shape))
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out.view(-1, *t.shape[1:]), t, group=group)
        self._note(name, [t], False, t0)
        return out

    def all_reduce(self, t: torch.Tensor, group, op: str, name: str) -> torch.Tensor:
        """The ``op`` ("sum" or "max") of every member's ``t`` over
        ``group``, elementwise, on ``t``'s device (``t`` is left as it
        was)."""
        dist = torch.distributed
        t0 = self._sync([t])
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=getattr(dist.ReduceOp, op.upper()), group=group)
        self._note(name, [out], False, t0)
        return out

    def exchange(self, sends: list, recvs: list, name: str) -> list:
        """Point to point over ``group``: ``sends`` [(tensor, dst rank)]
        and ``recvs`` [(like, src rank)], a received tensor taking the
        shape, dtype and device of ``like``; all posted before any is
        awaited. Returns the received tensors in order (staged through
        host memory on gloo, which sends only host tensors)."""
        dist = torch.distributed
        t0 = self._sync([t for t, _ in sends + recvs])
        host = dist.get_backend(self.group) == dist.Backend.GLOO
        staged = host and any(t.is_cuda for t, _ in sends + recvs)
        ops, bufs = [], []
        for t, dst in sends:
            ops.append(dist.isend(t.cpu() if host else t.contiguous(), dst, group=self.group))
        for like, src in recvs:
            buf = torch.empty_like(like, device="cpu") if host else torch.empty_like(like)
            ops.append(dist.irecv(buf, src, group=self.group))
            bufs.append(buf)
        for op in ops:
            op.wait()
        outs = [b.to(like.device) for b, (like, _src) in zip(bufs, recvs)]
        self._note(name, [t for t, _ in sends] + outs, staged, t0)
        return outs


class Mesh:
    """A ``(dp, tp)`` array of ``Slot``s (``devices``); ``shape`` is
    ``{"dp": dp, "tp": tp}``; ``comm`` the ``_Comm`` of a mesh across
    processes (None on one process)."""

    axis_names = (DP_AXIS, TP_AXIS)

    def __init__(self, slots: np.ndarray, comm: Optional[_Comm] = None):
        if slots.ndim != 2 or slots.size == 0:
            raise ValueError(f"a mesh is a non-empty (dp, tp) array of slots, got "
                             f"shape {slots.shape}")
        self.devices = slots
        self.comm = comm

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.devices.shape[0], TP_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> Slot:
        """The slot of dp row 0 and tp shard 0."""
        return self.devices[0, 0]

    @property
    def cross_process(self) -> bool:
        return self.comm is not None

    @property
    def sharded(self) -> bool:
        """Is a gallery on this mesh placed shard by shard? (More than one
        slot, or across processes: a ``split_mesh`` half of one slot too,
        which another process may hold.)"""
        return self.size > 1 or self.comm is not None

    @property
    def rank(self) -> int:
        """This process's rank (on a mesh of one process, its slots')."""
        return self.first.rank if self.comm is None else self.comm.rank

    def is_local(self, slot: Slot) -> bool:
        """Is ``slot`` this process's? (By its rank, never its device.)"""
        return slot.rank == self.rank

    @property
    def local_slots(self) -> list:
        return [s for s in self.devices.flat if self.is_local(s)]

    def row_home(self, r: int) -> Optional[Slot]:
        """This process's first slot of dp row ``r`` (None: it holds none):
        where the row's frames are embedded and its candidates merged."""
        return next((s for s in self.devices[r] if self.is_local(s)), None)

    def row_ranks(self, r: int) -> tuple:
        """The processes holding dp row ``r``, in rank (= shard) order."""
        return tuple(sorted({s.rank for s in self.devices[r]}))

    def col_ranks(self, c: int) -> tuple:
        """The processes holding dp column ``c`` (tp index ``c`` of every
        dp row), in rank (= row) order."""
        return tuple(sorted({s.rank for s in self.devices[:, c]}))

    def reduce(self, parts: dict, axis: str, op: str, name: str) -> dict:
        """``parts`` {slot id: tensor}, one for each of this process's
        slots (each on its slot's device, made on its stream), reduced
        elementwise by ``op`` ("sum" or "max") over ``axis``: with
        ``TP_AXIS`` over each dp row's tp slots, with ``DP_AXIS`` over
        each dp column's dp slots. Returns {slot id: its row's or
        column's reduction}, on the slot's device and stream, the same
        bits in every member (module docstring); a one-slot row or column
        gives its part back. ``name`` tags the collective across
        processes in ``comm.stats``."""
        lines = self.devices if axis == TP_AXIS else self.devices.T
        out = {}
        for i, members in enumerate(lines):
            local = [s for s in members if self.is_local(s)]
            if len(members) == 1 or not local:
                out.update((s.id, parts[s.id]) for s in local)
                continue
            first = local[0]
            ready = []
            for s in local[1:]:
                with on_slot(s):
                    ready += [e for e in (record_event(s.device),) if e is not None]
            with on_slot(first, ready):
                acc = _tree(op, [_handoff(parts[s.id], first.stream).to(first.device)
                                 for s in local])
                ranks = self.row_ranks(i) if axis == TP_AXIS else self.col_ranks(i)
                if len(ranks) > 1:
                    groups = self.comm.row_groups if axis == TP_AXIS else self.comm.col_groups
                    acc = self.comm.all_reduce(acc, groups[ranks], op, name)
                done = [e for e in (record_event(first.device),) if e is not None]
            out[first.id] = acc
            for s in local[1:]:
                with on_slot(s, done):
                    out[s.id] = _handoff(acc, s.stream).to(s.device, copy=True)
        return out

    @property
    def home(self) -> Slot:
        """Where this process's whole-array reads and results land: its
        first slot of the mesh (of a ``split_mesh`` half it holds no slot
        of, its first slot of the mesh that was split). On one process,
        ``first``."""
        local = self.local_slots
        return local[0] if local or self.comm is None else self.comm.home

    def layout(self) -> tuple:
        """The mesh's shape and each slot's rank and device: two meshes
        with equal layouts hold the same tensors in the same places."""
        return (self.devices.shape, tuple((s.rank, s.device) for s in self.devices.flat))

    def gather_rows(self, held: torch.Tensor, name: str = "results") -> torch.Tensor:
        """The dp result gather: ``held`` is a ``[B, ...]`` batch split in
        dp rows, correct on the rows this process holds (anything
        elsewhere); returns the whole batch, each row as its lowest-ranked
        holder computed it, on every process. On one process, ``held``."""
        if self.comm is None:
            return held
        dp = self.devices.shape[0]
        every = self.comm.all_gather(held, self.comm.group, name)
        per = held.shape[0] // dp
        return torch.cat([every[self.row_ranks(r)[0], r * per:(r + 1) * per]
                          for r in range(dp)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[(s.rank, str(s.device)) for s in self.devices.flat]})"


def _local_devices() -> list:
    """Every CUDA device this process sees; raises without one (no CPU
    fallback: the CPU is named explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: torch.cuda is not available; pass devices=['cpu'] "
                           "(or a list of CPU slots) explicitly to run the plain path")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _group_devices(local: list) -> tuple:
    """(every process's devices rank-major, each one's rank, this rank):
    one ``all_gather_object`` over the group when one of more than one
    process is up, else this process's own list."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < 2:
        return local, [0] * len(local), 0
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, [str(d) for d in local])
    counts = [len(x) for x in everyone]
    if len(set(counts)) > 1:
        raise ValueError(f"make_mesh: every process must bring the same device count, "
                         f"got {counts} by rank")
    return ([torch.device(d) for x in everyone for d in x],
            [rank for rank, x in enumerate(everyone) for _ in x], dist.get_rank())


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Build a (dp, tp) mesh over ``devices`` (default: every CUDA device
    this process sees); after ``initialize_multihost`` joined a group of
    more than one process, over every process's ``devices``, rank-major
    (each process names its own; every process must name as many, and
    every process calls this with the same axes).

    With neither axis given, everything goes to ``tp``; given one axis,
    the other takes the remainder; given both, they must factor the
    device count exactly (the reference's rules and errors)."""
    local = [resolve_device(d) for d in (devices if devices is not None
                                         else _local_devices())]
    devs, ranks, rank = _group_devices(local)
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
    for i, (dev, owner) in enumerate(zip(devs, ranks)):
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" and owner == rank else None
        slots[i] = Slot(i, dev, stream, owner)
    mesh = Mesh(slots.reshape(dp, tp))
    if len(set(ranks)) > 1:
        # every process creates every group, in the same order (a
        # torch.distributed rule), even those it is no member of
        dist = torch.distributed
        group = dist.new_group(sorted(set(ranks)))
        row_groups, col_groups = {}, {}
        for r in range(dp):
            members = mesh.row_ranks(r)
            if len(members) > 1 and members not in row_groups:
                row_groups[members] = dist.new_group(list(members))
        for c in range(tp):
            members = mesh.col_ranks(c)
            if len(members) > 1 and members not in col_groups:
                col_groups[members] = (row_groups[members] if members in row_groups
                                       else dist.new_group(list(members)))
        home = next(s for s in slots if s.rank == rank)
        mesh.comm = _Comm(rank, home, group, row_groups, col_groups)
    return mesh


def single_slot_mesh(device: torch.device) -> Mesh:
    """The 1x1 mesh a gallery made with ``device=`` stands on (no stream:
    the one-device path runs on the caller's), this process's."""
    slots = np.empty((1, 1), dtype=object)
    slots[0, 0] = Slot(0, device, None, _process_rank())
    return Mesh(slots)


def _process_rank() -> int:
    """This process's ``torch.distributed`` rank (0 outside a group)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@contextlib.contextmanager
def on_slot(slot: Slot, after: Iterable = ()):
    """Run the block on ``slot``'s device and stream, after the CUDA
    events ``after``. Tensors the block allocates belong to the slot's
    stream: one read on another stream needs ``record_stream`` (or a
    reference held until that stream is done). A slot of another process
    is refused: only its own process computes on it."""
    if slot.rank != _process_rank():
        raise ValueError(f"on_slot: slot {slot.id} belongs to process {slot.rank}, not to "
                         f"this one ({_process_rank()})")
    if slot.stream is None:
        yield
        return
    with torch.cuda.device(slot.device), torch.cuda.stream(slot.stream):
        for ev in after:
            slot.stream.wait_event(ev)
        yield


def _handoff(t: torch.Tensor, stream) -> torch.Tensor:
    """``t``, made on one stream, is read on ``stream`` next: its memory
    is not reused before that stream's reads are done."""
    if stream is not None and t.is_cuda:
        t.record_stream(stream)
    return t


def _tree(op: str, parts: list) -> torch.Tensor:
    """``parts`` combined by ``op`` as a balanced tree in their order
    (the first half's result with the second half's)."""
    if len(parts) == 1:
        return parts[0]
    half = (len(parts) + 1) // 2
    return _COMBINE[op](_tree(op, parts[:half]), _tree(op, parts[half:]))


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
    row's stream. A row of another process (``None``) gets no copy."""
    home = next(module.parameters()).device
    first = next((i for i, s in enumerate(slots) if s is not None), None)
    return [None if s is None
            else module if i == first and s.device == home
            else copy.deepcopy(module).to(s.device).eval()
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
    A group made beforehand (the one-card smoke run's two ``gloo``
    processes) is kept. After it, ``make_mesh`` spans every process's
    devices (module docstring)."""
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
