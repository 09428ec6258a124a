"""Training over a device mesh: the port of the reference's sharded ArcFace
step (``__graft_entry__.py:181-218``, ``dryrun_multichip``'s first part).

The reference jits one ``optax.adam`` step of ``arcface_loss`` with the
net's parameters replicated (``P()``), the ArcFace head's class axis split
over ``tp`` (``P(TP_AXIS, None)``) and the batch and labels split over
``dp``; GSPMD inserts the softmax's collectives over ``tp`` and the
gradient sums over ``dp``. It has no module of its own for that. Here the
same step is written out over the port's ``Mesh`` (``parallel/mesh.py``),
its collectives being ``Mesh.reduce`` (copies and adds over the slots of
one process, ``_Comm.all_reduce`` between processes).

**Layout** (``ShardedArcFaceStep``). Slot ``(r, c)`` holds a replica of the
net (``mesh._replicas``: the first slot's is the caller's model where it
lives there) and shard ``c`` of the head, classes ``[c C / tp, (c + 1) C /
tp)``; each shard has dp copies, one a row. Dp row ``r`` takes samples
``[r B / dp, (r + 1) B / dp)``, and each of its tp slots embeds all of them,
as the reference's tp chips do. A head whose class count tp does not
divide, or a batch dp does not divide, is refused (the reference's
``NamedSharding`` refuses them too).

**One step**, on each slot's stream:

1. the slot embeds its row's faces (after ``augment_transform`` with the
   row's part of draws made for the whole batch) and computes the ArcFace
   logits of its shard's classes (``models.embedder.arcface_logits``), the
   margin on a sample's own class only where the shard holds it;
2. over each tp row: the row maximum of the logits (MAX), then the sums
   of ``exp(logit - max)`` and of the owner's target logit, zero on the
   other shards (SUM); ``_ShardedArcFaceCE`` turns them into the row's
   share of the loss, ``sum_i (log sum + max - target_i) / B`` with ``B``
   the global batch, and its backward, on each slot with no collective,
   is ``(softmax_local - onehot_local) / B``;
3. the embeddings' gradient is the SUM over the tp row of the slots'
   parts (each shard's classes pull on the same embeddings), and only
   then runs back through the net, so every tp slot of a row computes the
   same parameter gradients;
4. the net's parameter gradients are summed over the dp column only (a
   sum over tp too would count them tp times), each head shard's
   gradient over its dp column, and the loss with them;
5. each slot runs its own Adam (``models._train.adam``, optax's) on its
   replica and its shard.

Every reduction hands each member the same bits (``Mesh.reduce``), and
cuDNN takes deterministic algorithms within the step (a tp row's slots run
the same work and must get the same bits), so the replicas stay equal bit
for bit, and so do a shard's dp copies. A 1x1 mesh runs
``models.embedder.make_train_step`` itself.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from opencv_facerecognizer_tpu_torch.models._train import adam
from opencv_facerecognizer_tpu_torch.models.embedder import (
    FaceEmbedNet, arcface_logits, augment_transform, make_train_step)
from opencv_facerecognizer_tpu_torch.parallel.mesh import (
    DP_AXIS, TP_AXIS, Mesh, _replicas, on_slot, record_event)
from opencv_facerecognizer_tpu_torch.utils.device import disable_tf32


class _ShardedArcFaceCE(torch.autograd.Function):
    """One slot's share of the softmax cross entropy over a tp row:
    ``logits`` [n, C / tp] of its shard's classes, ``onehot`` [n, C / tp]
    (the samples' own classes this shard holds), and the row's
    statistics over every shard: ``row_max`` [n], ``row_sum`` [n] of
    ``exp(logit - row_max)`` and ``row_target`` [n], the samples' own
    logits. Returns ``sum_i (log row_sum + row_max - row_target) /
    batch``, the row's share of the global mean (the same on every slot of
    the row); its gradient is ``(softmax_local - onehot) / batch``."""

    @staticmethod
    def forward(ctx, logits, onehot, row_max, row_sum, row_target, batch: int):
        soft = torch.exp(logits - row_max[:, None]) / row_sum[:, None]
        ctx.save_for_backward(soft, onehot)
        ctx.batch = batch
        return (torch.log(row_sum) + row_max - row_target).sum() / batch

    @staticmethod
    def backward(ctx, grad):
        soft, onehot = ctx.saved_tensors
        return grad * (soft - onehot) / ctx.batch, None, None, None, None, None


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms within the block."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


class ShardedArcFaceStep:
    """One ArcFace step over ``mesh`` (module docstring) for ``model`` and
    the head ``head`` [C, E], trained with Adam at ``learning_rate``, with
    ``arcface_logits``' margin and scale, as the reference's step has them.

    ``step(x, y, draws) -> loss`` takes the whole batch on
    every process (standardized faces [B, H, W], labels [B], with
    ``augment`` the draws of ``augment_draws`` for all B samples) and
    returns the global mean loss on this process's home slot.
    ``nets[i]`` and ``shards[i]`` are slot ``i``'s replica and head shard
    (None on another process's slot); after a step each of their
    parameters' ``.grad`` holds the summed gradient it was updated with.
    ``gather_head()`` returns the head [C, E].

    On a mesh of more than one slot, ``step`` sets the process-wide
    ``torch.backends.cudnn.deterministic`` for its duration and restores it
    after: another thread of the process that runs cuDNN meanwhile (a
    serving thread beside the trainer) gets the deterministic algorithms
    too, and two steps run at once from two threads may restore it in the
    wrong order. Run one step at a time in a process."""

    def __init__(self, mesh: Mesh, model: FaceEmbedNet, head, learning_rate: float = 1e-3,
                 augment: bool = False):
        tp = mesh.shape[TP_AXIS]
        head = (head if isinstance(head, torch.Tensor)
                else torch.as_tensor(np.asarray(head))).detach().float()
        classes = head.shape[0]
        if classes % tp:
            raise ValueError(f"the head's class count {classes} is not divisible by tp={tp}")
        self.mesh = mesh
        self.augment = bool(augment)
        self.per_shard = classes // tp
        slots = list(mesh.devices.flat)
        self._local = [s for s in slots if mesh.is_local(s)]
        if any(s.device.type == "cuda" for s in self._local):
            disable_tf32()
        self.nets = _replicas(model, [s if mesh.is_local(s) else None for s in slots])
        self.shards = [None if net is None else
                       head[(s.id % tp) * self.per_shard:(s.id % tp + 1) * self.per_shard]
                       .to(s.device).clone().requires_grad_(True)
                       for s, net in zip(slots, self.nets)]
        self.optimizers = [None if net is None else adam([*net.parameters(), shard], learning_rate)
                           for net, shard in zip(self.nets, self.shards)]
        self._single = (make_train_step(self.nets[0], self.shards[0], self.optimizers[0],
                                        augment=augment)
                        if mesh.size == 1 else None)

    def step(self, x: torch.Tensor, y: torch.Tensor,
             draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        dp, tp = self.mesh.devices.shape
        batch = x.shape[0]
        if batch % dp:
            raise ValueError(f"batch {batch} is not divisible by dp={dp}")
        if self._single is not None:
            dev = self._local[0].device
            return self._single(x.to(dev), y.to(dev), None if draws is None else
                                {k: v.to(dev) for k, v in draws.items()}, 1.0)
        per = batch // dp
        # each slot's work follows the caller's on its card and on the inputs' card
        start = {d: record_event(d) for d in {x.device, *(s.device for s in self._local)}}
        st = {}
        with _deterministic_cudnn():
            for s in self._local:
                r, c = divmod(s.id, tp)
                with on_slot(s, [e for e in {start[s.device], start[x.device]} if e is not None]):
                    rows = slice(r * per, (r + 1) * per)
                    faces = x[rows].to(s.device, non_blocking=True)
                    if self.augment:
                        faces = augment_transform(faces, {k: v[rows].to(s.device)
                                                          for k, v in draws.items()})
                    net, shard = self.nets[s.id], self.shards[s.id]
                    for p in (*net.parameters(), shard):
                        p.grad = None
                    emb = net(faces)
                    leaf = emb.detach().requires_grad_(True)
                    local = y[rows].to(s.device).long() - c * self.per_shard
                    owned = (local >= 0) & (local < self.per_shard)
                    onehot = (F.one_hot(local.clamp(0, self.per_shard - 1), self.per_shard)
                              * owned[:, None]).to(leaf.dtype)
                    logits = arcface_logits(leaf, onehot, shard)
                    st[s.id] = dict(emb=emb, leaf=leaf, onehot=onehot, logits=logits,
                                    part=logits.detach().amax(dim=1))
            row_max = self.mesh.reduce({i: v["part"] for i, v in st.items()}, TP_AXIS, "max",
                                       "ce_max")
            for s in self._local:
                v = st[s.id]
                with on_slot(s):
                    d = v["logits"].detach()
                    v["part"] = torch.stack([torch.exp(d - row_max[s.id][:, None]).sum(dim=1),
                                             (d * v["onehot"]).sum(dim=1)])
            sums = self.mesh.reduce({i: v["part"] for i, v in st.items()}, TP_AXIS, "sum",
                                    "ce_sum")
            for s in self._local:
                v = st[s.id]
                with on_slot(s):
                    v["loss"] = _ShardedArcFaceCE.apply(v["logits"], v["onehot"], row_max[s.id],
                                                        sums[s.id][0], sums[s.id][1], batch)
                    v["loss"].backward()
            emb_grad = self.mesh.reduce({i: v["leaf"].grad for i, v in st.items()}, TP_AXIS,
                                        "sum", "emb_grad")
            for s in self._local:
                v = st[s.id]
                with on_slot(s):
                    v["emb"].backward(emb_grad[s.id])
                    v["net_grad"] = torch.cat([
                        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                        for p in self.nets[s.id].parameters()])
                    v["head_grad"] = torch.cat([self.shards[s.id].grad.reshape(-1),
                                                v["loss"].detach().reshape(1)])
        net_grad = self.mesh.reduce({i: v["net_grad"] for i, v in st.items()}, DP_AXIS, "sum",
                                    "net_grad")
        head_grad = self.mesh.reduce({i: v["head_grad"] for i, v in st.items()}, DP_AXIS, "sum",
                                     "head_grad")
        done = []
        for s in self._local:
            with on_slot(s):
                flat, o = net_grad[s.id], 0
                for p in self.nets[s.id].parameters():
                    p.grad = flat[o:o + p.numel()].view_as(p)
                    o += p.numel()
                shard = self.shards[s.id]
                shard.grad = head_grad[s.id][:-1].view_as(shard)
                self.optimizers[s.id].step()
                done.append((s.device, record_event(s.device)))
        for dev, ev in done:
            if ev is not None:
                torch.cuda.current_stream(dev).wait_event(ev)
        loss = head_grad[self.mesh.home.id][-1]
        if loss.is_cuda:  # read on the caller's stream from here on
            loss.record_stream(torch.cuda.current_stream(loss.device))
        return loss

    def gather_head(self) -> torch.Tensor:
        """The head [C, E] on this process's home slot's device: each
        shard as the lowest-ranked process holding it has it (across
        processes, one all-gather over every process)."""
        tp = self.mesh.shape[TP_AXIS]
        home = self.mesh.home.device
        mine = [None] * tp
        for s in self._local:
            if mine[s.id % tp] is None:
                mine[s.id % tp] = self.shards[s.id].detach().to(home)
        comm = self.mesh.comm
        if comm is None:
            return torch.cat(mine)
        blank = torch.zeros_like(next(m for m in mine if m is not None))
        every = comm.all_gather(torch.cat([blank if m is None else m for m in mine]),
                                comm.group, "head")
        per = self.per_shard
        return torch.cat([every[min(self.mesh.col_ranks(c)), c * per:(c + 1) * per]
                          for c in range(tp)])
