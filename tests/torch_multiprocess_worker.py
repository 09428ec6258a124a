"""The two worker processes of the port's mesh across processes, and the
harness that runs them (``Workers``).

``run(rank, port, root, case)`` is one process of
``tests/test_torch_multiprocess.py``'s group: it joins through the port's
own ``initialize_multihost("127.0.0.1:<port>", 2, rank)`` (``gloo``: no
card), brings two CPU slots to every mesh (four slots in all) and runs
``case``: ``"all"`` runs every case below and saves its tensors to
``root/rank<rank>.pt`` (the sharded ArcFace step's case ``train_run``
among them); ``"die"`` raises on rank 1 after joining, so rank
0 blocks in a collective until the parent ends it. ``run_cards(rank,
port, root)`` and ``train_cards(rank, port, root)`` are one process of
``tests/test_torch_gpu.py``'s four-card cases (``nccl``, two cards a
process). A failure leaves its traceback in
``root/rank<rank>.err`` and a non-zero exit code.

It imports torch and the port only (no JAX): the parents compute the
references. The CPU case's parameters and data come from
``root/stack.pkl``, written by its parent.
"""

import multiprocessing
import os
import pickle
import socket
import sys
import time
import traceback

import numpy as np
import torch

#: the parents' deadline for both workers (they are killed after it)
DEADLINE_S = 180.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Workers:
    """Two processes running ``target(rank, port, root, *args)``, started
    with ``spawn``; ``wait`` returns their saved outputs, or kills both and
    raises as soon as one exits with an error or the deadline passes."""

    def __init__(self, root, target, *args):
        self.root = root
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        self.procs = [ctx.Process(target=target, args=(rank, port, str(root), *args),
                                  daemon=True) for rank in (0, 1)]
        for p in self.procs:
            p.start()
        self.outputs = None

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)

    def wait(self, deadline_s: float = DEADLINE_S) -> list:
        end = time.monotonic() + deadline_s
        while self.outputs is None:
            codes = [p.exitcode for p in self.procs]
            failed = [rank for rank, code in enumerate(codes) if code not in (None, 0)]
            if failed or time.monotonic() > end:
                self.kill()
                errs = [os.path.join(str(self.root), f"rank{r}.err") for r in (0, 1)]
                raise RuntimeError(
                    f"workers failed (ranks {failed}, exit codes {codes}) or passed the "
                    f"{deadline_s} s deadline: "
                    + " | ".join(open(e).read() for e in errs if os.path.exists(e)))
            if all(code == 0 for code in codes):
                self.outputs = [torch.load(os.path.join(str(self.root), f"rank{r}.pt"),
                                           weights_only=False) for r in (0, 1)]
            else:
                time.sleep(0.05)
        return self.outputs

SLOTS = ["cpu", "cpu"]
LAYOUTS = ((1, 4), (2, 2))


def _port_nets(cfg):
    from opencv_facerecognizer_tpu_torch.models import detector as port_detector
    from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
    from opencv_facerecognizer_tpu_torch.utils.params import (
        detector_params_from_flax, embedder_params_from_flax)

    dparams, eparams = cfg["stack"][:2]
    det = port_detector.CNNFaceDetector(**cfg["DET"], max_faces=cfg["MAX_FACES"],
                                        dtype=torch.float32, device="cpu")
    detector_params_from_flax(dparams, det.net)
    net = port_embedder.FaceEmbedNet(**cfg["EMB"], dtype=torch.float32,
                                     input_size=cfg["FACE"])
    embedder_params_from_flax(eparams, net)
    return det, net


class _ReplayGraph:
    """A CPU stand-in for a captured graph: a replay runs the level again
    and copies its outputs into the captured ones."""

    def __init__(self, run, out):
        self.run, self.out = run, out

    def replay(self):
        for old, new in zip(self.out, self.run()):
            for o, n in zip(old, new):
                o.copy_(n)


def _mesh_cases(out: dict) -> None:
    """(a): the slots, their ranks and ``layout()`` at each layout; the
    refusals of unequal device counts and of another process's slot."""
    from opencv_facerecognizer_tpu_torch.parallel import make_mesh
    from opencv_facerecognizer_tpu_torch.parallel.mesh import on_slot

    for dp, tp in ((1, 4), (2, 2), (4, 1)):
        mesh = make_mesh(dp, tp, devices=SLOTS)
        out[f"mesh/{dp}x{tp}"] = dict(
            ids=[s.id for s in mesh.devices.flat], ranks=[s.rank for s in mesh.devices.flat],
            devices=[str(s.device) for s in mesh.devices.flat], layout=repr(mesh.layout()),
            local=[s.id for s in mesh.local_slots], home=mesh.home.id,
            rows=[None if mesh.row_home(r) is None else mesh.row_home(r).id
                  for r in range(dp)])
    try:  # rank 1 brings two slots, rank 0 one: every process refuses
        make_mesh(devices=SLOTS[:1] if torch.distributed.get_rank() == 0 else SLOTS)
    except ValueError as e:
        out["mesh/unequal"] = str(e)
    other = mesh.devices.flat[2 if torch.distributed.get_rank() == 0 else 0]
    try:  # a slot of the other process
        with on_slot(other):
            pass
    except ValueError as e:
        out["mesh/on_other_slot"] = str(e)


def _gallery_cases(out: dict, data: dict) -> None:
    """(b) ``gallery.match`` through ``match_pod`` and ``match_global``,
    dense and sparse; (e) a synchronous grow across a tier; (f) the C.30
    refusal."""
    from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery, make_mesh

    for dp, tp in LAYOUTS:
        mesh = make_mesh(dp, tp, devices=SLOTS)
        for kind, use_kernel in (("pod", True), ("global", False)):
            for fill in ("dense", "sparse"):
                emb, lab = data[f"gallery/{fill}"]
                g = ShardedGallery(data["capacity"], data["dim"], mesh=mesh,
                                   use_kernel=use_kernel)
                g.add(emb, lab)
                held = [[x is not None for x in row] for row in g.data.shards.emb]
                for k in (1, 5):
                    out[f"match/{dp}x{tp}/{kind}/{fill}/{k}"] = g.match(data["queries"], k=k)
                out[f"held/{dp}x{tp}/{kind}/{fill}"] = held
                out[f"meta/{dp}x{tp}/{kind}/{fill}"] = str(g.data.embeddings.device)
        g = ShardedGallery(data["grow_capacity"], data["dim"], mesh=mesh)
        emb, lab = data["gallery/dense"]
        half = len(emb) // 2
        g.add(emb[:half], lab[:half])
        before = g.capacity
        g.add(emb[half:], lab[half:])  # past the tier: a synchronous grow
        out[f"grow/{dp}x{tp}"] = dict(before=before, after=g.capacity, grows=g.grow_count,
                                      snapshot=g.snapshot(), match=g.match(data["queries"], k=5))
    try:
        ShardedGallery(16, data["dim"], mesh=make_mesh(1, 4, devices=SLOTS), async_grow=True)
    except ValueError as e:
        out["async_grow"] = str(e)


def _pipeline_cases(out: dict, cfg: dict) -> None:
    """(c) ``recognize_batch_packed``, eager and level form; (d) pp."""
    from opencv_facerecognizer_tpu_torch.parallel import (
        ShardedGallery, TwoStagePipeline, make_mesh, split_mesh)
    from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline

    _dp, _ep, emb, labels, scenes = cfg["stack"]
    frames = torch.from_numpy(scenes[:8])
    for dp, tp in LAYOUTS:
        det, net = _port_nets(cfg)
        gal = ShardedGallery(64, 32, mesh=make_mesh(dp, tp, devices=SLOTS))
        gal.add(emb, labels)
        pipe = RecognitionPipeline(det, net, gal, face_size=cfg["FACE"], top_k=2,
                                   device="cpu")
        out[f"pipe/{dp}x{tp}/eager"] = pipe.recognize_batch_packed(frames).clone()

        def fake_capture(run, pool=None, device=None):
            res = run()
            return _ReplayGraph(run, res), res, {}

        pipe._capture_graph = fake_capture
        data = gal.data
        step = pipe._capture_levels(pipe._step_key(frames, data), data)
        out[f"pipe/{dp}x{tp}/levels"] = step(frames, data, None).clone()
        other = torch.from_numpy(scenes[8:16])
        out[f"pipe/{dp}x{tp}/levels_again"] = step(other, data, None).clone()
        out[f"pipe/{dp}x{tp}/eager_again"] = pipe.recognize_batch_packed(other).clone()
    det, net = _port_nets(cfg)
    mesh_a, mesh_b = split_mesh(make_mesh(2, 2, devices=SLOTS))
    gal = ShardedGallery(64, 32, mesh=mesh_b)
    gal.add(emb, labels)
    pp = TwoStagePipeline(det, net, None, gal, mesh_a, face_size=cfg["FACE"], top_k=2)
    out["pp/2x2"] = pp.recognize_batch_packed(frames).clone()
    out["pp/2x2/stream"] = [r.labels.clone() for r in pp.recognize_stream(
        [scenes[:8], scenes[8:16], scenes[:8]])]
    out["pp/device"] = str(pp.device)
    out["stats"] = {k: dict(v) for k, v in gal.mesh.comm.stats.items()}


#: the sharded ArcFace step's case: the dryrun's net and classes
#: (``__graft_entry__.py:182-189``), its layouts and steps
TRAIN_NET = dict(embed_dim=32, stem_features=8, stage_features=(8, 16), stage_blocks=(1, 1))
TRAIN_FACE = (32, 32)
TRAIN_CLASSES = 8
TRAIN_LAYOUTS = ((2, 2), (1, 4))
TRAIN_STEPS = 2


def train_run(layout, devices) -> dict:
    """``ShardedArcFaceStep`` over ``make_mesh(*layout, devices)`` for
    TRAIN_STEPS steps from seeded weights and batches: each step's loss;
    each of this process's slots' replica parameters and gradients, head
    shard and its gradient; the gathered head; the mesh's collective
    stats (None on one process)."""
    from opencv_facerecognizer_tpu_torch.models.embedder import FaceEmbedNet, draw_head
    from opencv_facerecognizer_tpu_torch.parallel import ShardedArcFaceStep, make_mesh

    net = FaceEmbedNet(**TRAIN_NET, dtype=torch.float32, input_size=TRAIN_FACE,
                       generator=torch.Generator().manual_seed(18))
    step = ShardedArcFaceStep(make_mesh(*layout, devices=devices), net,
                              draw_head(TRAIN_CLASSES, TRAIN_NET["embed_dim"], 19))
    rng = np.random.default_rng(18)
    losses = []
    for _ in range(TRAIN_STEPS):
        x = torch.from_numpy(rng.standard_normal((8, *TRAIN_FACE)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, TRAIN_CLASSES, 8))
        losses.append(step.step(x, y).clone())
    slots = {s.id: dict(params=[p.detach().clone() for p in step.nets[s.id].parameters()],
                        grads=[p.grad.clone() for p in step.nets[s.id].parameters()],
                        shard=step.shards[s.id].detach().clone(),
                        shard_grad=step.shards[s.id].grad.clone())
             for s in step.mesh.local_slots}
    comm = step.mesh.comm
    return dict(losses=losses, slots=slots, head=step.gather_head(),
                stats=None if comm is None else {k: dict(v) for k, v in comm.stats.items()})


#: the four-card training case's timed step: the HARD recipe's widths
#: (``apps.measure_accuracy.hard_embedder``), batch 192 of 64x64 faces in
#: bf16 over 300 classes, augmented; ms a step by CUDA events over steps
#: HARD_TIME_FROM to HARD_STEPS
HARD_NET = dict(embed_dim=256, stem_features=32, stage_features=(64, 128, 256),
                stage_blocks=(2, 2, 2))
HARD_FACE = (64, 64)
HARD_BATCH = 192
HARD_CLASSES = 300
HARD_STEPS = 10
HARD_TIME_FROM = 3


def hard_step_ms(layout, devices, deterministic: bool = False) -> tuple:
    """(ms a step, the mesh's collectives {name: ms, bytes a call} over
    three more steps timed to their ends, or None on one process) of the
    HARD recipe's step in bf16 over ``make_mesh(*layout, devices)``;
    ``deterministic`` times it under cuDNN's deterministic algorithms,
    which the step itself sets on a mesh of more than one slot."""
    from opencv_facerecognizer_tpu_torch.models.embedder import (
        FaceEmbedNet, augment_draws, draw_head)
    from opencv_facerecognizer_tpu_torch.parallel import ShardedArcFaceStep, make_mesh

    mesh = make_mesh(*layout, devices=devices)
    dev = mesh.home.device
    net = FaceEmbedNet(**HARD_NET, input_size=HARD_FACE,
                       generator=torch.Generator().manual_seed(3)).to(dev)
    step = ShardedArcFaceStep(mesh, net, draw_head(HARD_CLASSES, 256, 4), learning_rate=2e-3,
                              augment=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(HARD_BATCH, *HARD_FACE, generator=gen, device=dev)
    y = torch.randint(0, HARD_CLASSES, (HARD_BATCH,), generator=gen, device=dev)
    first, last = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    prev, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, deterministic
    try:
        for i in range(1, HARD_STEPS + 1):
            if i == HARD_TIME_FROM:
                first.record()
            step.step(x, y, augment_draws(gen, HARD_BATCH, *HARD_FACE))
        last.record()
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = prev
    ms = first.elapsed_time(last) / (HARD_STEPS - HARD_TIME_FROM + 1)
    comm = mesh.comm
    if comm is None:
        return ms, None
    for v in comm.stats.values():
        v.clear()
    comm.sync_timing = True
    for _ in range(3):
        step.step(x, y, augment_draws(gen, HARD_BATCH, *HARD_FACE))
    comm.sync_timing = False
    st = comm.stats
    return ms, {name: dict(ms=st["seconds"][name] * 1e3 / n, bytes=st["bytes"][name] // n,
                           calls_per_step=n / 3) for name, n in st["calls"].items()}


def train_cards(rank: int, port: int, root: str) -> None:
    """One process of two, two cards each, on ``nccl``: the sharded step
    at each of TRAIN_LAYOUTS (``train_run``'s record), and the HARD
    recipe's step there timed (``hard_step_ms``)."""
    try:
        from opencv_facerecognizer_tpu_torch.parallel.mesh import initialize_multihost

        devices = [torch.device("cuda", 2 * rank + i) for i in range(2)]
        torch.cuda.set_device(devices[0])
        assert initialize_multihost(f"127.0.0.1:{port}", 2, rank) is True
        assert torch.distributed.get_backend() == "nccl"
        out = {}
        for layout in TRAIN_LAYOUTS:
            out[layout] = dict(run=train_run(layout, devices))
            out[layout]["ms"], out[layout]["collectives"] = hard_step_ms(layout, devices)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def serving_nets(device, seed: int = 7):
    """The serving detector (a bias that fires on noise) and the serving
    embedder in bf16 on ``device``, weights from ``seed``:
    ``tests/test_torch_gpu.py``'s ``_serving_pipeline`` nets."""
    from opencv_facerecognizer_tpu_torch.models.detector import CNNFaceDetector
    from opencv_facerecognizer_tpu_torch.models.embedder import (
        SERVING_EMBEDDER_KWARGS, SERVING_FACE_SIZE, FaceEmbedNet)

    det = CNNFaceDetector(device=device, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        det.net.heatmap.bias.fill_(0.0)
        det.net.size.bias.fill_(3.0)
    net = FaceEmbedNet(**SERVING_EMBEDDER_KWARGS, input_size=SERVING_FACE_SIZE,
                       generator=torch.Generator().manual_seed(seed + 1)).to(device)
    return det, net


#: the four-card case: rows a card, its (dp, tp) layouts and pp's, the
#: steps timed back to back
CARD_ROWS = 1 << 17
CARD_LAYOUTS = ((1, 4), (2, 2))
CARD_TIME_STEPS = 20


def card_inputs():
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(4 * CARD_ROWS - 1024, 256)).astype(np.float32)
    frames = np.random.default_rng(30).integers(0, 256, (8, 256, 256), dtype=np.uint8)
    return rows, np.arange(len(rows), dtype=np.int32), frames


def card_stack(layout, pp: bool, devices):
    """The four-card case's stack over ``make_mesh(*layout, devices)``
    (this process's cards): the unfused serving stack graphed level by
    level, or with ``pp`` the two-stage pipeline over ``split_mesh`` of
    the mesh."""
    from opencv_facerecognizer_tpu_torch.models.embedder import SERVING_FACE_SIZE
    from opencv_facerecognizer_tpu_torch.parallel import (
        ShardedGallery, TwoStagePipeline, make_mesh, split_mesh)
    from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline

    rows, labels, _frames = card_inputs()
    mesh = make_mesh(*layout, devices=devices)
    mesh_a, mesh_b = split_mesh(mesh) if pp else (None, mesh)
    gal = ShardedGallery(4 * CARD_ROWS, 256, store_dtype=torch.bfloat16, mesh=mesh_b)
    gal.add(rows, labels)
    det, net = serving_nets(mesh.home.device)
    if not pp:
        return RecognitionPipeline(det, net, gal, device=mesh.home.device)
    return TwoStagePipeline(det, net, None, gal, mesh_a, face_size=SERVING_FACE_SIZE)


def step_ms(pipe, frames) -> float:
    """Host-clock ms a step of ``CARD_TIME_STEPS`` steps back to back (one
    synchronize at the end), after three."""
    for _ in range(3):
        pipe.recognize_batch_packed(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CARD_TIME_STEPS):
        pipe.recognize_batch_packed(frames)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / CARD_TIME_STEPS


def run_cards(rank: int, port: int, root: str) -> None:
    """One process of two, two cards each (``cuda:2r``, ``cuda:2r+1``),
    on ``nccl``: each layout's packed result on the first batch, the
    kernels' launches of one step, ms a step back to back and each
    collective's ms (timed to its end on the card)."""
    try:
        from opencv_facerecognizer_tpu_torch.ops.nms import nms_mask
        from opencv_facerecognizer_tpu_torch.ops.streaming_match import streaming_match_topk
        from opencv_facerecognizer_tpu_torch.parallel.mesh import initialize_multihost

        devices = [torch.device("cuda", 2 * rank + i) for i in range(2)]
        torch.cuda.set_device(devices[0])
        assert initialize_multihost(f"127.0.0.1:{port}", 2, rank) is True
        assert torch.distributed.get_backend() == "nccl"
        _rows, _labels, frames = card_inputs()
        out = {}
        for layout, pp in [(lay, False) for lay in CARD_LAYOUTS] + [((2, 2), True)]:
            pipe = card_stack(layout, pp, devices)
            got = pipe.recognize_batch_packed(frames).clone()
            streaming_match_topk.launches = nms_mask.launches = 0
            pipe.recognize_batch_packed(frames)
            torch.cuda.synchronize()
            launches = {"streaming_match": streaming_match_topk.launches,
                        "nms": nms_mask.launches}
            comm = pipe.gallery.mesh.comm
            ms = step_ms(pipe, frames)
            for v in comm.stats.values():
                v.clear()
            comm.sync_timing = True
            for _ in range(CARD_TIME_STEPS):
                pipe.recognize_batch_packed(frames)
            comm.sync_timing = False
            st = comm.stats
            out[("pp" if pp else "mesh", layout)] = dict(
                packed=got.cpu(), launches=launches, ms=ms,
                collectives={name: dict(ms=st["seconds"][name] * 1e3 / n,
                                        calls_per_step=n / CARD_TIME_STEPS,
                                        bytes=st["bytes"][name] // n)
                             for name, n in st["calls"].items()})
            del pipe
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def probe_gloo(rank: int, port: int, root: str, op: str) -> None:
    """One process of two on ``cuda:0`` in a ``gloo`` group: ``op`` (the
    mesh's name, ``"all_gather"``, ``"all_reduce"`` (a sum and a max) or
    ``"send"``) on card tensors, its result saved; a gloo ``send`` of a
    card tensor is expected to kill the sender."""
    import datetime

    try:
        torch.cuda.set_device(0)
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
            timeout=datetime.timedelta(seconds=30))
        t = torch.full((4, 3), float(rank + 1), device="cuda:0")
        if op == "all_gather":
            out = torch.empty(8, 3, device="cuda:0")
            torch.distributed.all_gather_into_tensor(out, t)
            got = out.cpu()
        elif op == "all_reduce":
            total, top = t.clone(), t.clone()
            torch.distributed.all_reduce(total)
            torch.distributed.all_reduce(top, op=torch.distributed.ReduceOp.MAX)
            got = torch.stack([total, top]).cpu()
        elif rank == 0:
            torch.distributed.send(t, 1)
            got = None
        else:
            got = torch.empty_like(t)
            torch.distributed.recv(got, 0)
            got = got.cpu()
        torch.save({"got": got}, os.path.join(root, f"rank{rank}.pt"))
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def run(rank: int, port: int, root: str, case: str) -> None:
    torch.set_num_threads(1)
    try:
        from opencv_facerecognizer_tpu_torch.parallel.mesh import initialize_multihost

        assert initialize_multihost(f"127.0.0.1:{port}", 2, rank) is True
        if case == "die" and rank == 1:
            raise RuntimeError("rank 1 fails before its first collective")
        if case == "die":
            from opencv_facerecognizer_tpu_torch.parallel import make_mesh

            make_mesh(devices=SLOTS)  # waits for rank 1, which never comes
        with open(os.path.join(root, "stack.pkl"), "rb") as f:
            cfg = pickle.load(f)
        out: dict = {}
        _mesh_cases(out)
        _gallery_cases(out, cfg["gallery"])
        _pipeline_cases(out, cfg)
        for layout in TRAIN_LAYOUTS:
            out[f"train/{layout[0]}x{layout[1]}"] = train_run(layout, SLOTS)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
