"""The port's sharded ArcFace step (``parallel/train.py``) and
``entry.dryrun_multichip`` against the JAX package, on the CPU.

The reference is ``__graft_entry__.py``'s train step (``:181-218``) built
from the JAX package's own functions (``FaceEmbedNet``, ``init_embedder``,
``normalize_faces``, ``arcface_loss``, ``optax.adam(1e-3)``) at the
dryrun's shapes, under the dryrun's ``NamedSharding``s (the net ``P()``,
the head ``P(tp, None)``, faces and labels ``P(dp, ...)``) on the first
dp x tp of conftest's 8 virtual devices; its value and gradient and its
update are jitted apart so the gradients can be read. The port runs
``ShardedArcFaceStep`` on ``make_mesh(dp, tp, devices=["cpu"] * n)`` from
the same parameters carried across. Both nets compute in float32 (in
bf16 XLA and eager torch round at other points).

Tolerances: the loss within LOSS_RTOL; each gradient tensor within
GRAD_RTOL of its largest |g| (f32 sums in another order); the parameters
after STEPS Adam steps within PARAM_ATOL, except where a reference
gradient was within NEAR_ZERO of zero at some step: Adam's update there is
about ``lr * g / |g|``, so a roundoff that flips the gradient's sign moves
the parameter by up to 2 lr a step. 5.8% of the entries take that
allowance here (mostly the exact zeros of channels a ReLU closed); none
has used it (they agree within 6e-8).

GSPMD promises the unsharded step's result, and the port holds to it: its
gradients are compared with the reference's step on one device at every
layout. The reference's sharded step keeps that promise at (1, 2), (2, 1)
and (1, 4); at (2, 2), the dryrun's layout on four devices, it returns
twice the gradient of each grouped convolution's kernel (the GDC and the
depthwise convs) on this JAX (ROADMAP C.32,
``test_reference_doubles_the_grouped_conv_gradients_at_2x2``). Adam's
update barely depends on a gradient's scale, so the parameters after the
update still agree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu.parallel import make_mesh as jax_make_mesh
from opencv_facerecognizer_tpu.parallel.mesh import DP_AXIS, TP_AXIS
from opencv_facerecognizer_tpu_torch.entry import dryrun_multichip
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.models._train import adam
from opencv_facerecognizer_tpu_torch.parallel import ShardedArcFaceStep, make_mesh
from opencv_facerecognizer_tpu_torch.parallel import train as train_mod
from opencv_facerecognizer_tpu_torch.parallel.mesh import TP_AXIS as PORT_TP
from opencv_facerecognizer_tpu_torch.utils.params import (
    embedder_train_params_from_flax, embedder_train_params_to_flax)
from torch_train_support import GradView, one_torch_thread  # noqa: F401

#: the dryrun's shapes (``__graft_entry__.py:182-189``)
FACE = (32, 32)
CLASSES = 8
NET = dict(embed_dim=32, stem_features=8, stage_features=(8, 16), stage_blocks=(1, 1))
LR = 1e-3
STEPS = 3
LAYOUTS = [(1, 2), (2, 1), (2, 2), (1, 4)]

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-6
NEAR_ZERO = 1e-6


def _batch(dp: int) -> int:
    return dp * max(2, -(-8 // dp))


def _batches(dp: int):
    """STEPS batches of raw faces (uniform 0-255) and labels, drawn as
    the dryrun draws its one batch."""
    rng = np.random.default_rng(0)
    b = _batch(dp)
    return [(rng.uniform(0, 255, size=(b, *FACE)).astype(np.float32),
             rng.integers(0, CLASSES, size=b).astype(np.int32)) for _ in range(STEPS)]


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reference_net():
    jnet = jax_embedder.FaceEmbedNet(**NET, dtype=jnp.float32)
    init = jax_embedder.init_embedder(jnet, CLASSES, FACE, seed=0)

    def loss_fn(p, x, y):
        emb = jnet.apply({"params": p["net"]}, jax_embedder.normalize_faces(x, FACE))
        return jax_embedder.arcface_loss(emb, y, p["head"])

    return init, jax.jit(jax.value_and_grad(loss_fn))


@functools.lru_cache(maxsize=None)
def _unsharded(dp: int):
    """(loss, grads) of the reference's step on one device, on the first
    batch of ``_batches(dp)``: what GSPMD promises."""
    init, value_and_grad = _reference_net()
    x, y = _batches(dp)[0]
    loss, grads = value_and_grad(init, jnp.asarray(x), jnp.asarray(y))
    return float(loss), _flat(grads)


@functools.lru_cache(maxsize=None)
def _reference(dp: int, tp: int):
    """(the initial params, [(loss, grads, params after the update)] for
    each step) of the reference's sharded step at ``(dp, tp)``; the trees
    flattened to {path: array}."""
    init, value_and_grad = _reference_net()
    mesh = jax_make_mesh(dp, tp, devices=jax.devices()[:dp * tp])
    params = {"net": jax.device_put(init["net"], NamedSharding(mesh, P())),
              "head": jax.device_put(init["head"], NamedSharding(mesh, P(TP_AXIS, None)))}
    optimizer = optax.adam(LR)
    opt_state = optimizer.init(params)

    @jax.jit
    def update(p, s, g):
        updates, s = optimizer.update(g, s, p)
        return optax.apply_updates(p, updates), s

    out = []
    for x, y in _batches(dp):
        x = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(DP_AXIS, None, None)))
        y = jax.device_put(jnp.asarray(y), NamedSharding(mesh, P(DP_AXIS)))
        loss, grads = value_and_grad(params, x, y)
        params, opt_state = update(params, opt_state, grads)
        out.append((float(loss), _flat(grads), _flat(params)))
    return jax.tree_util.tree_map(np.asarray, init), out


def _port_step(dp, tp, init, augment=False):
    net = port_embedder.FaceEmbedNet(**NET, dtype=torch.float32, input_size=FACE)
    head = embedder_train_params_from_flax(init, net)
    return ShardedArcFaceStep(make_mesh(dp, tp, devices=["cpu"] * (dp * tp)), net, head,
                              learning_rate=LR, augment=augment)


def _port_record(step) -> tuple:
    """(grads, params) of the step's first replica and the whole head, as
    flat flax trees."""
    tp = step.mesh.shape[PORT_TP]
    head_grad = torch.cat([step.shards[c].grad for c in range(tp)])
    grads = _flat(embedder_train_params_to_flax(GradView(step.nets[0]), head_grad))
    params = _flat(embedder_train_params_to_flax(step.nets[0], step.gather_head()))
    return grads, params


def _run_port(step, dp: int) -> list:
    out = []
    for x, y in _batches(dp):
        faces = port_embedder.normalize_faces(torch.from_numpy(x), FACE)
        loss = step.step(faces, torch.from_numpy(y))
        _assert_copies_equal(step)
        out.append((float(loss), *_port_record(step)))
    return out


def _assert_copies_equal(step) -> None:
    """Every replica of the net (parameters and gradients) and every dp
    copy of a head shard equal bit for bit."""
    tp = step.mesh.shape[PORT_TP]
    first = list(step.nets[0].parameters())
    for i, net in enumerate(step.nets):
        for p, q in zip(net.parameters(), first):
            assert torch.equal(p, q) and torch.equal(p.grad, q.grad), i
        assert torch.equal(step.shards[i], step.shards[i % tp]), i
        assert torch.equal(step.shards[i].grad, step.shards[i % tp].grad), i


def _grad_errors(got: dict, want: dict) -> dict:
    assert sorted(got) == sorted(want)
    return {k: float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
            for k in want}


#: the grouped convolutions' kernels, whose gradients the reference's
#: sharded step doubles at (2, 2) (ROADMAP C.32)
GROUPED = {"['net']['Conv_1']['kernel']", "['net']['_SepBlock_0']['Conv_0']['kernel']",
           "['net']['_SepBlock_1']['Conv_0']['kernel']"}


def _diverging(dp: int, tp: int) -> dict:
    """{tensor: ratio} where the reference's sharded gradient is not its
    unsharded one within GRAD_RTOL (the ratio of their largest |g|)."""
    _init, want = _reference(dp, tp)
    _loss, one = _unsharded(dp)
    return {k: float(np.abs(want[0][1][k]).max() / np.abs(one[k]).max())
            for k, e in _grad_errors(want[0][1], one).items() if e > GRAD_RTOL}


@pytest.mark.parametrize("dp,tp", LAYOUTS)
def test_sharded_step_matches_the_reference(dp, tp):
    """Loss and every gradient of the first step against the reference's
    step on one device (GSPMD's promise) and against its sharded step on
    as many devices wherever that keeps the promise; the loss of each
    step, and the parameters after STEPS Adam steps, against the sharded
    step; replicas and shard copies bit-equal after every step."""
    init, want = _reference(dp, tp)
    got = _run_port(_port_step(dp, tp, init), dp)
    for (l_got, _g, _p), (l_want, _gw, _pw) in zip(got, want):
        np.testing.assert_allclose(l_got, l_want, rtol=LOSS_RTOL)
    l_one, g_one = _unsharded(dp)
    np.testing.assert_allclose(got[0][0], l_one, rtol=LOSS_RTOL)
    errs = _grad_errors(got[0][1], g_one)
    assert max(errs.values()) <= GRAD_RTOL, errs
    kept = {k: v for k, v in _grad_errors(got[0][1], want[0][1]).items()
            if k not in _diverging(dp, tp)}
    assert max(kept.values()) <= GRAD_RTOL, kept
    near = {k: np.min([np.abs(w[1][k]) for w in want], axis=0) < NEAR_ZERO for k in want[0][1]}
    for k, p_want in want[-1][2].items():
        diff = np.abs(got[-1][2][k] - p_want)
        assert diff[~near[k]].max(initial=0.0) <= PARAM_ATOL, (k, diff.max())
        assert diff[near[k]].max(initial=0.0) <= 2 * LR * STEPS, k


def test_reference_doubles_the_grouped_conv_gradients_at_2x2():
    """ROADMAP C.32, on the reference's side: its sharded step keeps
    GSPMD's promise at (1, 2), (2, 1) and (1, 4), and at (2, 2) returns
    twice the unsharded gradient of each grouped convolution's kernel and
    of nothing else. (Should a JAX release repair it, this fails, and the
    sharded comparison above covers every tensor again.)"""
    for dp, tp in LAYOUTS:
        ratios = _diverging(dp, tp)
        if (dp, tp) != (2, 2):
            assert ratios == {}, (dp, tp, ratios)
        else:
            assert set(ratios) == GROUPED
            np.testing.assert_allclose(list(ratios.values()), 2.0, rtol=1e-5)


def test_one_slot_mesh_is_make_train_step_bit_for_bit():
    """A 1x1 mesh runs ``make_train_step`` itself: losses, gradients and
    parameters equal bit for bit over STEPS augmented steps."""
    init, _ = _reference(1, 2)
    step = _port_step(1, 1, init, augment=True)
    net = port_embedder.FaceEmbedNet(**NET, dtype=torch.float32, input_size=FACE)
    head = embedder_train_params_from_flax(init, net).requires_grad_(True)
    ref = port_embedder.make_train_step(net, head, adam([*net.parameters(), head], LR),
                                        augment=True)
    for i, (x, y) in enumerate(_batches(1)):
        faces = port_embedder.normalize_faces(torch.from_numpy(x), FACE)
        draws = port_embedder.augment_draws(torch.Generator().manual_seed(i), len(x), *FACE)
        want = ref(faces, torch.from_numpy(y), draws, 1.0)
        got = step.step(faces, torch.from_numpy(y), draws)
        assert torch.equal(got, want)
        for p, q in zip(step.nets[0].parameters(), net.parameters()):
            assert torch.equal(p, q) and torch.equal(p.grad, q.grad)
        assert torch.equal(step.gather_head(), head.detach())


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4)])
def test_augmented_sharded_step_follows_the_one_slot_step(dp, tp):
    """With augmentation the draws are made for the whole batch and split
    by dp row: the sharded step's loss and gradients are the one-slot
    step's within the reference tolerances."""
    init, _ = _reference(1, 2)
    one, many = _port_step(1, 1, init, augment=True), _port_step(dp, tp, init, augment=True)
    x, y = _batches(dp)[0]
    faces = port_embedder.normalize_faces(torch.from_numpy(x), FACE)
    draws = port_embedder.augment_draws(torch.Generator().manual_seed(5), len(x), *FACE)
    l_one = one.step(faces, torch.from_numpy(y), draws)
    l_many = many.step(faces, torch.from_numpy(y), draws)
    np.testing.assert_allclose(float(l_many), float(l_one), rtol=LOSS_RTOL)
    errs = _grad_errors(_port_record(many)[0], _port_record(one)[0])
    assert max(errs.values()) <= GRAD_RTOL, errs


def _mis_sum(monkeypatch, step, rule: str) -> None:
    """Break one of the step's gradient rules."""
    mesh = step.mesh
    reduce = mesh.reduce

    def wrong(parts, axis, op, name):
        if rule == "emb_grad_not_over_tp" and name == "emb_grad":
            return parts
        if rule == "head_grad_not_over_dp" and name == "head_grad":
            return parts
        out = reduce(parts, axis, op, name)
        if rule == "net_grad_over_tp_too" and name == "net_grad":
            out = reduce(out, PORT_TP, op, name)
        return out

    monkeypatch.setattr(mesh, "reduce", wrong)
    if rule == "loss_over_row_batch":
        apply = train_mod._ShardedArcFaceCE.apply
        dp = mesh.shape["dp"]
        monkeypatch.setattr(train_mod._ShardedArcFaceCE, "apply",
                            lambda *a: apply(*a[:-1], a[-1] // dp))


@pytest.mark.parametrize("rule,broken", [
    ("emb_grad_not_over_tp", "net"), ("net_grad_over_tp_too", "net"),
    ("head_grad_not_over_dp", "head"), ("loss_over_row_batch", "net")])
def test_each_gradient_rule_is_pinned(monkeypatch, rule, broken):
    """A step with one rule broken (the embeddings' gradient not summed
    over the tp row; the net's gradients summed over tp as well as dp; a
    head shard's gradient not summed over its dp column; the loss divided
    by the row's batch) fails ``test_sharded_step_matches_the_reference``'s
    gradient check at (2, 2) (against the unsharded step), by far."""
    init, _want = _reference(2, 2)
    step = _port_step(2, 2, init)
    _mis_sum(monkeypatch, step, rule)
    x, y = _batches(2)[0]
    step.step(port_embedder.normalize_faces(torch.from_numpy(x), FACE), torch.from_numpy(y))
    errs = _grad_errors(_port_record(step)[0], _unsharded(2)[1])
    worst = max(v for k, v in errs.items() if (k.startswith("['head']") == (broken == "head")))
    assert worst > 100 * GRAD_RTOL, errs


def test_refusals_match_the_reference():
    """A head whose class count tp does not divide, and a batch dp does
    not divide, are refused, as the reference's ``NamedSharding`` refuses
    them."""
    jmesh = jax_make_mesh(2, 2, devices=jax.devices()[:4])
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((7, 32), np.float32), NamedSharding(jmesh, P(TP_AXIS, None)))
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((7, *FACE), np.float32),
                       NamedSharding(jmesh, P(DP_AXIS, None, None)))
    net = port_embedder.FaceEmbedNet(**NET, dtype=torch.float32, input_size=FACE)
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="class count 7 is not divisible by tp=2"):
        ShardedArcFaceStep(mesh, net, torch.zeros(7, 32))
    step = ShardedArcFaceStep(mesh, net, torch.zeros(8, 32))
    with pytest.raises(ValueError, match="batch 7 is not divisible by dp=2"):
        step.step(torch.zeros(7, *FACE), torch.zeros(7, dtype=torch.int32))


def test_without_a_card_nothing_runs_on_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        make_mesh(2, 2)


def test_dryrun_multichip_prints_the_reference_lines(capsys):
    """``dryrun_multichip(4)`` on four CPU slots prints the reference's
    lines (its mesh, the train step's finite loss, the fused batch's
    shapes, the pp batch on the stage meshes), and refuses three slots."""
    dryrun_multichip(4, devices=["cpu"] * 4)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[dryrun] mesh: dp=2 tp=2 on 4 devices"
    assert lines[1].startswith("[dryrun] sharded ArcFace train step OK, loss=")
    assert np.isfinite(float(lines[1].split("loss=")[1]))
    assert lines[2] == "[dryrun] fused recognition batch OK: boxes (8, 4, 4), labels (8, 4, 1)"
    assert lines[3] == ("[dryrun] pipeline-parallel batch OK: stage meshes {'dp': 1, 'tp': 2} | "
                        "{'dp': 1, 'tp': 2}, labels (8, 4, 1)")
    assert len(lines) == 4
    with pytest.raises(RuntimeError, match="need 4 devices, have 3"):
        dryrun_multichip(4, devices=["cpu"] * 3)
