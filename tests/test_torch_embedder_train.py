"""ArcFace training of the PyTorch port against the JAX package's, on the
CPU, in float32 (both packages' nets built in f32: in bf16 XLA and eager
torch round at other points).

- ``arcface_loss``: value and gradients (embeddings and head) at margins 0
  and 0.5, with cosines inside and beyond the +-(1 - 1e-6) clip.
- ``augment_transform`` given the reference's own draws (the same
  ``jax.random.split(key, 10)`` and calls) equals ``augment_batch``;
  the port's own draws (``augment_draws``) follow the reference's ranges.
- The cosine schedule equals optax's; the port's Adam update equals
  optax's given equal gradients.
- One ``make_train_step`` step from one init carried across: the loss,
  and each gradient tensor relative to its largest |g| (Adam would
  magnify roundoff in the parameters themselves, so they are compared
  through the update given equal gradients instead).
- ``train_embedder`` and ``CNNEmbedding.compute`` over 5 steps from one
  carried-across init: the loss trajectory and the embeddings.
- The bf16 forward of every net gives every float32 parameter a
  gradient, close to the f32 forward's; a net trained in place and then
  run under ``no_grad`` reads its new weights (the cached casts follow).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from opencv_facerecognizer_tpu.models import cascade as jax_cascade
from opencv_facerecognizer_tpu.models import detector as jax_detector
from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu_torch.models import cascade as port_cascade
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.models._train import adam
from opencv_facerecognizer_tpu_torch.utils.params import (
    embedder_params_from_flax, embedder_params_to_flax, embedder_train_params_from_flax,
    embedder_train_params_to_flax)
from torch_train_support import GradView, one_torch_thread  # noqa: F401

TINY = dict(embed_dim=16, stem_features=8, stage_features=(8, 16), stage_blocks=(2, 1))
SIZE = (32, 32)
#: loss values in f32 (a sum of logs over a batch, other op order)
LOSS_RTOL = 1e-5
#: gradients: |port - ref| / max |ref| per tensor, f32 autograd against
#: XLA's in another order
GRAD_RTOL = 1e-4
#: the augmented faces (standardized pixels): the same bilinear weights,
#: cos / sin and the coordinates in f32, in another order
AUG_ATOL = 1e-5
#: one Adam update given equal gradients, absolute on the parameters
ADAM_ATOL = 1e-7
#: the bf16 forward's gradients against the f32 forward's, per tensor
#: relative to its largest |g|: within this factor of the JAX package's
#: own worst bf16-against-f32 gap over the same net, params and data, plus
#: BF16_GRAD_RTOL (bf16 keeps 8 bits: ~4e-3 a rounding, compounded
#: through the GroupNorms). Not the same tensor's gap: XLA and eager torch
#: round at other points, so the two packages' noisiest tensors differ
#: (the light net's last GroupNorm bias moves 0.0076 in the reference and
#: 0.11 in the port; the s = 2 stem's GroupNorm bias 0.16 and 0.74)
BF16_GRAD_FACTOR = 2.0
BF16_GRAD_RTOL = 0.05
#: and each tensor's bf16 gradient points the f32 one's way and has its
#: size, which the bound above alone does not hold (a zero gradient is
#: 1.0 from any gradient): its cosine with the f32 gradient at least the
#: reference's worst over the net less BF16_GRAD_COS_MARGIN (the
#: reference's own reaches down to 0.897 on the s = 2 stem), and its L2
#: norm within BF16_GRAD_NORM of the f32 one's (0.82-1.07 measured)
BF16_GRAD_COS_MARGIN = 0.1
BF16_GRAD_NORM = (0.75, 1 / 0.75)


def _faces(n, seed=0, size=SIZE):
    return np.random.default_rng(seed).standard_normal((n, *size)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def jax_draws(key, n, h, w, occlusion_p=0.5, max_shift=3, max_rotate_deg=14.0,
              scale_jitter=0.1):
    """``augment_batch``'s draws for ``key``, computed as it computes them."""
    (k_flip, k_oy, k_ox, k_app, k_oh, k_ow, k_cy, k_cx,
     k_rot, k_sc) = jax.random.split(key, 10)
    d = {
        "flip": jax.random.bernoulli(k_flip, 0.5, (n,)),
        "angle": jax.random.uniform(k_rot, (n,), minval=-max_rotate_deg,
                                    maxval=max_rotate_deg) * (jnp.pi / 180.0),
        "scale": jax.random.uniform(k_sc, (n,), minval=1.0 - scale_jitter,
                                    maxval=1.0 + scale_jitter),
        "oy": jax.random.randint(k_oy, (n,), 0, 2 * max_shift + 1),
        "ox": jax.random.randint(k_ox, (n,), 0, 2 * max_shift + 1),
        "apply": jax.random.bernoulli(k_app, occlusion_p, (n,)),
        "oh": jax.random.randint(k_oh, (n,), h // 5, h // 2),
        "ow": jax.random.randint(k_ow, (n,), w // 5, w // 2),
        "cy": jax.random.randint(k_cy, (n,), 0, h),
        "cx": jax.random.randint(k_cx, (n,), 0, w),
    }
    out = {}
    for k, v in d.items():
        v = np.asarray(v)
        out[k] = torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v.copy())
    return out


def _pair(num_classes, seed=0, cfg=TINY):
    """A flax f32 net with ``init_embedder``'s params, and the port's f32
    net and head loaded from them."""
    jnet = jax_embedder.FaceEmbedNet(**cfg, dtype=jnp.float32)
    params = jax_embedder.init_embedder(jnet, num_classes, SIZE, seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    pnet = port_embedder.FaceEmbedNet(**cfg, dtype=torch.float32, input_size=SIZE)
    head = embedder_train_params_from_flax(params, pnet)
    return jnet, params, pnet, head


def _port_grads_as_flax(pnet, head):
    """The port's ``.grad`` of each parameter, in the flax tree's layout."""
    shadow = port_embedder.FaceEmbedNet(**TINY, dtype=torch.float32, input_size=SIZE)
    shadow.load_state_dict({n: p.grad for n, p in pnet.named_parameters()})
    return embedder_train_params_to_flax(shadow, head.grad)


# ---------- arcface_loss ----------


@pytest.mark.parametrize("margin", [0.0, 0.5])
@pytest.mark.parametrize("at_clip", [False, True])
def test_arcface_loss_and_grads_match_jax(margin, at_clip):
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((12, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    w = rng.standard_normal((5, 16)).astype(np.float32) * 3
    y = rng.integers(0, 5, 12).astype(np.int32)
    if at_clip:  # cosines of exactly +-1, beyond the clip: no gradient through them
        wn = w / np.linalg.norm(w, axis=1, keepdims=True)
        emb[:4] = wn[y[:4]]
        emb[4:6] = -wn[(y[4:6] + 1) % 5]

    def ref(e, ww):
        return jax_embedder.arcface_loss(e, jnp.asarray(y), ww, margin=margin)

    want, (ge, gw) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(w))
    e_t = torch.tensor(emb, requires_grad=True)
    w_t = torch.tensor(w, requires_grad=True)
    got = port_embedder.arcface_loss(e_t, torch.tensor(y), w_t, margin=margin)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    assert _rel(e_t.grad, ge) <= GRAD_RTOL
    assert _rel(w_t.grad, gw) <= GRAD_RTOL
    # the mean softmax cross entropy of the margin logits
    assert np.isfinite(got.item())


# ---------- augmentation ----------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_transform_matches_jax_given_its_draws(seed):
    n, (h, w) = 16, SIZE
    x = _faces(n, seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_embedder.augment_batch(key, jnp.asarray(x)))
    got = port_embedder.augment_transform(torch.tensor(x), jax_draws(key, n, h, w)).numpy()
    np.testing.assert_allclose(got, want, atol=AUG_ATOL)


def test_augment_transform_edges_and_identity():
    """No rotation, unit scale, centred shift, no cutout, no flip: the
    faces come back unchanged; a full shift reads the replicated edge."""
    n, (h, w) = 3, SIZE
    x = _faces(n, 7)
    draws = {"flip": torch.zeros(n, dtype=torch.bool), "angle": torch.zeros(n),
             "scale": torch.ones(n), "oy": torch.full((n,), 3), "ox": torch.full((n,), 3),
             "apply": torch.zeros(n, dtype=torch.bool), "oh": torch.full((n,), 6),
             "ow": torch.full((n,), 6), "cy": torch.zeros(n, dtype=torch.long),
             "cx": torch.zeros(n, dtype=torch.long)}
    np.testing.assert_array_equal(port_embedder.augment_transform(torch.tensor(x), draws).numpy(), x)
    draws["oy"] = torch.zeros(n, dtype=torch.long)
    got = port_embedder.augment_transform(torch.tensor(x), draws).numpy()
    np.testing.assert_array_equal(got[:, :3], np.repeat(x[:, :1], 3, axis=1))
    np.testing.assert_array_equal(got[:, 3:], x[:, :h - 3])


def test_augment_draws_follow_the_reference_ranges():
    n, h, w = 20000, 64, 48
    d = port_embedder.augment_draws(torch.Generator().manual_seed(0), n, h, w)
    assert abs(d["flip"].float().mean().item() - 0.5) < 0.02
    assert abs(d["apply"].float().mean().item() - 0.5) < 0.02
    deg = d["angle"] * 180 / np.pi
    assert -14.0 <= deg.min().item() and deg.max().item() <= 14.0
    assert abs(deg.mean().item()) < 0.3 and abs(deg.std().item() - 28 / 12 ** 0.5) < 0.2
    assert 0.9 <= d["scale"].min().item() and d["scale"].max().item() <= 1.1
    for k, lo, hi in (("oy", 0, 7), ("ox", 0, 7), ("oh", h // 5, h // 2), ("ow", w // 5, w // 2),
                      ("cy", 0, h), ("cx", 0, w)):
        vals = d[k].unique().tolist()
        assert vals == list(range(lo, hi)), k  # randint's high is exclusive
    again = port_embedder.augment_draws(torch.Generator().manual_seed(0), n, h, w)
    assert all(torch.equal(d[k], again[k]) for k in d)


# ---------- schedule and optimizer ----------


@pytest.mark.parametrize("steps", [1, 7, 2000, 30000])
def test_cosine_schedule_matches_optax(steps):
    lr = 2e-3
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.01)
    factor = port_embedder.cosine_decay(steps)
    for i in sorted({0, 1, steps // 3, steps // 2, steps - 1, steps, steps + 5}):
        assert abs(lr * factor(i) - float(sched(i))) <= 1e-7 * lr, i
    # LambdaLR hands step i the rate lr(i), from lr(0) = lr
    p = torch.zeros(1, requires_grad=True)
    opt = torch.optim.SGD([p], lr=lr)
    lam = torch.optim.lr_scheduler.LambdaLR(opt, factor)
    seen = []
    for _ in range(3):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        lam.step()
    np.testing.assert_allclose(seen, [float(sched(i)) for i in range(3)], rtol=1e-6)
    assert seen[0] == lr


def test_adam_update_matches_optax_given_equal_grads():
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((7, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32) * 0.01}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * s
              for (k, v), s in zip(params.items(), (1.0, 1e-6))} for _ in range(3)]
    opt = optax.adam(1e-3)
    state = opt.init(params)
    want = dict(params)
    tensors = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    port = adam(list(tensors.values()), 1e-3)
    for g in grads:
        updates, state = opt.update(g, state, want)
        want = optax.apply_updates(want, updates)
        for k, t in tensors.items():
            t.grad = torch.tensor(g[k])
        port.step()
        for k, t in tensors.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(want[k]), rtol=0,
                                       atol=ADAM_ATOL)


# ---------- one step, five steps ----------


@pytest.mark.parametrize("augment", [False, True])
def test_train_step_loss_and_grads_match_jax(augment):
    n_cls, n = 6, 12
    jnet, params, pnet, head = _pair(n_cls)
    x = _faces(n, 11)
    y = np.random.default_rng(1).integers(0, n_cls, n).astype(np.int32)
    key = jax.random.PRNGKey(4)

    def loss_fn(p):
        xx = jax_embedder.augment_batch(key, jnp.asarray(x)) if augment else jnp.asarray(x)
        emb = jnet.apply({"params": p["net"]}, xx)
        return jax_embedder.arcface_loss(emb, jnp.asarray(y), p["head"], 0.5 * 0.3, 32.0)

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    head = head.requires_grad_(True)
    step = port_embedder.make_train_step(pnet, head, adam([*pnet.parameters(), head], 1e-3),
                                         margin=0.5, scale=32.0, augment=augment)
    draws = jax_draws(key, n, *SIZE) if augment else None
    got = step(torch.tensor(x), torch.tensor(y), draws, 0.3)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    got_tree = _port_grads_as_flax(pnet, head)
    for path, g in jax.tree_util.tree_flatten_with_path(got_tree)[0]:
        assert _rel(g, flat_want[path]) <= GRAD_RTOL, jax.tree_util.keystr(path)
    assert len(flat_want) == len(jax.tree_util.tree_leaves(got_tree))


def _reference_losses(jnet, params, x, y, *, steps, batch_size, lr, seed, lr_schedule):
    """``train_embedder``'s loop (no augmentation), keeping its losses."""
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.01) if lr_schedule == "cosine" else lr
    optimizer = optax.adam(sched)
    opt_state = optimizer.init(params)
    step = jax_embedder.make_train_step(jnet, optimizer, 0.5, 32.0)
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    n, losses = len(x), []
    for i in range(steps):
        idx = rng.choice(n, size=batch_size, replace=n < batch_size)
        key, sub = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, jnp.asarray(x[idx]),
                                       jnp.asarray(y[idx]), sub,
                                       jnp.float32(min(1.0, i / max(1, int(0.1 * steps)))))
        losses.append(float(loss))
    return params, losses


def test_train_embedder_matches_jax_over_five_steps():
    n_cls = 6
    jnet, params, pnet, head = _pair(n_cls, seed=2)
    x = _faces(30, 12)
    y = (np.arange(30) % n_cls).astype(np.int32)
    kw = dict(steps=5, batch_size=8, seed=9, lr_schedule="cosine")
    want_params, want_losses = _reference_losses(jnet, params, x, y, lr=3e-3, **kw)
    jax_out = jax_embedder.train_embedder(jnet, params, x, y, learning_rate=3e-3, **kw)
    losses = []
    got_head = port_embedder.train_embedder(pnet, head, x, y, learning_rate=3e-3,
                                            callback=lambda i, l: losses.append(float(l)), **kw)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    probe = _faces(8, 13)
    want = np.asarray(jnet.apply({"params": jax_out["net"]}, jnp.asarray(probe)))
    with torch.no_grad():
        got = pnet(torch.tensor(probe)).numpy()
    assert np.sum(got * want, axis=1).min() >= 0.9999
    np.testing.assert_allclose(got_head.numpy(), np.asarray(jax_out["head"]), atol=5 * 3e-3)
    for a, b in zip(jax.tree_util.tree_leaves(jax_out), jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))  # the loop is the reference's


@pytest.fixture
def f32_embedders(monkeypatch):
    monkeypatch.setattr(jax_embedder, "FaceEmbedNet",
                        functools.partial(jax_embedder.FaceEmbedNet, dtype=jnp.float32))
    monkeypatch.setattr(port_embedder, "FaceEmbedNet",
                        functools.partial(port_embedder.FaceEmbedNet, dtype=torch.float32))


def test_cnn_embedding_compute_trains_like_jax(f32_embedders):
    """``compute`` with ``train_steps > 0`` on sparse labels (remapped to
    0-based, the head sized by the class count) from one init carried
    across (the reference's ``init_embedder`` at the head's size)."""
    kw = dict(embed_dim=16, input_size=SIZE, stem_features=8, stage_features=(8, 16),
              stage_blocks=(1, 1), train_steps=5, batch_size=8, learning_rate=2e-3,
              seed=3, lr_schedule="cosine", tta=True)
    rng = np.random.default_rng(4)
    X = (rng.random((18, 40, 36)) * 255).astype(np.float32)
    y = np.repeat([900, 5, 77], 6)
    ref = jax_embedder.CNNEmbedding(**kw)
    init = jax_embedder.init_embedder(ref.net, 3, SIZE, 0)
    ref.load_params(init)
    port = port_embedder.CNNEmbedding(**kw, device="cpu")
    port.load_params(jax.tree_util.tree_map(np.asarray, init))
    want = np.asarray(ref.compute(X, y))
    got = port.compute(X, y).numpy()
    assert port._head.shape == (3, 16)
    assert np.sum(got * want, axis=1).min() >= 0.9999
    # the trained state round-trips to the reference's layout
    state = port.get_state()
    assert sorted(state) == sorted(ref.get_state())


# ---------- the bridge ----------


def test_train_params_bridge_both_ways():
    _jnet, params, pnet, head = _pair(4, seed=6)
    back = embedder_train_params_to_flax(pnet, head)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)


# ---------- the cast under autograd (the C.23 repair) ----------


def _scenes(n=4, size=(32, 32)):
    from opencv_facerecognizer_tpu_torch.utils.dataset import make_synthetic_scenes

    return make_synthetic_scenes(n, size, max_faces=2, face_size_range=(8, 14), seed=5)


def _grad_pairs(kind, kw):
    """(flax net factory, port net factory, flax params, param bridges
    (from flax, to flax), flax loss(net, p), port loss(net)) for one net
    kind."""
    if kind == "embedder":
        jnet = lambda dt: jax_embedder.FaceEmbedNet(**TINY, **kw, dtype=dt)  # noqa: E731
        pnet = lambda dt: port_embedder.FaceEmbedNet(  # noqa: E731
            **TINY, **kw, dtype=dt, input_size=SIZE)
        x = np.abs(_faces(8, 21))
        y = np.arange(8) % 4
        params = jax_embedder.init_embedder(jnet(jnp.float32), 4, SIZE, 0)
        head = np.asarray(params["head"])
        return (jnet, pnet, params["net"], (embedder_params_from_flax, embedder_params_to_flax),
                lambda n, p: jax_embedder.arcface_loss(n.apply({"params": p}, jnp.asarray(x)),
                                                       jnp.asarray(y), jnp.asarray(head), 0.5),
                lambda n: port_embedder.arcface_loss(n(torch.tensor(x)), torch.tensor(y),
                                                     torch.tensor(head), 0.5))
    scenes, boxes, counts = _scenes()
    if kind == "detector":
        cfg = dict(features=(8, 8), head_features=8, space_to_depth=2)
        targets = dict(zip(("heatmap", "size", "offset", "mask"),
                           jax_detector.gaussian_heatmap_targets(boxes, counts, (32, 32), 2)))
        jnet = lambda dt: jax_detector.DetectorNet(**cfg, dtype=dt)  # noqa: E731
        pnet = lambda dt: port_detector.DetectorNet(**cfg, dtype=dt)  # noqa: E731
        from opencv_facerecognizer_tpu_torch.utils.params import (
            detector_params_from_flax, detector_params_to_flax)

        return (jnet, pnet, jnet(jnp.float32).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32)))[
            "params"], (detector_params_from_flax, detector_params_to_flax),
                lambda n, p: jax_detector.detector_loss(n.apply({"params": p}, jnp.asarray(scenes)),
                                                        {k: jnp.asarray(v) for k, v in targets.items()}),
                lambda n: port_detector.detector_loss(n(torch.tensor(scenes)),
                                                      {k: torch.tensor(v) for k, v in targets.items()}))
    from opencv_facerecognizer_tpu_torch.utils.params import (
        cascade_params_from_flax, cascade_params_to_flax)

    t = jax_cascade.tile_targets(boxes, counts, (32, 32), 16)
    jnet = lambda dt: jax_cascade.CascadeNet(dtype=dt)  # noqa: E731
    pnet = lambda dt: port_cascade.CascadeNet(dtype=dt)  # noqa: E731
    return (jnet, pnet, jnet(jnp.float32).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32)))[
        "params"], (cascade_params_from_flax, cascade_params_to_flax),
            lambda n, p: jax_cascade.gate_loss(n.apply({"params": p}, jnp.asarray(scenes)),
                                               jnp.asarray(t)),
            lambda n: port_cascade.gate_loss(n(torch.tensor(scenes)), torch.tensor(t)))


GRAD_NETS = [("embedder", {}), ("embedder", dict(block="dense")),
             ("embedder", dict(norm="light")), ("embedder", dict(space_to_depth=2)),
             ("detector", {}), ("cascade", {})]


@pytest.mark.parametrize("kind,kw", GRAD_NETS, ids=[f"{k}-{kw}" for k, kw in GRAD_NETS])
def test_bf16_forward_gives_every_parameter_a_gradient(kind, kw):
    """Every f32 parameter gets a gradient through the bf16 forward, and
    each tensor's is as close to the f32 forward's as the JAX package's
    own bf16 gradients come to its f32 ones over the same net (the
    BF16_GRAD_* bounds): per entry, in direction and in size."""
    jnet, pnet, params, (load, to_flax), jax_loss, port_loss = _grad_pairs(kind, kw)
    params = jax.tree_util.tree_map(np.asarray, params)
    want = {dt: jax.jit(jax.grad(lambda p, dt=dt: jax_loss(jnet(dt), p)))(params)
            for dt in (jnp.bfloat16, jnp.float32)}
    pairs = [(a, b) for a, b in zip(jax.tree_util.tree_leaves(want[jnp.bfloat16]),
                                    jax.tree_util.tree_leaves(want[jnp.float32]))
             if np.abs(np.asarray(b)).max() > 0]
    rel_bound = BF16_GRAD_FACTOR * max(_rel(a, b) for a, b in pairs) + BF16_GRAD_RTOL
    cos_bound = min(_cos(a, b) for a, b in pairs) - BF16_GRAD_COS_MARGIN
    got = {}
    for dt in (torch.bfloat16, torch.float32):
        net = load(params, pnet(dt))
        port_loss(net).backward()
        assert all(p.grad is not None and p.grad.dtype == torch.float32
                   for p in net.parameters()), dt
        got[dt] = dict(jax.tree_util.tree_flatten_with_path(to_flax(GradView(net)))[0])
    assert len(got[torch.float32]) == len(jax.tree_util.tree_leaves(params))
    for path, g in got[torch.float32].items():
        if np.abs(g).max() == 0:
            continue
        name, b16 = jax.tree_util.keystr(path), got[torch.bfloat16][path]
        assert _rel(b16, g) <= rel_bound, name
        assert _cos(b16, g) >= cos_bound, name
        lo, hi = BF16_GRAD_NORM
        assert lo <= np.linalg.norm(b16) / np.linalg.norm(g) <= hi, name


def test_no_grad_forward_after_a_step_reads_the_new_weights():
    net = port_embedder.FaceEmbedNet(**TINY, input_size=SIZE)  # bf16 compute
    x = torch.tensor(_faces(6, 2))
    with torch.no_grad():
        net(x)  # fill the cached casts
    head = port_embedder.draw_head(3, 16, 0).requires_grad_(True)
    step = port_embedder.make_train_step(net, head, adam([*net.parameters(), head], 1e-2))
    step(x, torch.tensor([0, 1, 2, 0, 1, 2]), None, 1.0)
    with torch.no_grad():
        got = net(x)
        fresh = port_embedder.FaceEmbedNet(**TINY, input_size=SIZE)
        fresh.load_state_dict(net.state_dict())
        want = fresh(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    from opencv_facerecognizer_tpu_torch.models._layers import cast_param

    with torch.no_grad():
        cached = cast_param(net.blocks[0].pw, "weight", torch.bfloat16)
    assert torch.equal(cached, net.blocks[0].pw.weight.detach().to(torch.bfloat16))


def test_init_embedder_reseeds_the_net_and_draws_the_head():
    """``init_embedder`` gives the net the weights a fresh net draws from
    ``seed`` (LeCun-normal variances, as flax's: C.22) and the head
    ``draw_head(C, E, seed + 1)``; a wrong input shape raises."""
    net = port_embedder.FaceEmbedNet(**TINY, input_size=SIZE,
                                     generator=torch.Generator().manual_seed(99))
    head = port_embedder.init_embedder(net, 5, SIZE, seed=4)
    fresh = port_embedder.FaceEmbedNet(**TINY, input_size=SIZE,
                                       generator=torch.Generator().manual_seed(4))
    for k, v in fresh.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    assert torch.equal(head, port_embedder.draw_head(5, 16, 5)) and head.shape == (5, 16)
    with pytest.raises(ValueError, match="input_shape"):
        port_embedder.init_embedder(net, 5, (16, 16))


@pytest.mark.parametrize("grad", [True, False])
def test_a_load_refreshes_the_cached_casts_in_place_in_any_grad_mode(grad):
    """A captured serving graph reads each cached cast by address, so
    ``load_state_dict`` must refresh the copies in place whether grad is
    enabled or not (the C.23 repair returns an uncached cast only to a
    forward under autograd)."""
    net = port_embedder.FaceEmbedNet(**TINY, input_size=SIZE)  # bf16 compute
    with torch.no_grad():
        net(torch.tensor(_faces(2, 3)))
    from opencv_facerecognizer_tpu_torch.models._layers import cast_param

    with torch.no_grad():
        cached = cast_param(net.blocks[0].pw, "weight", torch.bfloat16)
    ptr = cached.data_ptr()
    new = port_embedder.FaceEmbedNet(**TINY, input_size=SIZE,
                                     generator=torch.Generator().manual_seed(7)).state_dict()
    with torch.set_grad_enabled(grad):
        net.load_state_dict(new)
    assert cached.data_ptr() == ptr
    assert torch.equal(cached, new["blocks.0.pw.weight"].to(torch.bfloat16))
