"""Streaming match (kernel A) and the single-device gallery of the PyTorch
port against the JAX package: the port's plain version on the CPU against
the Pallas kernel in interpret mode, and the gallery's matchers against
the JAX gallery's, on the same numpy inputs.

Tolerances: both sides round the operands to bf16 and accumulate in f32,
in different orders, so sims agree to f32 noise (``SIM_ATOL``). Indices
are held exactly, except where two rows' sims differ by less than that
noise (``tie_aware_mismatch``, whose 2e-2 band is the JAX package's own
for tie-heavy galleries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.ops.ivf_match import tie_aware_mismatch
from opencv_facerecognizer_tpu.ops.pallas_match import (
    streaming_match_topk as jax_match)
from opencv_facerecognizer_tpu.parallel import gallery as jax_gallery
from opencv_facerecognizer_tpu.parallel.mesh import make_mesh
from opencv_facerecognizer_tpu_torch.ops.streaming_match import (
    NEG_INF, streaming_match_topk, streaming_match_topk_plain)
from opencv_facerecognizer_tpu_torch.parallel import gallery as port_gallery

#: f32 accumulation of the same bf16 products in another order
SIM_ATOL = 1e-5


def _normed(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _case(name):
    rng = np.random.default_rng(7)
    if name == "duplicate_rows":  # exact ties across tiles
        q, g = _normed(rng, (16, 64)), _normed(rng, (512, 64))
        g[256:384] = g[0:128]
        g[400:416] = q  # planted queries, then duplicated: sim ties at 1.0
        g[500:512] = q[:12]
        valid = np.ones(512, bool)
        return q, g, valid, 4, np.float32
    if name == "fewer_valid_than_k":  # sentinel slots
        q, g = _normed(rng, (8, 32)), _normed(rng, (256, 32))
        valid = np.zeros(256, bool)
        valid[[3, 130, 255]] = True
        return q, g, valid, 5, np.float32
    if name == "ragged":  # Q and N not multiples of any block
        q, g = _normed(rng, (37, 48)), _normed(rng, (301, 48))
        valid = rng.random(301) > 0.2
        return q, g, valid, 3, np.float32
    if name == "bf16_gallery":
        q, g = _normed(rng, (24, 64)), _normed(rng, (384, 64))
        g[200:300] = g[0:100]
        valid = rng.random(384) > 0.1
        return q, g, valid, 2, jnp.bfloat16
    raise ValueError(name)


@pytest.mark.parametrize("name", ["duplicate_rows", "fewer_valid_than_k",
                                  "ragged", "bf16_gallery"])
def test_plain_matches_pallas_kernel(name):
    q, g, valid, k, gdt = _case(name)
    want_v, want_i = jax_match(jnp.asarray(q), jnp.asarray(g, gdt),
                               jnp.asarray(valid), k=k, block_q=8,
                               block_n=128, interpret=True)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    tg = torch.tensor(g).to(torch.bfloat16 if gdt is jnp.bfloat16 else torch.float32)
    got_v, got_i = streaming_match_topk(torch.tensor(q), tg, torch.tensor(valid), k=k)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    assert got_i.dtype == np.int32 and got_v.shape == want_v.shape == (q.shape[0], k)
    np.testing.assert_allclose(got_v, want_v, atol=SIM_ATOL, rtol=0)
    for j in range(k):
        mism = tie_aware_mismatch(got_v[:, j], got_i[:, j], want_v[:, j], want_i[:, j],
                                  atol=SIM_ATOL)
        assert not mism.any(), (j, got_i[mism, j], want_i[mism, j])
    if name == "duplicate_rows":
        # planted rows tie at 1.0: the LOWEST index wins, exactly
        np.testing.assert_array_equal(got_i[:12, 0], want_i[:12, 0])
        np.testing.assert_array_equal(got_i[:12, 0], 400 + np.arange(12))
    if name == "fewer_valid_than_k":
        np.testing.assert_array_equal(got_i, want_i)
        assert (got_i[:, 3:] == -1).all() and (got_v[:, 3:] == np.float32(NEG_INF)).all()


def test_plain_chunks_keep_lowest_index_ties():
    """Ties split across the plain version's gallery chunks still go to
    the lowest index (the running candidates precede each new chunk)."""
    from opencv_facerecognizer_tpu_torch.ops import streaming_match as sm

    rng = np.random.default_rng(3)
    q = torch.tensor(_normed(rng, (4, 16)))
    g = torch.tensor(_normed(rng, (40, 16)))
    g[5], g[25], g[39] = q[0], q[0], q[0]
    valid = torch.ones(40, dtype=torch.bool)
    old = sm.PLAIN_CHUNK
    sm.PLAIN_CHUNK = 8
    try:
        vals, idx = streaming_match_topk_plain(q, g, valid, k=3)
    finally:
        sm.PLAIN_CHUNK = old
    assert idx[0].tolist() == [5, 25, 39]
    ref_v, ref_i = streaming_match_topk_plain(q, g, valid, k=3)
    assert torch.equal(idx, ref_i) and torch.equal(vals, ref_v)


def _jax_gallery(capacity, dim, use_pallas, rows, labels):
    import jax

    gal = jax_gallery.ShardedGallery(capacity, dim, mesh=make_mesh(devices=[jax.devices()[0]]),
                                     use_pallas=use_pallas, store_dtype=jnp.bfloat16)
    gal.add(rows, labels)
    return gal


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gallery_match_matches_jax(use_kernel):
    """Both matcher selections of the port's gallery against the JAX
    gallery with the same selection: labels, sims and rows."""
    rng = np.random.default_rng(11)
    rows = _normed(rng, (150, 32))
    rows[100:120] = rows[0:20]  # duplicate rows: ties
    labels = np.arange(150, dtype=np.int32) % 37
    q = _normed(rng, (12, 32))
    q[:4] = rows[:4]
    jg = _jax_gallery(256, 32, use_kernel, rows, labels)
    pg = port_gallery.ShardedGallery(256, 32, use_kernel=use_kernel,
                                     store_dtype=torch.bfloat16, device="cpu")
    pg.add(rows, labels)
    assert pg.size == 150 and pg.capacity == 256
    jl, jv, ji = (np.asarray(a) for a in jg.match(jnp.asarray(q), k=3))
    pl, pv, pi = (a.numpy() for a in pg.match(torch.tensor(q), k=3))
    np.testing.assert_allclose(pv, jv, atol=SIM_ATOL, rtol=0)
    for j in range(3):
        assert not tie_aware_mismatch(pv[:, j], pi[:, j], jv[:, j], ji[:, j],
                                      atol=SIM_ATOL).any()
    np.testing.assert_array_equal(pi[:4, 0], np.arange(4))  # ties -> lowest row
    np.testing.assert_array_equal(pl[:4, 0], labels[:4])


def test_gallery_grow_reset_and_sentinels():
    pg = port_gallery.ShardedGallery(4, 8, labels_pad=-7, use_kernel=True,
                                     store_dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(0)
    pg.add(_normed(rng, (3, 8)), [10, 11, 12])
    pg.add(_normed(rng, (3, 8)), [13, 14, 15])  # overflows: doubles to 8
    assert (pg.capacity, pg.size, pg.grow_count) == (8, 6, 1)
    assert pg.data.embeddings.dtype == torch.bfloat16
    labels, sims, idx = pg.match(torch.tensor(_normed(rng, (2, 8))), k=8)
    assert (idx[:, 6:] == -1).all() and (labels[:, 6:] == -7).all()
    assert set(labels[:, :6].flatten().tolist()) == {10, 11, 12, 13, 14, 15}
    pg.reset()
    assert pg.size == 0 and not pg.data.valid.any()


def test_take_labels_with_sentinel():
    labels = torch.tensor([5, 6, 7], dtype=torch.int32)
    idx = torch.tensor([[2, -1], [0, 1]], dtype=torch.int32)
    got = port_gallery.take_labels_with_sentinel(labels, idx, -1)
    want = np.asarray(jax_gallery.take_labels_with_sentinel(
        jnp.asarray(labels.numpy()), jnp.asarray(idx.numpy()), -1))
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_selection_mirrors_reference():
    gal = port_gallery.ShardedGallery(8, 4, device="cpu")
    assert not gal.kernel_enabled()  # CPU: the plain matcher
    assert port_gallery.ShardedGallery(8, 4, use_kernel=True, device="cpu").kernel_enabled()
    assert gal.KERNEL_MIN_CAPACITY == jax_gallery.ShardedGallery.PALLAS_MIN_CAPACITY

