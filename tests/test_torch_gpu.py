"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips without a card.

This file imports neither JAX nor the JAX package, so it also runs on the
card's machine, which has no JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: kernel A sums the same bf16 products in f32 in another order
(sims within 1e-4, indices equal except ties within it); kernel B outputs
bf16 and may round an intermediate to a neighbouring bf16 value (two bf16
ulps of the output, relative 2^-6).
"""

import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu_torch.ops.sepblock import (
    fused_sep_block, fused_sep_block_plain, launch_info)
from opencv_facerecognizer_tpu_torch.ops.ivf_match import ivf_match_topk
from opencv_facerecognizer_tpu_torch.ops.streaming_match import (
    NEG_INF, streaming_match_topk, streaming_match_topk_plain)
from opencv_facerecognizer_tpu_torch.parallel import quantizer as quant
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery

SIM_ATOL = 1e-4
SEP_RTOL = 2.0 ** -6
#: the six (H, W, C, F, stride) blocks of the serving embedder at 64x64
SERVING_BLOCKS = [(32, 32, 32, 64, 2), (16, 16, 64, 64, 1),
                  (16, 16, 64, 128, 2), (8, 8, 128, 128, 1),
                  (8, 8, 128, 256, 2), (4, 4, 256, 256, 1)]
#: kernel B's streaming batch: over twice the largest grid (2 x 132 CTAs)
SEP_STREAM_B = 601
#: blocks whose F / 8 is not a multiple of 8 (F = 48, 96), stride 1 and 2
OTHER_BLOCKS = [(32, 32, 32, 48, 2), (16, 16, 48, 48, 1), (16, 16, 48, 96, 2),
                (8, 8, 96, 96, 1), (16, 16, 96, 96, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _normed(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.gpu
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
def test_match_kernel_matches_plain(cuda, gdtype):
    rng = np.random.default_rng(5)
    q = torch.tensor(_normed(rng, (77, 256)), device=cuda)
    g = torch.tensor(_normed(rng, (70000, 256)), device=cuda)
    g[60000:60077] = q  # planted, then duplicated: exact ties
    g[65000:65077] = q
    valid = torch.tensor(rng.random(70000) > 0.1, device=cuda)
    valid[65000:65077] = True
    g = g.to(gdtype)
    for k in (1, 5, 16, 17, 64):
        got_v, got_i = streaming_match_topk(q, g, valid, k=k)
        want_v, want_i = streaming_match_topk_plain(q, g, valid, k=k)
        torch.cuda.synchronize()
        assert torch.allclose(got_v, want_v, atol=SIM_ATOL, rtol=0)
        assert not ((got_i != want_i) & ((got_v - want_v).abs() > SIM_ATOL)).any()
        lowest = torch.where(valid[60000:60077], 60000, 65000) + torch.arange(77, device=cuda)
        assert torch.equal(got_i[:, 0].long(), lowest)


def _assert_match(cuda, q, g, valid, k):
    got_v, got_i = streaming_match_topk(q, g, valid, k=k)
    want_v, want_i = streaming_match_topk_plain(q, g, valid, k=k)
    torch.cuda.synchronize()
    assert got_v.shape == (q.shape[0], k) and got_i.dtype == torch.int32
    assert torch.allclose(got_v, want_v, atol=SIM_ATOL, rtol=0)
    assert not ((got_i != want_i) & ((got_v - want_v).abs() > SIM_ATOL)).any()
    return got_v, got_i


@pytest.mark.gpu
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [100, 128, 129, 257, 4097])
@pytest.mark.parametrize("d", [64, 256, 48])
def test_match_kernel_ragged_n(cuda, gdtype, n, d):
    """N below one tile, on a tile edge and one row past it, on both
    paths (D = 48 takes the wmma path for either dtype)."""
    rng = np.random.default_rng(n + d)
    q = torch.tensor(_normed(rng, (37, d)), device=cuda)
    g = torch.tensor(_normed(rng, (n, d)), device=cuda).to(gdtype)
    valid = torch.tensor(rng.random(n) > 0.2, device=cuda)
    for k in (1, 5, 17):
        _assert_match(cuda, q, g, valid, k)


@pytest.mark.gpu
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [5, 16, 17, 64])
def test_match_kernel_sentinels(cuda, gdtype, k):
    """Fewer valid rows than k: the rows in value order, then -1e30 / -1."""
    rng = np.random.default_rng(k)
    q = torch.tensor(_normed(rng, (20, 256)), device=cuda)
    g = torch.tensor(_normed(rng, (3000, 256)), device=cuda).to(gdtype)
    valid = torch.zeros(3000, dtype=torch.bool, device=cuda)
    rows = rng.choice(3000, size=3 if k == 5 else k - 4, replace=False)
    valid[torch.tensor(rows, device=cuda)] = True
    got_v, got_i = _assert_match(cuda, q, g, valid, k)
    m = len(rows)
    assert torch.equal(torch.sort(got_i[:, :m].long(), dim=1)[0],
                       torch.sort(torch.tensor(rows, device=cuda))[0].expand(20, -1))
    assert (got_i[:, m:] == -1).all() and (got_v[:, m:] == NEG_INF).all()


@pytest.mark.gpu
def test_match_kernel_ties_across_passes(cuda):
    """Ten copies of each query: every pass boundary (k = 17, 64) falls
    inside a run of equal sims, which must still come out lowest index
    first."""
    rng = np.random.default_rng(9)
    q = torch.tensor(_normed(rng, (8, 256)), device=cuda)
    g = torch.tensor(_normed(rng, (20000, 256)), device=cuda)
    copies = torch.tensor(np.sort(rng.choice(20000, size=(8, 10), replace=False), axis=1),
                          device=cuda)
    for i in range(8):
        g[copies[i]] = q[i]
    g = g.to(torch.bfloat16)
    valid = torch.ones(20000, dtype=torch.bool, device=cuda)
    for k in (1, 16, 17, 64):
        got_v, got_i = _assert_match(cuda, q, g, valid, k)
        m = min(k, 10)
        assert torch.equal(got_i[:, :m].long(), copies[:, :m])


@pytest.mark.gpu
def test_match_kernel_refuses_k_past_limit(cuda):
    """k has no limit on the card any more (257 was one past it): the
    kernel refuses only what it cannot run, k < 1 and D % 16 != 0."""
    rng = np.random.default_rng(257)
    q = torch.tensor(_normed(rng, (4, 64)), device=cuda)
    g = torch.tensor(_normed(rng, (300, 64)), device=cuda)
    valid = torch.ones(300, dtype=torch.bool, device=cuda)
    valid[250:] = False
    got_v, got_i = _assert_match(cuda, q, g, valid, 257)
    assert (got_i[:, :250] >= 0).all() and (got_i[:, 250:] == -1).all()
    assert (got_v[:, 250:] == NEG_INF).all()
    with pytest.raises(ValueError):
        streaming_match_topk(q, g, valid, k=0)
    with pytest.raises(ValueError, match="D % 16"):
        streaming_match_topk(q[:, :40], g[:, :40], valid)


@pytest.mark.gpu
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
def test_match_kernel_k300_ties_across_passes(cuda, gdtype):
    """k = 300 (19 passes of 16) against the plain version: 40 copies of
    each query put ties across the pass boundaries at ranks 16 and 32, and
    duplicated gallery rows put ties at the later boundaries."""
    rng = np.random.default_rng(300)
    q = torch.tensor(_normed(rng, (8, 256)), device=cuda)
    g = torch.tensor(_normed(rng, (20000, 256)), device=cuda)
    g[10000:20000] = g[0:10000]  # every other row twice: ties at every rank
    copies = torch.tensor(np.sort(rng.choice(20000, size=(8, 40), replace=False), axis=1),
                          device=cuda)
    for i in range(8):
        g[copies[i]] = q[i]
    g = g.to(gdtype)
    valid = torch.ones(20000, dtype=torch.bool, device=cuda)
    got_v, got_i = _assert_match(cuda, q, g, valid, 300)
    assert torch.equal(got_i[:, :40].long(), copies)
    tie = got_v[:, 1:] == got_v[:, :-1]  # equal sims: lowest index first
    assert tie[:, 40:].any() and (got_i[:, 1:] > got_i[:, :-1])[tie].all()


@pytest.mark.gpu
@pytest.mark.parametrize("store_dtype", [torch.bfloat16, torch.float32])
def test_gallery_match_k17_on_kernel(cuda, store_dtype):
    """The public gallery at capacity >= 65536 runs the kernel; k = 17
    (past the one-pass limit) answers as the plain matcher does."""
    rng = np.random.default_rng(17)
    rows = _normed(rng, (70000, 256))
    labels = np.arange(70000, dtype=np.int32)
    gal = ShardedGallery(70000, 256, store_dtype=store_dtype, device=cuda)
    gal.add(rows, labels)
    assert gal.kernel_enabled()
    q = rows[[5, 60000, 69999]]
    before = streaming_match_topk.launches
    lab, sims, idx = gal.match(q, k=17)
    torch.cuda.synchronize()
    assert streaming_match_topk.launches == before + 1
    assert lab.shape == sims.shape == idx.shape == (3, 17)
    data = gal._data
    want_v, want_i = streaming_match_topk_plain(
        torch.tensor(q, device=cuda), data.embeddings, data.valid, k=17)
    assert torch.allclose(sims, want_v, atol=SIM_ATOL, rtol=0)
    assert not ((idx != want_i) & ((sims - want_v).abs() > SIM_ATOL)).any()
    assert idx[:, 0].tolist() == [5, 60000, 69999]


def _ivf_gallery(cuda, rows, nlist=64, seed=0, capacity=None):
    gal = ShardedGallery(capacity or len(rows), rows.shape[1], store_dtype=torch.bfloat16,
                         device=cuda)
    gal.add(rows, np.arange(len(rows), dtype=np.int32))
    quantizer = quant.CoarseQuantizer(nlist=nlist, nprobe=8, seed=seed, kmeans_iters=5,
                                      train_sample=16384)
    gal.attach_quantizer(quantizer, mode="ivf")
    assert quantizer.rebuild_now()
    return gal, quantizer


@pytest.mark.gpu
@pytest.mark.parametrize("qn", [512, 32])
def test_ivf_rerank_kernel_matches_plain_rerank(cuda, qn):
    """The two-stage match with kernel A as the rerank against the same
    match with the plain rerank, on one IVFDeviceData."""
    rng = np.random.default_rng(qn)
    rows = _normed(rng, (40000, 256))
    gal, quantizer = _ivf_gallery(cuda, rows)
    pick = rng.choice(40000, qn, replace=False)
    q = torch.tensor(_normed(rng, (qn, 256)) * 0.05 + rows[pick], device=cuda)
    q = q / q.norm(dim=1, keepdim=True)
    valid = gal.data.valid
    for k in (1, 5, 17):
        before = streaming_match_topk.launches
        got_v, got_i = ivf_match_topk(q, valid, quantizer.data, k=k, nprobe=8)
        assert streaming_match_topk.launches == before + 1
        want_v, want_i = ivf_match_topk(q, valid, quantizer.data, k=k, nprobe=8,
                                        rerank=streaming_match_topk_plain)
        torch.cuda.synchronize()
        assert torch.allclose(got_v, want_v, atol=SIM_ATOL, rtol=0)
        assert not ((got_i != want_i) & ((got_v - want_v).abs() > SIM_ATOL)).any()
        assert torch.equal(got_i[:, 0], want_i[:, 0])
    _l, _s, idx = gal.match(q, k=1)
    assert (idx[:, 0].cpu().numpy() == pick).mean() > 0.95


@pytest.mark.gpu
def test_kmeans_and_rebuild_deterministic_on_card(cuda):
    """Two builds of the same rows and seed give bit-identical centroids,
    assignment and lists (no float atomics in the k-means sums)."""
    rng = np.random.default_rng(1)
    rows = _normed(rng, (30000, 256))
    a = quant._kmeans(rows, 256, 5, 3, device=cuda)
    b = quant._kmeans(rows, 256, 5, 3, device=cuda)
    np.testing.assert_array_equal(a, b)
    _g1, q1 = _ivf_gallery(cuda, rows, nlist=128, seed=4)
    _g2, q2 = _ivf_gallery(cuda, rows, nlist=128, seed=4)
    np.testing.assert_array_equal(q1._h_centroids, q2._h_centroids)
    np.testing.assert_array_equal(q1._h_assign, q2._h_assign)
    for x, y in zip(q1.data[:7], q2.data[:7]):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_ivf_insert_while_a_reader_holds_an_older_snapshot(cuda):
    """An enrolment while a reader holds the older (GalleryData,
    IVFDeviceData) pair: the reader's arrays and answers do not change; a
    fresh read finds the new rows through the kernel rerank."""
    rng = np.random.default_rng(2)
    gal, quantizer = _ivf_gallery(cuda, _normed(rng, (20000, 256)), capacity=32768)
    old_data, old_ivf = gal.data, gal._ivf_data(gal.data)
    frozen = [t.clone() for t in old_ivf[:7]]
    probe = torch.tensor(_normed(rng, (16, 256)), device=cuda)
    before = ivf_match_topk(probe, old_data.valid, old_ivf, k=3)
    gal.add(probe.cpu().numpy(), np.arange(16, dtype=np.int32))
    after = ivf_match_topk(probe, old_data.valid, old_ivf, k=3)
    torch.cuda.synchronize()
    assert quantizer.data is not old_ivf
    assert all(torch.equal(x, y) for x, y in zip(old_ivf[:7], frozen))
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    _l, sims, idx = gal.match(probe, k=1)
    assert idx[:, 0].tolist() == list(range(20000, 20016)) and (sims > 0.99).all()


def _sep_inputs(cuda, b, h, w, c, f, stride, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g).to(cuda, dtype)
    args = [torch.randn(c, 1, 3, 3, generator=g) * 0.3, torch.rand(c, generator=g) + 0.5,
            torch.randn(c, generator=g) * 0.1, torch.randn(f, c, 1, 1, generator=g) / c ** 0.5,
            torch.rand(f, generator=g) + 0.5, torch.randn(f, generator=g) * 0.1]
    return x, [a.to(cuda) for a in args], stride == 1 and c == f


def _assert_sep(cuda, b, h, w, c, f, stride, dtype, seed):
    x, args, res = _sep_inputs(cuda, b, h, w, c, f, stride, dtype, seed)
    got = fused_sep_block(x, *args, stride=stride, residual=res)
    want = fused_sep_block_plain(x, *args, stride=stride, residual=res)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    err = (got.float() - want.float()).abs()
    assert (err <= SEP_RTOL * want.float().abs().clamp(min=1.0)).all(), err.max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,c,f,stride", SERVING_BLOCKS)
def test_sepblock_kernel_serving_shapes(cuda, h, w, c, f, stride, dtype):
    """The six serving blocks at B = 37, fewer samples than CTAs."""
    _assert_sep(cuda, 37, h, w, c, f, stride, dtype, c + f + stride)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,c,f,stride", SERVING_BLOCKS)
def test_sepblock_kernel_streams_samples(cuda, h, w, c, f, stride, dtype):
    """B = 601, more than twice the CTAs of a full grid and not a multiple
    of it: every CTA streams two or more samples (through both buffers in
    bf16; in f32 restaging its one buffer and reading the residual of
    samples past its first). A sample's arithmetic does not depend on the
    CTA or the turn that runs it, so each output must equal, bit for bit,
    the one the sample gets as the only sample of its CTA (launches of 100
    samples); in bf16 the output is also held against the plain version."""
    x, args, res = _sep_inputs(cuda, SEP_STREAM_B, h, w, c, f, stride, dtype,
                               c + f + stride)
    got = fused_sep_block(x, *args, stride=stride, residual=res)
    alone = torch.cat([fused_sep_block(x[i:i + 100], *args, stride=stride, residual=res)
                       for i in range(0, SEP_STREAM_B, 100)])
    assert launch_info(x[:100], f, stride)["grid"] == 100
    assert launch_info(x, f, stride)["grid"] * 2 < SEP_STREAM_B
    assert torch.equal(got, alone)
    if dtype == torch.bfloat16:
        want = fused_sep_block_plain(x, *args, stride=stride, residual=res)
        err = (got.float() - want.float()).abs()
        assert (err <= SEP_RTOL * want.float().abs().clamp(min=1.0)).all(), err.max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,c,f,stride", OTHER_BLOCKS)
def test_sepblock_kernel_other_widths(cuda, h, w, c, f, stride, dtype):
    """F = 48 and 96: rows of 6 and 12 eight-channel chunks, which the
    bf16 output staging must swizzle within the row."""
    _assert_sep(cuda, SEP_STREAM_B, h, w, c, f, stride, dtype, c + f + stride)


@pytest.mark.gpu
def test_sepblock_kernel_instantiations(cuda):
    """The library picks the instantiation whose registers hold a block
    (the two 256- and 512-thread ones at the serving shapes) and refuses
    a shape none holds."""
    variants = [launch_info(torch.empty(1, h, w, c, dtype=torch.bfloat16, device=cuda),
                            f, stride)["variant"] for h, w, c, f, stride in SERVING_BLOCKS]
    assert variants == [1, 1, 0, 1, 0, 0]
    with pytest.raises(ValueError, match="cannot take"):
        launch_info(torch.empty(1, 64, 64, 64, dtype=torch.bfloat16, device=cuda), 64, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,c,f,stride", [(32, 32, 64, 2), (16, 64, 64, 1),
                                          (4, 256, 256, 1)])
def test_sepblock_kernel_matches_plain(cuda, h, c, f, stride, dtype):
    _assert_sep(cuda, 64, h, h, c, f, stride, dtype, 0)


@pytest.mark.gpu
def test_wrappers_count_launches(cuda):
    q = torch.randn(8, 16, device=cuda)
    g = torch.randn(64, 16, device=cuda)
    before = streaming_match_topk.launches
    streaming_match_topk(q, g, torch.ones(64, dtype=torch.bool, device=cuda))
    assert streaming_match_topk.launches == before + 1
    before = streaming_match_topk.launches
    streaming_match_topk(q.cpu(), g.cpu(), torch.ones(64, dtype=torch.bool))
    assert streaming_match_topk.launches == before  # the plain version launches nothing


def _write_pgm(path, img):
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode() + img.astype(np.uint8).tobytes())


@pytest.mark.gpu
def test_cli_stack_from_port_checkpoints_launches_both_kernels(cuda, tmp_path, capsys):
    """Checkpoints written by the port's own writers (serving detector and
    embedder, seeded weights), a PGM gallery directory and PGM frames:
    ``apps.recognize.main`` in dir mode on the card with a 2^16-row
    gallery and the fused embedder answers every frame through kernel A
    and kernel B."""
    import json

    from opencv_facerecognizer_tpu_torch.apps import recognize
    from opencv_facerecognizer_tpu_torch.models.classifier import NearestNeighbor
    from opencv_facerecognizer_tpu_torch.models.detector import CNNFaceDetector
    from opencv_facerecognizer_tpu_torch.models.embedder import (
        SERVING_EMBEDDER_KWARGS, SERVING_FACE_SIZE, CNNEmbedding)
    from opencv_facerecognizer_tpu_torch.models.model import PredictableModel
    from opencv_facerecognizer_tpu_torch.ops.distance import CosineDistance
    from opencv_facerecognizer_tpu_torch.utils.serialization import save_model

    rng = np.random.default_rng(3)
    det = CNNFaceDetector(device=cuda, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        det.net.heatmap.bias.fill_(0.0)
        det.net.size.bias.fill_(3.0)
    det.save(str(tmp_path / "det.ckpt"))
    faces = rng.integers(0, 256, (6, *SERVING_FACE_SIZE)).astype(np.float32)
    emb = CNNEmbedding(**SERVING_EMBEDDER_KWARGS, input_size=SERVING_FACE_SIZE,
                       train_steps=0, device=cuda)
    model = PredictableModel(emb, NearestNeighbor(CosineDistance(), device=cuda))
    model.compute(faces, np.arange(6) // 2)
    save_model(str(tmp_path / "model.ckpt"), model)
    for i, face in enumerate(faces):
        (tmp_path / "gallery" / f"s{i // 2}").mkdir(parents=True, exist_ok=True)
        _write_pgm(tmp_path / "gallery" / f"s{i // 2}" / f"{i}.pgm", face)
    (tmp_path / "frames").mkdir()
    for i in range(6):
        _write_pgm(tmp_path / "frames" / f"f{i}.pgm", rng.integers(0, 256, (256, 256)))
    streaming_match_topk.launches = 0
    fused_sep_block.launches = 0
    assert recognize.main([
        "--model", str(tmp_path / "model.ckpt"), "--detector", str(tmp_path / "det.ckpt"),
        "--gallery", str(tmp_path / "gallery"), "--source", "dir", "--dir",
        str(tmp_path / "frames"), "--capacity", "65536", "--match-mode", "exact",
        "--fused-embedder", "--batch-size", "8"]) == 0
    results = [json.loads(l) for l in capsys.readouterr().out.splitlines()
               if l.startswith("{")]
    assert sorted(r["meta"]["file"] for r in results) == [f"f{i}.pgm" for i in range(6)]
    assert sum(len(r["faces"]) for r in results) > 0
    assert streaming_match_topk.launches > 0 and fused_sep_block.launches > 0


@pytest.mark.gpu
def test_state_restore_of_a_2p17_gallery_matches_through_kernel_a(cuda, tmp_path):
    """A 2^17-row bf16 gallery checkpointed, one enrolment in the WAL (it
    grows the gallery to 2^18 rows), recovered into a fresh gallery on the
    card: the host mirrors are equal and kernel A gives both galleries the
    same indices and sims, bit for bit."""
    from opencv_facerecognizer_tpu_torch.runtime.state_store import StateLifecycle

    rng = np.random.default_rng(11)
    n = 1 << 17
    rows = _normed(rng, (n, 256))
    g = ShardedGallery(n, 256, store_dtype=torch.bfloat16, device=cuda)
    g.add(rows, np.arange(n, dtype=np.int32))
    st = StateLifecycle(str(tmp_path))
    st.bind(g, ["rows"])
    assert st.checkpoint_now(wait=True)
    extra = _normed(rng, (3, 256))
    labels = np.full(3, n, np.int32)
    st.append_enrollment(extra, labels, subject="late", label=1,
                         apply_fn=lambda: g.add(extra, labels))
    st.close()
    g2, names = ShardedGallery(8, 256, store_dtype=torch.bfloat16, device=cuda), []
    rep = StateLifecycle(str(tmp_path)).recover(g2, names)
    assert rep["replayed_records"] == 1 and names == ["rows", "late"]
    assert g2.capacity == g.capacity == 2 * n and g2.size == g.size
    for a, b in zip(g.snapshot(), g2.snapshot()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    q = torch.tensor(_normed(rng, (512, 256)), device=cuda)
    q[:3] = torch.tensor(extra, device=cuda)
    before = streaming_match_topk.launches
    for k in (1, 5):
        la, sa, ia = g.match(q, k=k)
        lb, sb, ib = g2.match(q, k=k)
        assert torch.equal(ia, ib) and torch.equal(sa, sb) and torch.equal(la, lb)
    assert streaming_match_topk.launches == before + 4
    assert (ia[:3, 0].cpu().numpy() >= n).all()


# ---- the NMS kernel and the graphed serving step ----

def _nms_case(rng, n_img, k, grid=0.5):
    """Boxes on a coarse grid (IoUs that land exactly on simple fractions,
    so on the 0.5 threshold too) and scores rounded to 0.1 (many ties)."""
    y0 = rng.integers(0, 40, (n_img, k)) * grid
    x0 = rng.integers(0, 40, (n_img, k)) * grid
    h = rng.integers(1, 12, (n_img, k)) * grid
    w = rng.integers(1, 12, (n_img, k)) * grid
    boxes = np.stack([y0, x0, y0 + h, x0 + w], -1).astype(np.float32)
    scores = np.round(rng.random((n_img, k)), 1).astype(np.float32)
    return boxes, scores


@pytest.mark.gpu
@pytest.mark.parametrize("k", [64, 256])
@pytest.mark.parametrize("iou_threshold, score_threshold", [(0.5, 0.3), (0.4, 0.0)])
def test_nms_kernel_matches_plain(cuda, k, iou_threshold, score_threshold):
    """4096 random images: the kernel's keep-mask equals the plain loop's,
    flag for flag (the same f32 IoU arithmetic, ties in the same order)."""
    from opencv_facerecognizer_tpu_torch.ops.nms import nms_mask, nms_mask_plain

    boxes, scores = _nms_case(np.random.default_rng(k), 4096, k)
    b, s = torch.tensor(boxes, device=cuda), torch.tensor(scores, device=cuda)
    before = nms_mask.launches
    got = nms_mask(b, s, iou_threshold, score_threshold)
    assert nms_mask.launches == before + 1
    want = nms_mask_plain(b, s, iou_threshold, score_threshold)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), nms_mask_plain(b.cpu(), s.cpu(), iou_threshold,
                                                 score_threshold))
    assert 0 < got.float().mean().item() < 1


@pytest.mark.gpu
def test_nms_kernel_refuses_what_it_cannot_take(cuda):
    from opencv_facerecognizer_tpu_torch.ops.nms import nms_mask

    with pytest.raises(ValueError, match="1024"):
        nms_mask(torch.zeros(2, 1025, 4, device=cuda), torch.zeros(2, 1025, device=cuda))
    with pytest.raises(ValueError, match="f32"):
        nms_mask(torch.zeros(2, 8, 4, device=cuda, dtype=torch.float64),
                 torch.zeros(2, 8, device=cuda, dtype=torch.float64))


def _serving_pipeline(cuda, rows=1 << 17, cuda_graphs=True, fused=True, gallery=None,
                      seed=7, cascade=None):
    """The serving detector and embedder (seeded; a detector that fires on
    noise) over a bf16 gallery at kernel A's capacity."""
    from opencv_facerecognizer_tpu_torch.models.detector import CNNFaceDetector
    from opencv_facerecognizer_tpu_torch.models.embedder import (
        SERVING_EMBEDDER_KWARGS, SERVING_FACE_SIZE, FaceEmbedNet)
    from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline

    det = CNNFaceDetector(device=cuda, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        det.net.heatmap.bias.fill_(0.0)
        det.net.size.bias.fill_(3.0)
    net = FaceEmbedNet(**SERVING_EMBEDDER_KWARGS, input_size=SERVING_FACE_SIZE,
                       generator=torch.Generator().manual_seed(seed + 1)).to(cuda)
    if gallery is None:
        gallery = ShardedGallery(rows, 256, store_dtype=torch.bfloat16, device=cuda)
        rng = np.random.default_rng(seed)
        filled = rows - 1024  # room for a batch's faces (up to 8 x 16)
        gallery.add(_normed(rng, (filled, 256)), np.arange(filled, dtype=np.int32))
    return RecognitionPipeline(det, net, gallery, fused_embedder=fused, device=cuda,
                               cuda_graphs=cuda_graphs, cascade=cascade)


def _frames(seed, n=8):
    return np.random.default_rng(seed).integers(0, 256, (n, 256, 256), dtype=np.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
def test_graphed_step_equals_eager(cuda, fused):
    """The captured packed step gives the eager step's bytes, replay after
    replay, for other frames each time."""
    graphed = _serving_pipeline(cuda, fused=fused)
    eager = _serving_pipeline(cuda, fused=fused, cuda_graphs=False, gallery=graphed.gallery)
    for i in range(3):
        frames = _frames(i)
        want = eager.recognize_batch_packed(frames).clone()
        got = graphed.recognize_batch_packed(frames).clone()
        assert torch.equal(got, want), (got - want).abs().max()
    assert graphed.captures == 1 and graphed.last_dispatch_info["cache_hit"]
    assert (want[..., 5] > 0.5).any()
    res = graphed.recognize_batch(_frames(0))
    assert res.boxes.data_ptr() != graphed.recognize_batch_packed(_frames(1)).data_ptr()


@pytest.mark.gpu
def test_detector_swap_after_capture_reaches_the_next_replay(cuda):
    pipe = _serving_pipeline(cuda)
    frames = _frames(3)
    assert (pipe.recognize_batch_packed(frames)[..., 5] > 0.5).any()
    params = {k: v.clone() for k, v in pipe.detector.params.items()}
    params["heatmap.bias"].fill_(-20.0)  # no face survives the 0.3 threshold
    pipe.install_detector_params(params)
    assert not (pipe.recognize_batch_packed(frames)[..., 5] > 0.5).any()
    assert pipe.captures == 1  # the same graph, new weights
    params["heatmap.bias"].fill_(0.0)
    params["head.weight"].mul_(0.5)  # a bf16 conv: its cached cast must follow
    pipe.install_detector_params(params)
    eager = _serving_pipeline(cuda, cuda_graphs=False, gallery=pipe.gallery)
    eager.install_detector_params(params)
    assert torch.equal(pipe.recognize_batch_packed(frames),
                       eager.recognize_batch_packed(frames))


@pytest.mark.gpu
def test_in_place_append_reaches_the_next_replay(cuda):
    """Rows added within the tier land in the live tensor (same address, no
    new capture) and the next replay matches them; a snapshot taken before
    the add still has its own valid, labels and size."""
    pipe = _serving_pipeline(cuda)
    g = pipe.gallery
    frames = _frames(4)
    first = pipe.recognize_batch_packed(frames).clone()
    old = g.data
    old_valid, old_labels = old.valid.clone(), old.labels.clone()
    _b, _s, valid, emb = pipe.embed_frames(frames)
    faces = emb[valid.reshape(-1)].float().cpu().numpy()
    assert len(faces) > 0
    g.add(faces, np.arange(len(faces), dtype=np.int32) + 10_000_000)
    assert g.data.embeddings.data_ptr() == old.embeddings.data_ptr()
    again = pipe.recognize_batch_packed(frames)
    assert pipe.captures == 1
    found = again[..., 6][again[..., 5] > 0.5]
    assert (found >= 10_000_000).all() and not torch.equal(again, first)
    assert old.size == g.size - len(faces)
    assert torch.equal(old.valid, old_valid) and torch.equal(old.labels, old_labels)


@pytest.mark.gpu
def test_capture_on_a_worker_while_the_main_thread_replays(cuda):
    """A worker captures another batch size while the main thread replays:
    nothing raises and every replay gives the bytes it gave before."""
    import threading

    pipe = _serving_pipeline(cuda)
    frames = _frames(5)
    want = pipe.recognize_batch_packed(frames).clone()
    errors = []

    def capture():
        try:
            pipe.prewarm_batch_shapes([2, 4], (256, 256), np.uint8)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    worker = threading.Thread(target=capture)
    worker.start()
    replays = 0
    while worker.is_alive() or replays < 20:
        assert torch.equal(pipe.recognize_batch_packed(frames), want)
        replays += 1
    worker.join(timeout=120)
    assert not worker.is_alive() and not errors, errors
    assert pipe.captures == 3
    assert torch.equal(pipe.recognize_batch_packed(frames[:4]),
                       _serving_pipeline(cuda, cuda_graphs=False, gallery=pipe.gallery)
                       .recognize_batch_packed(frames[:4]))


@pytest.mark.gpu
def test_replays_add_the_captured_launches(cuda):
    from opencv_facerecognizer_tpu_torch.ops.nms import nms_mask

    pipe = _serving_pipeline(cuda)
    frames = _frames(6)
    pipe.recognize_batch_packed(frames)  # captures
    step = next(iter(pipe._step_cache.values()))
    assert dict(step.deltas) == {(fused_sep_block, "launches"): 6,
                                 (streaming_match_topk, "launches"): 1,
                                 (nms_mask, "launches"): 1}
    before = (fused_sep_block.launches, streaming_match_topk.launches, nms_mask.launches)
    for _ in range(5):
        pipe.recognize_batch_packed(frames)
    after = (fused_sep_block.launches, streaming_match_topk.launches, nms_mask.launches)
    assert [a - b for a, b in zip(after, before)] == [30, 5, 5]


@pytest.mark.gpu
def test_traced_service_replays_equal_the_untraced_step(cuda):
    """A service with every span on (sample 1.0, a span sink) serves the
    same packed bytes as the untraced graphed step on the same weights,
    from the graphs captured at warmup: tracing adds host timestamps only."""
    import tempfile

    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector, encode_frame
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import FRAME_TOPIC, RecognizerService
    from opencv_facerecognizer_tpu_torch.utils.tracing import Tracer, account_spans, \
        make_span_journal

    traced_pipe = _serving_pipeline(cuda)
    plain = _serving_pipeline(cuda, gallery=traced_pipe.gallery)
    with tempfile.TemporaryDirectory() as tmp:
        sink = make_span_journal(f"{tmp}/spans.jsonl")
        tracer = Tracer(sample=1.0, span_sink=sink)
        conn = FakeConnector()
        service = RecognizerService(traced_pipe, conn, batch_size=8, frame_shape=(256, 256),
                                    transfer_dtype=np.uint8, flush_timeout=0.01,
                                    bucket_sizes=(8,), tracer=tracer, readback_worker=False)
        got = []
        real_publish = service._publish

        def publish(packed, *args, **kwargs):
            got.append(np.array(packed, copy=True))
            return real_publish(packed, *args, **kwargs)

        service._publish = publish
        service.warmup()
        captures = traced_pipe.captures
        service._running = True
        for i in range(3):
            for j, frame in enumerate(_frames(i)):
                conn.inject(FRAME_TOPIC, {**encode_frame(frame), "meta": {"i": i, "j": j}})
            batch = service.batcher.get_batch(block=True)
            service._serve_one(batch)
            service._drain(force=True)
        service._running = False
        sink.close()
    assert traced_pipe.captures == captures  # replays of the warmup's graph
    for i in range(3):
        want = plain.recognize_batch_packed(_frames(i)).cpu().numpy()
        assert np.array_equal(got[i], want), i
    assert account_spans(tracer.snapshot())["completed"] == 24


def _ingest_service(pipe, batch=8, mode="uint8", worker=True, flush_timeout=0.01):
    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector
    from opencv_facerecognizer_tpu_torch.runtime.ingest import IngestConfig
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import RecognizerService

    conn = FakeConnector()
    service = RecognizerService(pipe, conn, batch_size=batch, frame_shape=(256, 256),
                                flush_timeout=flush_timeout, bucket_sizes=(batch,),
                                ingest=IngestConfig(mode), readback_worker=worker)
    got = {}
    real_publish = service._publish

    def publish(packed, frames, metas, *args, **kwargs):
        got[metas[0]["i"]] = np.array(packed, copy=True)
        return real_publish(packed, frames, metas, *args, **kwargs)

    service._publish = publish
    return service, conn, got


@pytest.mark.gpu
def test_pinned_ring_service_equals_the_pageable_step(cuda):
    """Batches of distinct frames served back to back through the pinned
    staging ring and the side-stream upload give the plain graphed step's
    bytes on the same frames (from pageable memory), batch for batch: a
    buffer or graph slot overwritten too early would show. The steady
    run allocates nothing and captures nothing after warmup.

    Each batch is encoded before any frame of it is offered, and the
    flush waits 1 s (ROADMAP C.27): with a 10 ms flush a slow offer split
    a batch, its padded part uploaded as the bucket's bytes (the ring
    counts what crosses the link, padding too: 72 frames' bytes for 64)."""
    from opencv_facerecognizer_tpu_torch.runtime.connector import encode_frame
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import FRAME_TOPIC
    from opencv_facerecognizer_tpu_torch.utils import metrics as mn

    pipe = _serving_pipeline(cuda)
    plain = _serving_pipeline(cuda, gallery=pipe.gallery)
    service, conn, got = _ingest_service(pipe, flush_timeout=1.0)
    assert service.ingest.staging.pinned
    service.start(warmup=True)
    captures = pipe.captures
    try:
        for i in range(8):
            batch = [{**encode_frame(frame), "meta": {"i": i, "j": j}}
                     for j, frame in enumerate(_frames(100 + i))]
            for message in batch:
                conn.inject(FRAME_TOPIC, message)
        assert service.drain(timeout=120.0)
    finally:
        service.stop()
    c = service.metrics.counters()
    assert pipe.captures == captures and c.get(mn.RECOMPILES_POST_WARMUP, 0) == 0
    assert c[mn.INGEST_STAGING_ALLOCS] == service.ingest.staging.preallocated
    assert c[mn.INGEST_UPLOAD_BYTES] == 8 * 8 * 256 * 256
    assert sorted(got) == list(range(8))
    for i in range(8):
        want = plain.recognize_batch_packed(_frames(100 + i)).cpu().numpy()
        assert np.array_equal(got[i], want), i


@pytest.mark.gpu
def test_upload_refuses_pageable_memory(cuda):
    from opencv_facerecognizer_tpu_torch.runtime.ingest import IngestConfig, IngestPipeline

    ingest = IngestPipeline(IngestConfig("uint8"), [8], (16, 16), device=cuda)
    buf = ingest.staging.acquire(8)
    buf[:] = 3
    out, nbytes, _dur = ingest.upload(buf)
    assert out.is_cuda and nbytes == 8 * 16 * 16
    assert torch.equal(out.cpu(), torch.full((8, 16, 16), 3, dtype=torch.uint8))
    with pytest.raises(RuntimeError, match="pageable"):
        ingest.upload(np.zeros((8, 16, 16), np.uint8))


@pytest.mark.gpu
def test_cutover_under_replays(cuda):
    """A batch dispatched before a cutover and read back after it answers
    from the old rows (its in-flight entry holds the snapshot) stamped 1;
    the next batch re-captures once, answers from the new rows like an
    eager step over them, stamped 2."""
    from opencv_facerecognizer_tpu_torch.runtime.connector import encode_frame
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import FRAME_TOPIC

    pipe = _serving_pipeline(cuda)
    eager = _serving_pipeline(cuda, cuda_graphs=False, gallery=pipe.gallery)
    service, conn, got = _ingest_service(pipe, worker=False)
    service.warmup()
    service._running = True
    want_old = eager.recognize_batch_packed(_frames(0)).cpu().numpy()
    for j, frame in enumerate(_frames(0)):
        conn.inject(FRAME_TOPIC, {**encode_frame(frame), "meta": {"i": 0, "j": j}})
    service._serve_one(service.batcher.get_batch(block=True))
    emb, lab, val, size = pipe.gallery.snapshot()
    pipe.gallery.load_snapshot(-emb, lab, val, size, embedder_version=2)
    recaptures = pipe.recaptures
    service._drain(force=True)
    for j, frame in enumerate(_frames(1)):
        conn.inject(FRAME_TOPIC, {**encode_frame(frame), "meta": {"i": 1, "j": j}})
    service._serve_one(service.batcher.get_batch(block=True))
    service._drain(force=True)
    service._running = False
    want_new = eager.recognize_batch_packed(_frames(1)).cpu().numpy()
    assert np.array_equal(got[0], want_old) and np.array_equal(got[1], want_new)
    assert pipe.recaptures == recaptures + 1
    stamps = [m["embedder_version"] for m in conn.messages("ocvfacerec/results")]
    assert stamps == [1] * 8 + [2] * 8


def _gate(cuda, seed=13, features=(8, 16)):
    from opencv_facerecognizer_tpu_torch.models.cascade import FaceGate

    return FaceGate(features=features, device=cuda,
                    generator=torch.Generator().manual_seed(seed))


@pytest.mark.gpu
def test_stage1_graph_equals_eager_and_installs_in_place(cuda):
    """The captured stage-1 pass gives the eager pass's bytes per rung and
    dtype; a same-architecture install reaches the next replay with no new
    capture, another architecture captures again."""
    pipe = _serving_pipeline(cuda, cascade=_gate(cuda))
    eager = _serving_pipeline(cuda, cuda_graphs=False, gallery=pipe.gallery,
                              cascade=pipe.cascade)
    for n, dtype in ((8, np.uint8), (8, np.float32), (32, np.uint8)):
        frames = _frames(n, n=n).astype(dtype)
        got = pipe.cascade_scores(frames).clone()
        assert torch.equal(got, eager.cascade_scores(frames)), n
    assert pipe.cascade_captures == 3
    other = _gate(cuda, seed=14)
    pipe.install_cascade(other, version=2)
    eager.install_cascade(other)
    frames = _frames(3)
    assert torch.equal(pipe.cascade_scores(frames), eager.cascade_scores(frames))
    assert pipe.cascade_captures == 3 and pipe.last_cascade_info["version"] == 2
    pipe.install_cascade(_gate(cuda, features=(8, 8)))
    pipe.cascade_scores(frames)
    assert pipe.cascade_captures == 4


@pytest.mark.gpu
def test_detector_install_under_replays_never_mixes(cuda):
    """Steps queued back to back on the serving thread while another thread
    installs new detector weights: every step's output equals the all-old
    or the all-new eager step, and the version it recorded says which."""
    import threading

    pipe = _serving_pipeline(cuda)
    frames = _frames(5)
    old = {k: v.clone() for k, v in pipe.detector.params.items()}
    new = {k: v * 1.01 for k, v in old.items()}
    eager = _serving_pipeline(cuda, cuda_graphs=False, gallery=pipe.gallery)
    want = {}
    for version, params in ((1, old), (2, new)):
        eager.install_detector_params(params)
        want[version] = eager.recognize_batch_packed(frames).clone()
    assert not torch.equal(want[1], want[2])
    pipe.install_detector_params(old, version=1)
    pipe.recognize_batch_packed(frames)
    outs = []
    installer = threading.Thread(target=lambda: pipe.install_detector_params(new, version=2))
    for i in range(40):
        if i == 5:
            installer.start()
        out = pipe.recognize_batch_packed(frames)
        outs.append((pipe.last_model_versions["detector"], out.clone()))
    installer.join(timeout=60)
    torch.cuda.synchronize()
    assert {v for v, _o in outs} <= {1, 2}
    for version, out in outs:
        assert torch.equal(out, want[version]), version


@pytest.mark.gpu
def test_scalar_chain_ms_times_a_chain_on_the_card(cuda):
    """``utils.benchtime.scalar_chain_ms`` on a 1024^2 matmul-sum:
    resolved, positive and below 50 ms a call."""
    from opencv_facerecognizer_tpu_torch.utils.benchtime import scalar_chain_ms

    a = torch.randn(1024, 1024, device=cuda)
    x = torch.randn(1024, 1024, device=cuda)
    ms = scalar_chain_ms(lambda a, x: (a @ x).sum(), (a, x),
                         k2_ladder=(34, 154), pairs=2)
    assert ms is not None and 0.0 < ms < 50.0


def _mesh_pipeline(cuda, dp, tp, cuda_graphs=True, gallery=None, seed=7):
    """The unfused serving stack over a (dp, tp) mesh of slots of the card
    (each slot its own stream), 2^17 bf16 rows: 2^16 a shard at tp 2, so
    kernel A serves each shard."""
    from opencv_facerecognizer_tpu_torch.parallel.mesh import make_mesh

    if gallery is None:
        gallery = ShardedGallery(1 << 17, 256, store_dtype=torch.bfloat16,
                                 mesh=make_mesh(dp=dp, tp=tp, devices=[cuda] * (dp * tp)))
        rng = np.random.default_rng(seed)
        filled = (1 << 17) - 1024
        gallery.add(_normed(rng, (filled, 256)), np.arange(filled, dtype=np.int32))
    return _serving_pipeline(cuda, fused=False, cuda_graphs=cuda_graphs, gallery=gallery,
                             seed=seed)


@pytest.mark.gpu
@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_mesh_graph_equals_eager_and_the_single_device_step(cuda, dp, tp):
    """On slots of one card the mesh step's level graphs give the eager
    mesh step's bytes and the single-device graphed step's on each dp
    row's frames; a replay launches kernel A dp x tp times and C dp times."""
    from opencv_facerecognizer_tpu_torch.ops.nms import nms_mask

    graphed = _mesh_pipeline(cuda, dp, tp)
    assert graphed.gallery.kernel_enabled()
    eager = _mesh_pipeline(cuda, dp, tp, cuda_graphs=False, gallery=graphed.gallery)
    g = graphed.gallery
    single_gallery = ShardedGallery(g.capacity, 256, store_dtype=torch.bfloat16, device=cuda)
    single_gallery.load_snapshot(*g.snapshot())
    single = _serving_pipeline(cuda, fused=False, gallery=single_gallery)
    for i in range(3):
        frames = _frames(10 + i)
        got = graphed.recognize_batch_packed(frames).clone()
        assert torch.equal(got, eager.recognize_batch_packed(frames))
        per = len(frames) // dp
        by_row = torch.cat([single.recognize_batch_packed(frames[r * per:(r + 1) * per]).clone()
                            for r in range(dp)])
        assert torch.equal(got, by_row)
    assert graphed.captures == 1 and (got[..., 5] > 0.5).any()
    assert not graphed.recognize_batch_packed(frames).requires_grad
    step = next(iter(graphed._step_cache.values()))
    assert dict(step.deltas) == {(streaming_match_topk, "launches"): dp * tp,
                                 (nms_mask, "launches"): dp}
    before = (streaming_match_topk.launches, nms_mask.launches, fused_sep_block.launches)
    graphed.recognize_batch_packed(_frames(10))
    after = (streaming_match_topk.launches, nms_mask.launches, fused_sep_block.launches)
    assert [a - b for a, b in zip(after, before)] == [dp * tp, dp, 0]


@pytest.mark.gpu
def test_mesh_level_graphs_follow_an_in_place_append(cuda):
    """A (2, 2) mesh step on slots of one card is captured level by level
    (``_LevelStep``, a graph per card and level, hops between replays): it
    gives the eager mesh step's bytes before and after an in-place append,
    which keeps its binding, so it is not captured again."""
    from opencv_facerecognizer_tpu_torch.parallel.pipeline import _LevelStep

    pipe = _mesh_pipeline(cuda, 2, 2)
    eager = _mesh_pipeline(cuda, 2, 2, cuda_graphs=False, gallery=pipe.gallery)
    frames = _frames(20)
    got = pipe.recognize_batch_packed(frames).clone()
    assert torch.equal(got, eager.recognize_batch_packed(frames))
    step = next(iter(pipe._step_cache.values()))
    assert isinstance(step, _LevelStep) and len(step.levels) == 4
    binding = step.binding
    _b, _s, valid, emb = pipe.embed_frames(frames)
    faces = emb[valid.reshape(-1)].float().cpu().numpy()
    pipe.gallery.add(faces, np.arange(len(faces), dtype=np.int32) + 10_000_000)
    assert pipe._binding(pipe.gallery.data, None) == binding
    got = pipe.recognize_batch_packed(frames).clone()
    assert pipe.captures == 1 and pipe.recaptures == 0
    assert torch.equal(got, eager.recognize_batch_packed(frames))
    assert (got[..., 6][got[..., 5] > 0.5] >= 10_000_000).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 2)])
def test_a_capture_after_every_step_is_dropped_takes_fresh_pools(cuda, dp, tp):
    """Once every cached step is gone (``evict_below`` past every tier, or
    a cleared cache) the next capture takes fresh graph pools, where
    capturing into the freed pool trips the caching allocator; the steps
    captured again give the first capture's bytes."""
    import gc

    pipe = (_serving_pipeline(cuda, fused=False) if dp * tp == 1
            else _mesh_pipeline(cuda, dp, tp))
    frames = _frames(40)
    want = pipe.recognize_batch_packed(frames).clone()
    pool = pipe._pool
    pipe.evict_below(pipe.gallery.capacity + 1)
    assert not pipe._step_cache
    gc.collect()
    assert torch.equal(pipe.recognize_batch_packed(frames), want)
    assert pipe.captures == 2 and pipe._pool != pool
    pool = pipe._pool
    pipe.recognize_batch_packed(_frames(41, n=4))  # another key: the pool is in use
    assert pipe.captures == 3 and pipe._pool == pool
    pipe._step_cache.clear()
    gc.collect()
    assert torch.equal(pipe.recognize_batch_packed(frames), want)
    assert pipe.captures == 4 and pipe._pool != pool


@pytest.mark.gpu
def test_mesh_install_under_replays_never_mixes(cuda):
    """A (2, 2) mesh step queued back to back while another thread installs
    new detector weights into every dp row's copy: each output equals the
    all-old or the all-new eager mesh step, as its recorded version says."""
    import threading

    pipe = _mesh_pipeline(cuda, 2, 2)
    frames = _frames(5)
    old = {k: v.clone() for k, v in pipe.detector.params.items()}
    new = {k: v * 1.01 for k, v in old.items()}
    eager = _mesh_pipeline(cuda, 2, 2, cuda_graphs=False, gallery=pipe.gallery)
    want = {}
    for version, params in ((1, old), (2, new)):
        eager.install_detector_params(params)
        want[version] = eager.recognize_batch_packed(frames).clone()
    assert not torch.equal(want[1], want[2])
    pipe.install_detector_params(old, version=1)
    pipe.recognize_batch_packed(frames)
    outs = []
    installer = threading.Thread(target=lambda: pipe.install_detector_params(new, version=2))
    for i in range(30):
        if i == 5:
            installer.start()
        out = pipe.recognize_batch_packed(frames)
        outs.append((pipe.last_model_versions["detector"], out.clone()))
    installer.join(timeout=60)
    torch.cuda.synchronize()
    assert {v for v, _o in outs} == {1, 2}
    for version, out in outs:
        assert torch.equal(out, want[version]), version


@pytest.mark.gpu
def test_mesh_over_every_card(cuda):
    """With two cards or more, ``make_mesh()`` over all of them (the CLI's
    ``--parallel fused``, dp 1, tp n) and a (2, n / 2) mesh: the level
    graphs equal the eager mesh step and the single-device step per dp row."""
    from opencv_facerecognizer_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")
    rng = np.random.default_rng(3)
    rows = _normed(rng, ((1 << 17) * n - 1024, 256))
    single_gallery = ShardedGallery((1 << 17) * n, 256, store_dtype=torch.bfloat16,
                                    device=cuda)
    single_gallery.add(rows, np.arange(len(rows), dtype=np.int32))
    single = _serving_pipeline(cuda, fused=False, gallery=single_gallery)
    for dp in sorted({1, 2 if n % 2 == 0 else 1}):
        mesh = make_mesh(dp=dp, devices=[torch.device("cuda", i) for i in range(n)])
        gal = ShardedGallery((1 << 17) * n, 256, store_dtype=torch.bfloat16, mesh=mesh)
        gal.add(rows, np.arange(len(rows), dtype=np.int32))
        graphed = _mesh_pipeline(cuda, dp, n // dp, gallery=gal)
        eager = _mesh_pipeline(cuda, dp, n // dp, cuda_graphs=False, gallery=gal)
        for i in range(2):
            frames = _frames(30 + i)
            got = graphed.recognize_batch_packed(frames).clone()
            torch.cuda.synchronize()
            assert not graphed.recognize_batch_packed(frames).requires_grad  # ROADMAP C.26
            assert torch.equal(got, eager.recognize_batch_packed(frames)), dp
            per = len(frames) // dp
            by_row = torch.cat([single.recognize_batch_packed(
                frames[r * per:(r + 1) * per]).clone() for r in range(dp)])
            assert torch.equal(got, by_row), dp
        assert graphed.captures == 1


@pytest.mark.gpu
def test_service_over_every_card_reads_every_result_back(cuda):
    """With two cards or more (ROADMAP C.26): a ``RecognizerService`` over
    the fused step on ``make_mesh()`` over every card (dp 1, tp n: the
    CLI's ``--parallel fused``), its rungs captured level by level at
    warmup, answers every frame through a host readback, as phase 15 (d)
    does on slots of one card: no batch is dead-lettered, and the first
    batch's faces, planted in the gallery, are named with their rows."""
    from opencv_facerecognizer_tpu_torch.parallel.mesh import make_mesh
    from opencv_facerecognizer_tpu_torch.parallel.pipeline import _LevelStep
    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector, encode_frame
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
        FRAME_TOPIC, RESULT_TOPIC, RecognizerService)
    from opencv_facerecognizer_tpu_torch.utils import metrics as mn

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")
    rng = np.random.default_rng(4)
    mesh = make_mesh(dp=1, devices=[torch.device("cuda", i) for i in range(n)])
    gallery = ShardedGallery((1 << 17) * n, 256, store_dtype=torch.bfloat16, mesh=mesh)
    filled = (1 << 17) * n - 1024
    gallery.add(_normed(rng, (filled, 256)), np.arange(filled, dtype=np.int32))
    pipe = _mesh_pipeline(cuda, 1, n, gallery=gallery)
    frames = np.concatenate([_frames(50 + i) for i in range(4)])
    _b, _s, valid, emb = pipe.embed_frames(frames[:8])
    planted = emb[valid.reshape(-1)].float().cpu().numpy()
    assert len(planted) > 0
    gallery.add(planted, np.arange(len(planted), dtype=np.int32) + 10_000_000)
    conn = FakeConnector()
    service = RecognizerService(pipe, conn, batch_size=8, frame_shape=(256, 256),
                                transfer_dtype=np.uint8, flush_timeout=0.05,
                                bucket_sizes=(1, 8))
    service.start(warmup=True)
    try:
        for i, frame in enumerate(frames):
            conn.inject(FRAME_TOPIC, {**encode_frame(frame), "meta": {"i": i}})
        assert service.drain(timeout=120.0)
    finally:
        service.stop()
    assert isinstance(next(iter(pipe._step_cache.values())), _LevelStep)
    results = conn.messages(RESULT_TOPIC)
    assert sorted(r["meta"]["i"] for r in results) == list(range(len(frames)))
    c = service.metrics.counters()
    assert sum(c.get(k, 0) for k in mn.LEDGER_COMPLETION_COUNTERS) == len(frames)
    assert sum(c.get(k, 0) for k in mn.LEDGER_DROP_COUNTERS) == 0
    assert c.get(mn.READBACK_ERRORS, 0) == 0
    first = [f for r in results if r["meta"]["i"] < 8 for f in r["faces"]]
    assert first and all(f["label"] >= 10_000_000 for f in first), first
    assert min(f["similarity"] for f in first) >= 0.99
