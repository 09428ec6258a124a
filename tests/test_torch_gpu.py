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
