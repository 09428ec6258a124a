"""Detector of the PyTorch port against the JAX package, on the same flax
params carried over by ``utils.params``: ``DetectorNet`` maps,
``decode_detections`` boxes/scores/valid, ``CNNFaceDetector``, and the
static-shape NMS on crafted ties.

Tolerances: in f32 both sides do the same arithmetic in another order
(``F32_ATOL`` on logits). In bf16 the port matches flax run eagerly to
bf16 rounding (``BF16_ATOL``): each op rounds its output at the same
points. (Under ``jax.jit`` XLA fuses bf16 ops and moves rounding points,
so whole-pipeline parity is held in f32, in test_torch_pipeline.py.)
Decoded boxes are pixel coordinates, 8x the logit scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.models import detector as jax_detector
from opencv_facerecognizer_tpu.ops import nms as jax_nms
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.models._layers import same_padding
from opencv_facerecognizer_tpu_torch.ops import nms as port_nms
from opencv_facerecognizer_tpu_torch.utils.params import detector_params_from_flax

F32_ATOL = 1e-5
BF16_ATOL = 1e-3
CONFIGS = [dict(features=(16, 16), head_features=16, space_to_depth=4),  # serving shape
           dict(features=(8, 8, 8), head_features=8, space_to_depth=1)]  # 1-channel stem


def _pair(cfg, dtype, seed=0, heat_bias=0.0):
    """(flax net, params, port net) on the same params; the heatmap bias is
    raised from -4 so the untrained net yields detections to compare."""
    jnet = jax_detector.DetectorNet(**cfg, dtype=getattr(jnp, dtype))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    heat = f"Conv_{2 * len(cfg['features']) + 1}"
    params[heat]["bias"] = np.full_like(params[heat]["bias"], heat_bias)
    pnet = port_detector.DetectorNet(**cfg, dtype=getattr(torch, dtype))
    detector_params_from_flax(params, pnet)
    return jnet, params, pnet


def _frames(seed=1, shape=(2, 32, 32)):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
def test_detector_net_matches_flax(cfg, dtype, atol):
    jnet, params, pnet = _pair(cfg, dtype)
    x = _frames()
    # f32 under jit (same arithmetic, fast); bf16 eagerly, where each op
    # rounds its output as the port's eager ops do
    apply = jax.jit(jnet.apply) if dtype == "float32" else jnet.apply
    want = apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = pnet(torch.tensor(x))
    for key in ("heatmap", "size", "offset"):
        assert got[key].dtype == torch.float32  # the heads run in f32
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_decode_matches_reference(cfg):
    jnet, params, pnet = _pair(cfg, "float32")
    x = _frames(seed=2)
    want = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))
    wb, ws, wv = (np.asarray(a) for a in jax.jit(
        jax_detector.decode_detections, static_argnums=1)(want, 6))
    with torch.no_grad():
        gb, gs, gv = (a.numpy() for a in port_detector.decode_detections(
            pnet(torch.tensor(x)), max_faces=6))
    assert wv.any(), "no detections to compare"
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gb, wb, atol=8 * F32_ATOL * 10)
    np.testing.assert_allclose(gs[gv], ws[wv], atol=F32_ATOL)
    assert np.isneginf(gs[~gv]).all() and (gb[~gv] == 0).all()


def test_decode_ties_on_flat_heatmap():
    """A constant heatmap makes every cell a peak at the same score: the
    candidates must come in index order, as lax.top_k orders them."""
    n, hs, ws = 1, 4, 4
    outs = {"heatmap": np.zeros((n, hs, ws), np.float32),
            "size": np.full((n, hs, ws, 2), 0.5, np.float32),
            "offset": np.zeros((n, hs, ws, 2), np.float32)}
    wb, ws_, wv = (np.asarray(a) for a in jax_detector.decode_detections(
        {k: jnp.asarray(v) for k, v in outs.items()}, max_faces=5))
    gb, gs, gv = (a.numpy() for a in port_detector.decode_detections(
        {k: torch.tensor(v) for k, v in outs.items()}, max_faces=5))
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_array_equal(gs, ws_)


def test_cnn_face_detector_matches_reference():
    cfg = dict(features=(16, 16), head_features=16, space_to_depth=4)
    _jnet, params, _ = _pair(cfg, "float32")
    jdet = jax_detector.CNNFaceDetector(**cfg, max_faces=4)
    jdet.net = jax_detector.DetectorNet(**cfg, dtype=jnp.float32)
    jdet.load_params(params)
    pdet = port_detector.CNNFaceDetector(**cfg, max_faces=4, dtype=torch.float32,
                                         device="cpu")
    detector_params_from_flax(params, pdet.net)
    x = _frames(seed=3, shape=(2, 61, 70))  # not multiples of the stride
    wb, ws, wv = (np.asarray(a) for a in jdet.detect_batch(x))
    gb, gs, gv = (a.numpy() for a in pdet.detect_batch(x))
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gb, wb, atol=1e-3)
    assert gb[..., 2].max() <= 61 and gb[..., 3].max() <= 70
    assert pdet.detect(x[0]) == jdet.detect(x[0])
    assert set(pdet.params) == set(pdet.net.state_dict())


def _crafted_boxes():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30],
                      [0, 0, 10, 10], [21, 21, 31, 31], [50, 50, 52, 52],
                      [40, 0, 50, 10], [40, 0, 50, 10]], np.float32)
    scores = np.array([0.9, 0.9, 0.5, 0.9, 0.5, 0.1, 0.7, 0.7], np.float32)
    return boxes, scores


@pytest.mark.parametrize("score_threshold", [0.0, 0.3])
def test_nms_fixed_ties(score_threshold):
    """Equal scores: the lower index is visited (and kept) first, exactly as
    the reference's stable argsort and top_k order them."""
    boxes, scores = _crafted_boxes()
    for max_out in (3, 6, 8):
        want = [np.asarray(a) for a in jax_nms.nms_fixed(
            jnp.asarray(boxes), jnp.asarray(scores), max_out, 0.45, score_threshold)]
        got = [a.numpy() for a in port_nms.nms_fixed(
            torch.tensor(boxes), torch.tensor(scores), max_out, 0.45, score_threshold)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    keep = port_nms.nms_mask(torch.tensor(boxes), torch.tensor(scores), 0.45)
    assert keep.tolist() == [True, False, True, False, False, True, True, False]
    # batched form == per-image form
    batch = port_nms.nms_fixed(torch.tensor(np.stack([boxes, boxes[::-1].copy()])),
                               torch.tensor(np.stack([scores, scores[::-1].copy()])),
                               4, 0.45, score_threshold)
    single = port_nms.nms_fixed(torch.tensor(boxes[::-1].copy()),
                                torch.tensor(scores[::-1].copy()), 4, 0.45, score_threshold)
    for b, s in zip(batch, single):
        assert torch.equal(b[1], s)


def test_pairwise_iou_and_area():
    a = np.array([[0, 0, 2, 2], [1, 1, 3, 3], [5, 5, 4, 4]], np.float32)
    np.testing.assert_allclose(port_nms.pairwise_iou(torch.tensor(a), torch.tensor(a)).numpy(),
                               np.asarray(jax_nms.pairwise_iou(jnp.asarray(a), jnp.asarray(a))))
    np.testing.assert_array_equal(port_nms.box_area(torch.tensor(a)).numpy(),
                                  np.asarray(jax_nms.box_area(jnp.asarray(a))))


def test_stable_topk_breaks_ties_to_lowest_index():
    vals, idx = port_nms.stable_topk(torch.zeros(1, 7), 3)
    assert idx.tolist() == [[0, 1, 2]]
    wv, wi = jax.lax.top_k(jnp.asarray([[0.0, 2.0, 1.0, 2.0, 0.0]]), 4)
    gv, gi = port_nms.stable_topk(torch.tensor([[0.0, 2.0, 1.0, 2.0, 0.0]]), 4)
    assert gi.tolist() == np.asarray(wi).tolist()


def test_same_padding_is_xla_same():
    assert same_padding(64, 3, 2) == (0, 1)  # stride 2, even: (0, 1), not (1, 1)
    assert same_padding(63, 3, 2) == (1, 1)
    assert same_padding(16, 3, 1) == (1, 1)
    assert same_padding(16, 1, 1) == (0, 0)


@pytest.mark.parametrize("iou_threshold, score_threshold", [(0.5, 0.3), (0.45, 0.0)])
def test_nms_mask_plain_matches_jax_on_ties_and_threshold_ious(iou_threshold,
                                                               score_threshold):
    """The plain keep-loop (the CUDA kernel's oracle) equals the reference's
    ``nms_mask`` on boxes on a half-pixel grid (many IoUs exactly at 0.5)
    with scores rounded to 0.1 (many exact ties), image by image."""
    rng = np.random.default_rng(17)
    n, k = 64, 48
    y0, x0 = (rng.integers(0, 20, (2, n, k)) * 0.5)
    h, w = (rng.integers(1, 8, (2, n, k)) * 0.5)
    boxes = np.stack([y0, x0, y0 + h, x0 + w], -1).astype(np.float32)
    # candidates 0 and 1 of every image overlap at IoU 2 / 4 = 0.5 exactly
    boxes[:, 0] = np.tile(boxes[:, 0, :2], 2) + [0.0, 0.0, 3.0, 1.0]
    boxes[:, 1] = boxes[:, 0] + [1.0, 0.0, 1.0, 0.0]
    scores = np.round(rng.random((n, k)), 1).astype(np.float32)
    scores[:, :2] = [0.9, 0.8]
    got = port_nms.nms_mask_plain(torch.tensor(boxes), torch.tensor(scores),
                                  iou_threshold, score_threshold).numpy()
    want = jax.vmap(jax_nms.nms_mask, in_axes=(0, 0, None, None))(
        jnp.asarray(boxes), jnp.asarray(scores), iou_threshold, score_threshold)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(port_nms.nms_mask(
        torch.tensor(boxes), torch.tensor(scores), iou_threshold, score_threshold).numpy(), got)
    iou = port_nms.pairwise_iou(torch.tensor(boxes), torch.tensor(boxes))
    assert (iou[:, 0, 1] == 0.5).all()  # the threshold itself is exercised
    assert got[:, 1].all() == (iou_threshold >= 0.5)
