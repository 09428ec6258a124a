"""The plain reference against the system's own CPU path, both in float32
on the same weights and frames, at a small size (this test imports both;
the reference itself imports nothing of the system)."""

import numpy as np
import pytest
import torch

import inputs
import run
from reference import match as ref_match
from reference import nets


@pytest.fixture(scope="module")
def setup():
    from opencv_facerecognizer_tpu_torch.models import detector as D
    from opencv_facerecognizer_tpu_torch.models import embedder as E

    cfg = run.load_json(run.HERE / "configs" / "serve_1m.json")
    dw, ew = inputs.make_weights(31337, cfg["detector"], cfg["embedder"], "cpu")
    frames = inputs.make_scenes(8, (256, 256), 8, (24, 64), 5)
    det = D.CNNFaceDetector(device="cpu", dtype=torch.float32)
    det.load_params(dw)
    net = E.FaceEmbedNet(**E.SERVING_EMBEDDER_KWARGS, input_size=(64, 64),
                         dtype=torch.float32)
    net.load_state_dict(ew)
    ref = nets.recognize_faces(dw, ew, torch.from_numpy(frames), cfg["detector"],
                               cfg["embedder"])
    return cfg, det, net, frames, {**ref, "ew": ew}


def test_detection_and_embedding_agree(setup):
    from opencv_facerecognizer_tpu_torch.models import detector as D
    from opencv_facerecognizer_tpu_torch.models import embedder as E
    from opencv_facerecognizer_tpu_torch.ops import image

    cfg, det, net, frames, ref = setup
    x = torch.from_numpy(frames).float()
    boxes, scores, valid = D.decode_detections(det.net(x), 16, 0.3, 0.4)
    assert torch.equal(valid, ref["valid"])
    assert torch.allclose(boxes, ref["boxes"], atol=1e-3)
    assert torch.allclose(scores[valid], ref["scores"][valid], atol=1e-5)
    # the same boxes on both sides: crop, standardize and embed
    crops = image.batched_crop_resize(x, boxes, (64, 64)).reshape(-1, 64, 64)
    faces = E.normalize_faces(crops, (64, 64))
    ref_crops = nets.crop_faces(x, boxes, (64, 64)).reshape(-1, 64, 64)
    assert torch.allclose(crops, ref_crops, atol=1e-3)
    emb = nets.embed(setup[4]["ew"], nets.standardize(ref_crops), cfg["embedder"])
    with torch.no_grad():
        assert (net(faces) * emb).sum(-1).min() > 1 - 1e-5  # the f32 blocks
        # the fused blocks (kernel B's plain version) round their operands
        # to bf16 whatever the net's dtype
        assert (E.fused_forward(net, faces) * emb).sum(-1).min() > 0.999


def test_match_agrees_with_the_gallery():
    from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery

    rows = inputs.row_block(77, 0, 4096, 256, "cpu")
    q = ref_match.normalize_rows(torch.randn(64, 256, generator=torch.Generator().manual_seed(3)))
    q[:8] = ref_match.normalize_rows(rows[100:108])  # decisive: their own rows
    g = ShardedGallery(4096, 256, store_dtype=torch.float32, device="cpu")
    g.add(rows.numpy(), np.arange(4096, dtype=np.int32))
    labels, sims, _ = g.match(q, k=1)
    best, arg = ref_match.top1(q, [(0, rows[:2048]), (2048, rows[2048:])])
    assert torch.equal(arg[:8], torch.arange(100, 108))
    assert torch.equal(labels[:8, 0].long(), arg[:8])
    # the gallery rounds both sides to bf16 at the product: within its rounding
    assert torch.allclose(sims[:, 0], best, atol=1e-2)
