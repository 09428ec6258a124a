"""The port's ``entry()`` (``opencv_facerecognizer_tpu_torch/entry.py``)
against the reference's (``__graft_entry__.entry``): the same example
frames, gallery and labels, and the port's ``fn`` on the reference's
parameters (carried across by ``utils.params``) gives the reference's
outputs. Both run in float32 (the nets' compute dtype swapped, as
``tests/test_torch_recognize_app.py`` does), the detector's heatmap bias
raised so the untrained detector finds faces. Tolerance: the valid mask
and the labels exactly, boxes to 1e-3 px, scores and sims to 1e-4
(float32 sums in another order)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from opencv_facerecognizer_tpu.models import detector as jax_detector
from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu_torch import entry as port_entry
from opencv_facerecognizer_tpu_torch.utils.params import (
    detector_params_from_flax, embedder_params_from_flax)


@pytest.fixture
def f32_reference(monkeypatch):
    monkeypatch.setattr(jax_detector, "DetectorNet",
                        functools.partial(jax_detector.DetectorNet, dtype=jnp.float32))
    monkeypatch.setattr(jax_embedder, "FaceEmbedNet",
                        functools.partial(jax_embedder.FaceEmbedNet, dtype=jnp.float32))


def test_entry_matches_reference(f32_reference):
    jfn, jargs = jax_entry.entry()
    det_flax = {k: dict(v) for k, v in jargs[0].items()}
    heat = sorted((k for k in det_flax if k.startswith("Conv_")),
                  key=lambda k: int(k.split("_")[1]))[-3]
    det_flax[heat]["bias"] = jnp.zeros_like(det_flax[heat]["bias"])
    jargs = (det_flax, *jargs[1:])
    fn, args = port_entry.entry(device="cpu", dtype=torch.float32)
    for a, b in zip(args[2:], jargs[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the reference's parameters in the port's nets' layout
    det_net = port_entry.CNNFaceDetector(max_faces=8, dtype=torch.float32, device="cpu").net
    emb_net = port_entry.FaceEmbedNet(**port_entry.SERVING_EMBEDDER_KWARGS,
                                      input_size=port_entry.SERVING_FACE_SIZE,
                                      dtype=torch.float32)
    detector_params_from_flax(det_flax, det_net)
    embedder_params_from_flax(jargs[1], emb_net)
    got = fn(dict(det_net.named_parameters()), dict(emb_net.named_parameters()), *args[2:])
    want = [np.asarray(x) for x in jfn(*jargs)]
    boxes, scores, valid, labels, sims = (t.numpy() for t in got)
    assert valid.shape == want[2].shape == (4, 8)
    np.testing.assert_array_equal(valid, want[2])
    assert valid.sum() >= 4
    np.testing.assert_allclose(boxes, want[0], atol=1e-3)
    np.testing.assert_allclose(scores[valid], want[1][want[2]], atol=1e-4)
    keep = valid.reshape(-1)
    np.testing.assert_array_equal(labels[keep], want[3][keep])
    np.testing.assert_allclose(sims[keep], want[4][keep], atol=1e-4)


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_entry.entry()
