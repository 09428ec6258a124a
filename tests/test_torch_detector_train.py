"""Detector and stage-1 gate training of the PyTorch port against the JAX
package's, on the CPU, in float32.

- ``gaussian_heatmap_targets`` bit for bit; ``tile_targets`` is held in
  ``tests/test_torch_cascade.py``.
- ``detector_loss`` and ``gate_loss``: values, and gradients through the
  nets from one init carried across, per tensor relative to its largest
  |g| (GRAD_RTOL).
- ``train_detector`` / ``train_face_gate`` over a few steps from one
  carried-across init: the nets' outputs after training (Adam turns the
  gradients' roundoff into moves of up to lr on parameters whose true
  gradient is ~0, so the outputs are held within a few steps' lr).
- ``evaluate_detector`` on equal detections returns the reference's dict.
- ``CNNFaceDetector.train`` / ``FaceGate.train`` start from their seed's
  init when nothing was loaded and fine-tune loaded weights otherwise;
  trained weights go back to the flax layout and run alike in the JAX
  package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.models import cascade as jax_cascade
from opencv_facerecognizer_tpu.models import detector as jax_detector
from opencv_facerecognizer_tpu.utils.dataset import make_synthetic_scenes
from opencv_facerecognizer_tpu_torch.models import cascade as port_cascade
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.utils.params import (
    cascade_params_from_flax, cascade_params_to_flax, detector_params_from_flax,
    detector_params_to_flax)
from torch_train_support import GradView, one_torch_thread  # noqa: F401

DET = dict(features=(8, 16), head_features=16, space_to_depth=2)
HW = (48, 48)
#: f32 losses: sums over the batch in another order
LOSS_RTOL = 1e-5
#: gradients per tensor, |port - ref| / max |ref|
GRAD_RTOL = 1e-4
#: outputs (logits, sizes, offsets of magnitude 1-5) after STEPS Adam
#: steps at LR from one init. A parameter whose true gradient is roundoff
#: could move by up to STEPS * LR in one package and not the other; at
#: these seeds none does, and the outputs agree to ~8e-6
STEPS, LR = 4, 1e-3
OUT_ATOL = 1e-4


def _scenes(n, seed, hw=HW, max_faces=2):
    return make_synthetic_scenes(n, hw, max_faces=max_faces, face_size_range=(10, 18),
                                 seed=seed)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _det_pair(seed=0):
    jnet = jax_detector.DetectorNet(**DET, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jnet.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, *HW)))["params"])
    pnet = detector_params_from_flax(params, port_detector.DetectorNet(**DET, dtype=torch.float32))
    return jnet, params, pnet


def _gate_pair(seed=0):
    jnet = jax_cascade.CascadeNet(dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jnet.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, *HW)))["params"])
    pnet = cascade_params_from_flax(params, port_cascade.CascadeNet(dtype=torch.float32))
    return jnet, params, pnet


def _assert_tree_close(got, want, rel):
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(leaves) == len(flat)
    for path, g in leaves:
        assert _rel(g, flat[path]) <= rel, jax.tree_util.keystr(path)


# ---------- targets and losses ----------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gaussian_heatmap_targets_bit_for_bit(seed):
    _s, boxes, counts = _scenes(6, seed, hw=(64, 56), max_faces=3)
    if seed == 3:  # boxes on the edges and degenerate ones
        boxes[0, 0] = (0, 0, 4, 4)
        boxes[0, 1] = (60, 50, 64, 56)
        boxes[1, 0] = (10, 10, 10, 10)
        counts[:2] = (2, 1)
    want = jax_detector.gaussian_heatmap_targets(boxes, counts, (64, 56), boxes.shape[1])
    got = port_detector.gaussian_heatmap_targets(boxes, counts, (64, 56), boxes.shape[1])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_detector_loss_and_grads_match_jax():
    scenes, boxes, counts = _scenes(6, 4)
    targets = dict(zip(("heatmap", "size", "offset", "mask"),
                       port_detector.gaussian_heatmap_targets(boxes, counts, HW, 2)))
    jnet, params, pnet = _det_pair()

    def loss_fn(p):
        return jax_detector.detector_loss(jnet.apply({"params": p}, jnp.asarray(scenes)),
                                          {k: jnp.asarray(v) for k, v in targets.items()})

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    got = port_detector.detector_loss(pnet(torch.tensor(scenes)),
                                      {k: torch.tensor(v) for k, v in targets.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _assert_tree_close(port_detector_grads(pnet), grads, GRAD_RTOL)
    # the loss prefers the right heatmap (the reference's own check)
    logits = np.full((1, 6, 6), -6.0, np.float32)
    iy, ix = np.unravel_index(targets["heatmap"][0].argmax(), (6, 6))
    logits[0, iy, ix] = 6.0
    t0 = {k: torch.tensor(v[:1]) for k, v in targets.items()}
    good = {"heatmap": torch.tensor(logits), "size": t0["size"], "offset": t0["offset"]}
    bad = dict(good, heatmap=-good["heatmap"])
    assert port_detector.detector_loss(good, t0) < port_detector.detector_loss(bad, t0)


def port_detector_grads(pnet):
    return detector_params_to_flax(GradView(pnet))


def test_gate_loss_and_grads_match_jax():
    scenes, boxes, counts = _scenes(6, 5)
    t = port_cascade.tile_targets(boxes, counts, HW, 16)
    jnet, params, pnet = _gate_pair()

    def loss_fn(p):
        return jax_cascade.gate_loss(jnet.apply({"params": p}, jnp.asarray(scenes)),
                                     jnp.asarray(t), 2.0)

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    got = port_cascade.gate_loss(pnet(torch.tensor(scenes)), torch.tensor(t), 2.0)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _assert_tree_close(cascade_params_to_flax(GradView(pnet)), grads, GRAD_RTOL)
    good = np.where(t > 0, 5.0, -5.0).astype(np.float32)
    assert (port_cascade.gate_loss(torch.tensor(good), torch.tensor(t))
            < port_cascade.gate_loss(torch.tensor(-good), torch.tensor(t)))


# ---------- a few steps from one init ----------


def _jax_detector_outputs(jnet, params, x):
    out = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))
    return {k: np.asarray(v) for k, v in out.items()}


def test_train_detector_matches_jax_from_one_init():
    scenes, boxes, counts = _scenes(10, 6)
    jnet, params, pnet = _det_pair(1)
    kw = dict(steps=STEPS, batch_size=4, learning_rate=LR, seed=2)
    want_params = jax_detector.train_detector(jnet, scenes, boxes, counts, params=params, **kw)
    got_params = port_detector.train_detector(pnet, scenes, boxes, counts,
                                              params=pnet.state_dict(), **kw)
    assert got_params.keys() == pnet.state_dict().keys()
    probe = _scenes(3, 7)[0]
    want = _jax_detector_outputs(jnet, want_params, probe)
    with torch.no_grad():
        got = pnet(torch.tensor(probe))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=OUT_ATOL, err_msg=k)
    # trained weights in the flax layout run alike in the JAX package
    back = _jax_detector_outputs(jnet, detector_params_to_flax(pnet), probe)
    for k in want:
        np.testing.assert_allclose(back[k], got[k].numpy(), atol=1e-4, err_msg=k)


def test_train_face_gate_matches_jax_from_one_init():
    scenes, boxes, counts = _scenes(12, 8)
    jnet, params, pnet = _gate_pair(1)
    kw = dict(steps=STEPS, batch_size=6, learning_rate=3e-3, seed=4)
    want_params = jax_cascade.train_face_gate(jnet, scenes, boxes, counts, params=params, **kw)
    port_cascade.train_face_gate(pnet, scenes, boxes, counts, params=pnet.state_dict(), **kw)
    probe = _scenes(3, 9)[0]
    want = np.asarray(jax.jit(jnet.apply)({"params": want_params}, jnp.asarray(probe)))
    with torch.no_grad():
        got = pnet(torch.tensor(probe)).numpy()
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)
    back = np.asarray(jax.jit(jnet.apply)({"params": cascade_params_to_flax(pnet)},
                                          jnp.asarray(probe)))
    np.testing.assert_allclose(back, got, atol=1e-4)


def test_train_loops_draw_the_reference_batches():
    """Every trainer's batches are ``default_rng(seed).choice`` per step,
    index for index (the Adam update's parity is in
    ``tests/test_torch_embedder_train.py``)."""
    from opencv_facerecognizer_tpu_torch.models._train import fixed_batches

    rng = np.random.default_rng(3)
    want = [rng.choice(10, size=4, replace=False) for _ in range(5)]
    np.testing.assert_array_equal(fixed_batches(10, 4, 5, 3, "cpu").numpy(), np.stack(want))
    rng = np.random.default_rng(3)
    want = [rng.choice(3, size=4, replace=True) for _ in range(2)]
    np.testing.assert_array_equal(fixed_batches(3, 4, 2, 3, "cpu").numpy(), np.stack(want))
    assert fixed_batches(3, 4, 0, 3, "cpu").shape == (0, 4)


# ---------- wrappers ----------


def test_detector_and_gate_train_from_seed_or_fine_tune():
    scenes, boxes, counts = _scenes(6, 10)
    det = port_detector.CNNFaceDetector(**DET, max_faces=4, device="cpu",
                                        generator=torch.Generator().manual_seed(99))
    det.train(scenes, boxes, counts, steps=0, seed=5)  # nothing loaded: the seed's init
    fresh = port_detector.DetectorNet(**DET)
    fresh.reset_parameters(torch.Generator().manual_seed(5))
    for k, v in fresh.state_dict().items():
        assert torch.equal(det.net.state_dict()[k], v), k
    before = {k: v.clone() for k, v in det.net.state_dict().items()}
    det.train(scenes, boxes, counts, steps=1, seed=5)  # trained: fine-tunes
    moved = [k for k, v in det.net.state_dict().items() if not torch.equal(v, before[k])]
    assert moved and all(
        (det.net.state_dict()[k] - before[k]).abs().max() <= 1e-3 * 1.01 for k in moved)
    gate = port_cascade.FaceGate(device="cpu")
    gate.train(scenes, boxes, counts, steps=0, seed=6)
    fresh = port_cascade.CascadeNet()
    fresh.reset_parameters(torch.Generator().manual_seed(6))
    assert all(torch.equal(gate.net.state_dict()[k], v) for k, v in fresh.state_dict().items())
    assert gate.train(scenes, boxes, counts, steps=1) is gate


def test_evaluate_detector_equal_detections_match_jax():
    """Both packages' ``evaluate_detector`` over one detector's outputs
    (numpy in, ties and invalid slots included)."""
    scenes, boxes, counts = _scenes(9, 11, max_faces=3)
    rng = np.random.default_rng(0)

    class Fixed:
        def __init__(self):
            self.calls = 0

        def detect_batch(self, chunk):
            n = len(chunk)
            start = self.calls
            self.calls += n
            gt = boxes[start:start + n]
            pred = np.concatenate([gt + rng.normal(0, 1.5, gt.shape).astype(np.float32),
                                   rng.uniform(0, 40, (n, 2, 4)).astype(np.float32)], axis=1)
            pred[..., 2:] = np.maximum(pred[..., 2:], pred[..., :2] + 2)
            scores = rng.choice([0.9, 0.5, 0.5, 0.2], size=(n, pred.shape[1])).astype(np.float32)
            valid = rng.random((n, pred.shape[1])) < 0.8
            return pred, scores, valid

    for bs in (4, 32):
        state = rng.bit_generator.state
        want = jax_detector.evaluate_detector(Fixed(), scenes, boxes, counts, batch_size=bs)
        rng.bit_generator.state = state
        got = port_detector.evaluate_detector(Fixed(), scenes, boxes, counts, batch_size=bs)
        assert got == want
