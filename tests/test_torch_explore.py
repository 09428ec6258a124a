"""The port's exploration apps against the reference's scripts, on the CPU.

- ``apps/explore_fisherfaces.py``: the 22 candidates in the reference's
  order, each model's spec (``get_config``) equal to the reference's, its
  protocol and folds; at a reduced protocol (SMALL_FACES, SMALL_FOLDS
  folds) each of seven nearest-neighbour candidates that together cover
  every operator and distance gives the reference's ``run_candidate``
  accuracy exactly (both packages fold alike and score the same true
  positives: ``tests/test_torch_trainer.py``). The kernel SVM candidate
  is held by its spec: its first Adam step moves each bias on a gradient
  that is 0 in exact arithmetic, so its decisions follow the summation
  order's roundoff in either package (ROADMAP C.34, pinned below; the
  SVM's training against optax on data without that zero is
  ``tests/test_torch_classic_models.py``). The row's fields; ``--out``
  appends a line a row, nothing is written without it, and an unknown
  ``--only`` exits as the reference's does.
- ``apps/explore_perf.py``: the variant tables and the sweep's recipe
  (scenes, detector, training, batches) are the reference's; every
  variant's parameter count equals the JAX package's (``jax.eval_shape``);
  three embedder forwards in f32 on parameters carried across equal the
  reference's forward scalar within FWD_ATOL, and the FLOP count is held
  against XLA's ``cost_analysis`` within FLOP_RATIO; a detector variant
  trained SMALL_STEPS steps in f32 from the JAX init carried across, on
  the same batches, gives the reference's recall and precision, and its
  matched IoU within IOU_ATOL; off the card nothing is timed (ROADMAP
  C.33) and ``main`` without ``--device`` raises.

The reference's scripts are loaded by path, as
``tests/test_torch_accuracy_tools.py`` loads them; sizes shrink through
module attributes both read at call time.
"""

import ast
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.models import classifier as jax_classifier
from opencv_facerecognizer_tpu.models import detector as jax_detector
from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu.models import model as jax_model
from opencv_facerecognizer_tpu.utils import dataset as jax_dataset
from opencv_facerecognizer_tpu_torch.apps import explore_fisherfaces, explore_perf
from opencv_facerecognizer_tpu_torch.models import classifier as port_classifier
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.models import model as port_model
from opencv_facerecognizer_tpu_torch.utils import dataset as port_dataset
from opencv_facerecognizer_tpu_torch.utils.params import (
    detector_params_from_flax, detector_params_to_flax, embedder_params_from_flax)
from torch_train_support import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reduced Fisherfaces protocol: 6 subjects x 6 faces at 24x24 keeps
#: every candidate's accuracy off 1.0 (4 x 6 at 32x32 gives 1.0 for five)
SMALL_FACES = dict(num_subjects=6, per_subject=6, size=(24, 24))
SMALL_FOLDS = 3
#: seven candidates: TanTriggs, LBP histograms (radius 2 and 3, grids 8 and
#: 6), Fisherfaces, Chain and Combine; Euclidean, cosine, chi-square,
#: intersection and L1 bin-ratio distances; 1-NN and 3-NN
FISHER_CASES = ("baseline_fisher_nn", "lbp_chi2", "lbp_histint", "lbp_l1brd",
                "combine_fisher_lbpfisher", "fisher_knn3", "rawlbp6r3_fisher_cosine")
#: the forward scalar: f32 sums of 4 x 128 unit-norm components in another
#: order (read: 1.1e-6 to 2.0e-6)
FWD_ATOL = 2e-5
#: XLA's FLOPs over FlopCounterMode's (read: 1.117 separable, 0.835 dense
#: s2d4, 1.089 light). XLA adds elementwise work (norms, activations,
#: the standardization) and leaves out the taps that fall on SAME padding,
#: which the dense 3x3 convs on 7x7 maps have most of
FLOP_RATIO = (0.8, 1.15)
EMBED_CASES = ("baseline_sep_s1_full", "dense_s2d4", "sep_s1_light")
#: the detector case: the serving stem at 64x64 scenes, SMALL_STEPS steps
DET_CASE = "s2d4_64-64"
SMALL_SCENES = dict(SCENE_SIZE=(64, 64), FACE_SIZE_RANGE=(16, 32), TRAIN_SCENES=(16, 7),
                    TEST_SCENES=(8, 1234))
SMALL_STEPS = 3
#: the init's head biases: heatmap 0 and size 3 cells (flax: -4 and 0), so
#: that 3 steps from it detect faces at all (chip_smoke.py's HEATMAP_BIAS
#: and SIZE_BIAS)
HEATMAP_BIAS, SIZE_BIAS = 0.0, 3.0
#: matched IoU after 3 Adam steps in f32 from one init (read: < 1e-6)
IOU_ATOL = 1e-5


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_fisher = _load_script("explore_fisherfaces")
ref_perf = _load_script("explore_perf")


def _ref_locals(fn_name):
    """The literal local assignments of the reference's ``fn_name``
    (``dict(...)`` calls evaluated), by name."""
    with open(os.path.join(REPO, "scripts", "explore_perf.py")) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    out = {}
    for node in fn.body:
        if not isinstance(node, ast.Assign):
            continue
        try:
            value = eval(compile(ast.Expression(node.value), "<ref>", "eval"), {"dict": dict})
        except NameError:
            continue
        for target in node.targets:
            out[target.id] = value
    return out


def _small_fisher(monkeypatch):
    for mod in (explore_fisherfaces, ref_fisher):
        monkeypatch.setattr(mod, "PROTOCOL", dict(mod.PROTOCOL, **SMALL_FACES))
        monkeypatch.setattr(mod, "FOLDS", SMALL_FOLDS)


def _ref_embed_net(cfg, dtype=jnp.bfloat16):
    """The reference's ``FaceEmbedNet`` for ``cfg`` (``scripts/explore_perf.py:160-168``)."""
    return jax_embedder.FaceEmbedNet(
        embed_dim=cfg.get("embed_dim", 128), stem_features=32,
        stage_features=cfg.get("stage_features", (64, 128, 128)),
        stage_blocks=cfg.get("stage_blocks", (2, 2, 2)), block=cfg.get("block", "separable"),
        space_to_depth=cfg.get("space_to_depth", 1), norm=cfg.get("norm", "full"), dtype=dtype)


def _count(tree):
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(tree))


# ---------- explore_fisherfaces ----------


def test_candidates_and_protocol_are_the_references():
    """The names in order, and each candidate's model spec (feature chain,
    operators' settings, classifier and its hyperparameters)."""
    port, ref = explore_fisherfaces.candidates(), ref_fisher.candidates()
    assert list(port) == list(ref) and len(port) == 22
    for name in port:
        got = port_model.PredictableModel(*port[name]("cpu")).get_config()
        assert got == jax_model.PredictableModel(*ref[name]()).get_config(), name
    assert explore_fisherfaces.PROTOCOL == ref_fisher.PROTOCOL
    assert explore_fisherfaces.FOLDS == ref_fisher.FOLDS == 10


@pytest.mark.parametrize("name", FISHER_CASES)
def test_candidate_accuracy_equals_the_references(name, monkeypatch):
    _small_fisher(monkeypatch)
    got = explore_fisherfaces.run_candidate(name, explore_fisherfaces.candidates()[name], "cpu")
    want = ref_fisher.run_candidate(name, ref_fisher.candidates()[name])
    assert got["accuracy"] == want["accuracy"], (got, want)
    assert 0.3 < got["accuracy"] < 1.0  # the reduced protocol still separates candidates
    assert list(got) == [*want, "backend"] and got["backend"] == "cpu"
    assert {k: got[k] for k in ("name", "folds", "protocol")} == {
        k: want[k] for k in ("name", "folds", "protocol")}


def test_kernel_svm_biases_start_from_roundoff():
    """C.34: on balanced classes at alpha = 0 the Crammer-Singer bias
    gradient is 0 in exact arithmetic (each class gains 1 / (C - 1) from
    every other class's samples and loses 1 from each of its own), so in
    float32 it is summation roundoff, and Adam's first step, which divides
    by |g| + 1e-8, turns that roundoff into bias moves of up to the
    learning rate, in the JAX package and in the port alike, with other
    signs and sizes in each."""
    c, n = 6, 4
    x = np.random.default_rng(0).normal(size=(c * n, 5)).astype(np.float32)
    y = np.repeat(np.arange(c), n)
    onehot = np.eye(c)[y]
    wrong = 1.0 / (c - 1) * (1 - onehot)  # the tied best wrong classes' share
    assert np.abs((wrong - onehot).mean(axis=0)).max() < 1e-15  # float64: 0
    want = jax_classifier.KernelSVM(kernel="rbf", epochs=1)
    got = port_classifier.KernelSVM(kernel="rbf", epochs=1, device="cpu")
    want.compute(x, y)
    got.compute(x, y)
    b_ref, b_port = np.asarray(want._b), got._b.numpy()
    lr = want.learning_rate
    assert np.abs(b_ref).max() > lr / 10 and np.abs(b_ref).max() <= lr
    assert np.abs(b_port - b_ref).max() > lr / 10


def test_out_appends_a_line_a_row_and_nothing_is_written_without_it(tmp_path, monkeypatch,
                                                                    capsys):
    _small_fisher(monkeypatch)
    scripts = os.path.join(REPO, "scripts")

    def state():  # bytecode caches aside: another test process may write them
        return {f: os.stat(os.path.join(scripts, f)).st_mtime_ns
                for f in os.listdir(scripts) if f != "__pycache__"}

    before = state()
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    argv = ["--device", "cpu", "--only", "fisher_knn3", "--only", "baseline_fisher_nn"]
    assert explore_fisherfaces.main(argv) == 0
    printed = capsys.readouterr().out.splitlines()
    assert os.listdir(work) == [] and state() == before
    out = tmp_path / "rows.jsonl"
    out.write_text('{"name": "earlier"}\n')
    assert explore_fisherfaces.main([*argv, "--out", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert json.loads(lines[0]) == {"name": "earlier"} and len(lines) == 3
    rows = [json.loads(line) for line in lines[1:]]
    assert [r["name"] for r in rows] == ["fisher_knn3", "baseline_fisher_nn"]
    assert lines[1:] == capsys.readouterr().out.splitlines()
    assert [json.loads(p)["accuracy"] for p in printed] == [r["accuracy"] for r in rows]


def test_unknown_candidate_exits_as_the_references():
    with pytest.raises(SystemExit) as want:
        ref_fisher.main(["--only", "no_such_candidate"])
    with pytest.raises(SystemExit) as got:
        explore_fisherfaces.main(["--device", "cpu", "--only", "no_such_candidate"])
    assert str(got.value) == str(want.value) and "no_such_candidate" in str(got.value)


# ---------- explore_perf ----------


class _Stop(Exception):
    pass


#: what the recorded scene maker returns
TINY_SCENES = port_dataset.make_synthetic_scenes(2, (16, 16), max_faces=1, face_size_range=(4, 8))


def _recorded_recipe(monkeypatch, dataset_module, detector_attr_owner, run):
    """Run ``run()`` with ``dataset_module.make_synthetic_scenes`` and the
    detector class swapped for recorders; the recorders stop the sweep at
    its first training. Returns the calls, in order."""
    calls = []

    def scenes(**kw):
        calls.append(("scenes", kw))
        return TINY_SCENES

    class Detector:
        def __init__(self, **kw):
            calls.append(("detector", {k: v for k, v in kw.items() if k != "device"}))

        def train(self, *args, **kw):
            calls.append(("train", len(args), kw))
            raise _Stop

    monkeypatch.setattr(dataset_module, "make_synthetic_scenes", scenes)
    monkeypatch.setattr(detector_attr_owner, "CNNFaceDetector", Detector)
    with pytest.raises(_Stop):
        run()
    return calls


def test_variants_and_recipe_are_the_references(monkeypatch):
    ref_det = _ref_locals("detector_variants")
    assert explore_perf.DETECTOR_VARIANTS == ref_det["variants"]
    assert explore_perf.EMBEDDER_VARIANTS == ref_perf.EMBEDDER_VARIANTS
    assert list(explore_perf.EMBEDDER_VARIANTS) == list(ref_perf.EMBEDDER_VARIANTS)
    assert explore_perf.DETECTOR_BATCH == ref_det["batch"]
    assert explore_perf.EMBEDDER_BATCH == _ref_locals("embedder_variants")["batch"]
    want = _recorded_recipe(monkeypatch, jax_dataset, jax_detector,
                            ref_perf.detector_variants)
    got = _recorded_recipe(monkeypatch, port_dataset, explore_perf,
                           lambda: explore_perf.detector_variants("cpu"))
    assert got == want and len(got) == 4


def test_params_counts_equal_the_jax_packages():
    key = jax.random.PRNGKey(0)
    for name, cfg in explore_perf.DETECTOR_VARIANTS.items():
        det = port_detector.CNNFaceDetector(max_faces=8, device="cpu", **cfg)
        shapes = jax.eval_shape(jax_detector.DetectorNet(**cfg).init, key,
                                jnp.zeros((1, *explore_perf.SCENE_SIZE)))
        assert explore_perf.n_params(det.net) == _count(shapes["params"]), name
    for name, cfg in explore_perf.EMBEDDER_VARIANTS.items():
        net, size = explore_perf.embedder_net(cfg, "cpu")
        shapes = jax.eval_shape(_ref_embed_net(cfg).init, key, jnp.zeros((1, *size)))
        assert explore_perf.n_params(net) == _count(shapes["params"]), name


@pytest.mark.parametrize("name", EMBED_CASES)
def test_embedder_forward_and_flops_against_the_references(name, monkeypatch):
    cfg = explore_perf.EMBEDDER_VARIANTS[name]
    monkeypatch.setattr(explore_perf, "EMBEDDER_BATCH", 4)
    monkeypatch.setattr(explore_perf, "FaceEmbedNet",
                        functools.partial(explore_perf.FaceEmbedNet, dtype=torch.float32))
    net, size = explore_perf.embedder_net(cfg, "cpu")
    jnet = _ref_embed_net(cfg, jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, *size)))["params"])
    embedder_params_from_flax(params, net)
    x = explore_perf.embedder_frames(size, "cpu")
    np.testing.assert_array_equal(
        x.numpy(), np.random.default_rng(0).normal(120, 40, (4, *size)).astype(np.float32))

    def ref_fwd(p, frames):  # scripts/explore_perf.py:175-177
        return jnp.sum(jnet.apply({"params": p}, jax_embedder.normalize_faces(frames, size)))

    compiled = jax.jit(ref_fwd).lower(params, jnp.asarray(x.numpy())).compile()
    cost = compiled.cost_analysis()
    xla_flops = float((cost[0] if isinstance(cost, list) else cost)["flops"])
    want = float(compiled(params, jnp.asarray(x.numpy())))
    fwd = explore_perf.embedder_forward(net, size)
    with torch.no_grad():
        got = float(fwd(x))
    assert abs(got - want) <= FWD_ATOL, (got, want)
    ratio = xla_flops / explore_perf.forward_flops(fwd, x)
    assert FLOP_RATIO[0] <= ratio <= FLOP_RATIO[1], ratio
    # off the card the row carries no time (C.33)
    monkeypatch.setattr(explore_perf, "EMBEDDER_VARIANTS", {name: cfg})
    assert explore_perf.embedder_variants("cpu") == {name: {
        "ms_per_256crops_fwd": None, "invalid": "not timed off the card",
        "params": explore_perf.n_params(net)}}


def test_detector_training_and_quality_equal_the_references(monkeypatch):
    cfg = explore_perf.DETECTOR_VARIANTS[DET_CASE]
    for attr, value in SMALL_SCENES.items():
        monkeypatch.setattr(explore_perf, attr, value)
    monkeypatch.setattr(explore_perf, "DETECTOR_VARIANTS", {DET_CASE: cfg})
    monkeypatch.setattr(explore_perf, "DETECTOR_TRAIN",
                        dict(explore_perf.DETECTOR_TRAIN, steps=SMALL_STEPS))
    jnet = jax_detector.DetectorNet(**cfg, dtype=jnp.float32)
    init = jax.tree_util.tree_map(np.asarray, jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, *SMALL_SCENES["SCENE_SIZE"])))["params"])
    pnet = detector_params_from_flax(init, port_detector.DetectorNet(**cfg, dtype=torch.float32))
    with torch.no_grad():
        pnet.heatmap.bias.fill_(HEATMAP_BIAS)
        pnet.size.bias.fill_(SIZE_BIAS)
    init = detector_params_to_flax(pnet)

    def port_det(**kw):
        det = port_detector.CNNFaceDetector(dtype=torch.float32, **kw)
        det.load_params(pnet.state_dict())
        return det

    seen = []

    def evaluate(det, *test):
        seen.append(port_detector.evaluate_detector(det, *test))
        return seen[-1]

    monkeypatch.setattr(explore_perf, "CNNFaceDetector", port_det)
    monkeypatch.setattr(explore_perf, "evaluate_detector", evaluate)
    row = explore_perf.detector_variants("cpu")[DET_CASE]

    # the reference's recipe (scripts/explore_perf.py:50-72) on the same init
    (h, w), (n_tr, s_tr), (n_te, s_te) = (SMALL_SCENES[k] for k in (
        "SCENE_SIZE", "TRAIN_SCENES", "TEST_SCENES"))
    scenes = dict(scene_size=(h, w), max_faces=8, face_size_range=SMALL_SCENES["FACE_SIZE_RANGE"])
    train = jax_dataset.make_synthetic_scenes(num_scenes=n_tr, seed=s_tr, **scenes)
    test = jax_dataset.make_synthetic_scenes(num_scenes=n_te, seed=s_te, **scenes)
    det = jax_detector.CNNFaceDetector(max_faces=8, score_threshold=0.3, **cfg)
    det.net = jnet
    det.load_params(init)
    det.train(*train, steps=SMALL_STEPS, batch_size=16)
    want = jax_detector.evaluate_detector(det, *test)

    (got,) = seen
    assert want["num_gt"] > 0 and want["num_pred"] > 0 and want["recall"] > 0
    assert (got["recall"], got["precision"]) == (want["recall"], want["precision"])
    assert abs(got["mean_matched_iou"] - want["mean_matched_iou"]) <= IOU_ATOL
    # off the card: no time, every other column (C.33)
    assert list(row) == ["ms_per_batch32_fwd", "invalid", "recall", "precision", "mean_iou",
                         "params", "train_s"]
    assert row["ms_per_batch32_fwd"] is None and row["invalid"] == "not timed off the card"
    assert row["recall"] == round(want["recall"], 4)
    assert row["params"] == _count(init)


def test_main_prints_the_table_and_needs_a_card_unless_told(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(explore_perf, "EMBEDDER_BATCH", 2)
    monkeypatch.setattr(explore_perf, "EMBEDDER_VARIANTS", {
        "tiny": dict(block="dense", space_to_depth=2, stage_features=(8, 16),
                     stage_blocks=(1, 1), input_size=32, embed_dim=16)})
    monkeypatch.chdir(tmp_path)
    assert explore_perf.main(["--device", "cpu", "--skip-detector"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert list(out) == ["device", "date", "embedder"] and out["device"] == "cpu"
    assert out["embedder"]["tiny"]["ms_per_256crops_fwd"] is None
    assert os.listdir(tmp_path) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        explore_perf.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        explore_fisherfaces.main([])
