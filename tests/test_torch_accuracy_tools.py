"""The port's accuracy tools against the reference's scripts, on the CPU.

- ``apps/measure_accuracy.py``: each classic row of ``CONFIGS`` runs the
  reference's protocol (the same ``classic_kfold`` arguments) and, at a
  reduced subject count and image size, gives the reference's
  ``classic_kfold`` accuracy exactly (both packages fold alike and score
  the same true positives: ``tests/test_torch_trainer.py``); the keys, the
  result keys and each row's fields are the reference's; the MEASURED
  block equals the one the reference's ``main`` writes for the same rows,
  its stamp line excepted; the cache merge.
- ``apps/oracle_parity.py``: the oracle's functions against
  ``scripts/oracle_parity.py``'s on seeded inputs (LBP codes and
  histograms bit for bit, Tan-Triggs ``allclose``, PCA / LDA subspaces by
  their projectors, as ``tests/test_oracle_parity.py`` holds the JAX
  ops), ``oracle_kfold`` and ``framework_kfold`` equal to the reference's
  on a tiny dataset, the ORACLE block's rendering.
- ``apps/gate_embedder.py``: the reference's flags and defaults; at 2
  steps the row has the reference's fields and tag; the embedder its
  flags build has the JAX ``CNNEmbedding``'s parameter tree (paths and
  shapes) for the dense, space-to-depth and light variants.
- No tool writes a file unless ``--cache`` / ``--baseline-md`` / ``--out``
  names it (ROADMAP C, an accepted divergence: the reference writes its
  caches and ``BASELINE.md`` on every run).

The reference's scripts are loaded by path, as ``tests/test_chaos.py``
loads ``scripts/chaos_soak.py``.
"""

import ast
import functools
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest

from opencv_facerecognizer_tpu.runtime import trainer as jax_trainer
from opencv_facerecognizer_tpu.utils import dataset as jax_dataset
from opencv_facerecognizer_tpu_torch.apps import gate_embedder, measure_accuracy, oracle_parity
from opencv_facerecognizer_tpu_torch.utils.dataset import make_synthetic_faces
from torch_train_support import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSIC_KEYS = [k for k in sorted(measure_accuracy.CONFIGS) if k != "cnn"]
#: the classic rows' reduction: subjects per row and image size
SMALL_SUBJECTS = 4
SMALL_SIZE = (24, 24)


def _read(path):
    with open(path) as fh:
        return fh.read()


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_measure = _load_script("measure_accuracy")
ref_oracle = _load_script("oracle_parity")
ref_gate_path = os.path.join(REPO, "scripts", "gate_embedder.py")


def _small_reference(monkeypatch, size):
    """The reference's ``classic_kfold`` / ``framework_kfold`` at ``size``:
    their data and trainer config come from module attributes read at
    call time."""
    faces = jax_dataset.make_synthetic_faces
    monkeypatch.setattr(jax_dataset, "make_synthetic_faces",
                        lambda **kw: faces(**{**kw, "size": size}))
    monkeypatch.setattr(jax_trainer, "TrainerConfig",
                        functools.partial(jax_trainer.TrainerConfig, image_size=size))


def _recorded_row(monkeypatch, module, key, run):
    """Call ``module.CONFIGS[key]``'s thunk with ``module.classic_kfold``
    swapped for a recorder that runs ``run(args, kwargs)`` instead;
    returns (the protocol's arguments, the row)."""
    seen = []

    def record(*args, **kwargs):
        seen.append((args, {k: v for k, v in kwargs.items() if k != "device"}))
        return run(args, kwargs)

    monkeypatch.setattr(module, "classic_kfold", record)
    thunk = module.CONFIGS[key][1]
    row = thunk("cpu") if module is measure_accuracy else thunk()
    assert len(seen) == 1
    return seen[0], row


@pytest.mark.parametrize("key", CLASSIC_KEYS)
def test_classic_row_equals_the_references(key, monkeypatch):
    """The port's row runs the reference's protocol; at SMALL_SUBJECTS
    subjects and SMALL_SIZE its 10-fold accuracy equals the reference's
    exactly, with the same folds and the reference's fields."""
    port_classic = measure_accuracy.classic_kfold
    ref_classic = ref_measure.classic_kfold

    def small(args):
        return (args[0], SMALL_SUBJECTS, *args[2:])

    (port_args, port_kw), got = _recorded_row(
        monkeypatch, measure_accuracy, key,
        lambda a, kw: port_classic(*small(a), size=SMALL_SIZE, **kw))
    _small_reference(monkeypatch, SMALL_SIZE)
    (ref_args, ref_kw), want = _recorded_row(
        monkeypatch, ref_measure, key, lambda a, kw: ref_classic(*small(a), **kw))
    assert (port_args, port_kw) == (ref_args, ref_kw)
    assert measure_accuracy.CONFIGS[key][0] == ref_measure.CONFIGS[key][0]
    assert set(got) == set(want) == {"accuracy", "folds", "dataset", "seconds"}
    assert got["accuracy"] == want["accuracy"] and got["folds"] == want["folds"] == 10
    # the reference's string names 70x70 whatever size its patched data had
    assert got["dataset"] == want["dataset"].replace("70x70", "24x24")


def test_keys_and_row_fields_are_the_references():
    """``CONFIGS``' keys and result keys, the MEASURED block's labels and
    order, and the CNN row's fields (the reference's return dict, read
    from its source) against a tiny run of the port's."""
    assert {k: v[0] for k, v in measure_accuracy.CONFIGS.items()} == {
        k: v[0] for k, v in ref_measure.CONFIGS.items()}
    assert measure_accuracy.HARD_POSE == ref_measure.HARD_POSE
    assert measure_accuracy.HARD_WILD == ref_measure.HARD_WILD
    tree = ast.parse(_read(os.path.join(REPO, "scripts", "measure_accuracy.py")))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "cnn_verification")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    want = {k.value for k in ret.value.keys}
    data = (*make_synthetic_faces(4, 4, (32, 32), seed=11)[:2],
            *make_synthetic_faces(3, 4, (32, 32), seed=77)[:2])
    emb = gate_embedder.build_embedder(gate_embedder.build_parser().parse_args(
        ["--steps", "2", "--stage-features", "8,16", "--stage-blocks", "1,1",
         "--embed-dim", "16", "--batch-size", "8", "--input-size", "32"]), "cpu")
    stats = {}
    row = measure_accuracy.cnn_verification(2, "cpu", embedder=emb, data=data, stats=stats)
    assert set(row) == want
    assert row["accuracy"] == round(stats["accuracy"], 4)
    assert row["fold_min"] == round(min(stats["fold_accs"]), 4)


def _fixed_rows():
    """Rows as the tools return them, one per reference key."""
    rows = {}
    for i, (key, (rk, _)) in enumerate(sorted(ref_measure.CONFIGS.items())):
        rows[key] = {"accuracy": 0.9 + i / 100, "folds": 10, "dataset": f"synthetic {key}",
                     "seconds": 1.5 + i}
    rows["cnn"] = {**rows["cnn"], "std": 0.0021, "fold_min": 0.99, "threshold": 0.42}
    return rows


def _block(text, begin, end):
    return text[text.index(begin):text.index(end) + len(end)]


def _without_stamp(block):
    return [line for line in block.splitlines() if not line.startswith("Last refreshed")]


def test_measured_block_equals_the_references(tmp_path, monkeypatch):
    """The reference's ``main`` over fixed rows (its REPO and CACHE in
    ``tmp_path``) and the port's ``main --cache --baseline-md`` over the
    same rows write the same MEASURED block, stamp line excepted; the
    port's ``render_measured_block`` of the reference's cache gives it
    too, and a partial set of rows keeps the reference's order."""
    rows = _fixed_rows()
    ref_dir = tmp_path / "ref"
    (ref_dir / "scripts").mkdir(parents=True)
    shutil.copy(os.path.join(REPO, "BASELINE.md"), ref_dir / "BASELINE.md")
    monkeypatch.setattr(ref_measure, "REPO", str(ref_dir))
    monkeypatch.setattr(ref_measure, "CACHE", str(ref_dir / "scripts" / "cache.json"))
    monkeypatch.setattr(ref_measure, "CONFIGS", {
        k: (rk, functools.partial(dict, rows[k])) for k, (rk, _) in ref_measure.CONFIGS.items()})
    ref_measure.main([])
    ref_text = (ref_dir / "BASELINE.md").read_text()
    ref_cache = json.loads((ref_dir / "scripts" / "cache.json").read_text())

    port_md = tmp_path / "BASELINE.md"
    shutil.copy(os.path.join(REPO, "BASELINE.md"), port_md)
    monkeypatch.setattr(measure_accuracy, "CONFIGS", {
        k: (rk, lambda device, steps, k=k: dict(rows[k]))
        for k, (rk, _) in measure_accuracy.CONFIGS.items()})
    assert measure_accuracy.main(["--device", "cpu", "--cache", str(tmp_path / "c.json"),
                                  "--baseline-md", str(port_md)]) == 0
    port_text = port_md.read_text()
    begin, end = measure_accuracy.BEGIN, measure_accuracy.END
    assert _without_stamp(_block(port_text, begin, end)) == _without_stamp(
        _block(ref_text, begin, end))
    assert port_text.replace(_block(port_text, begin, end), "") == ref_text.replace(
        _block(ref_text, begin, end), "")
    assert _without_stamp(measure_accuracy.render_measured_block(ref_cache)) == _without_stamp(
        _block(ref_text, begin, end))
    some = {k: ref_cache[k] for k in ("lbph_lfw", "eigenfaces_orl", "_meta")}
    lines = measure_accuracy.render_measured_block(some).splitlines()
    assert [line.split(" | ")[0] for line in lines if line.startswith("| ") and "**" in line] == [
        "| Eigenfaces (PCA+NN) k-fold, ORL-analog",
        "| LBPH (SpatialHistogram r=2 + ChiSquare NN) k-fold, LFW-analog"]
    port_cache = json.loads((tmp_path / "c.json").read_text())
    assert set(port_cache) == set(ref_cache)
    for rk, row in ref_cache.items():
        assert set(port_cache[rk]) == set(row), rk


def test_cache_merge_keeps_unselected_rows_and_ignores_a_torn_cache(tmp_path, monkeypatch,
                                                                     capsys):
    rows = _fixed_rows()
    monkeypatch.setattr(measure_accuracy, "CONFIGS", {
        k: (rk, lambda device, steps, k=k: dict(rows[k]))
        for k, (rk, _) in measure_accuracy.CONFIGS.items()})
    cache = tmp_path / "cache.json"
    cache.write_text('{"eigenfaces_orl": {"accur')  # a run killed mid-write
    measure_accuracy.main(["--device", "cpu", "--only", "lbph", "--cache", str(cache)])
    assert "ignoring unreadable cache" in capsys.readouterr().err
    first = json.loads(cache.read_text())
    assert set(first) == {"lbph_lfw", "_meta"} and first["lbph_lfw"]["device"] == "cpu"
    rows["lbph"]["accuracy"] = 0.5
    measure_accuracy.main(["--device", "cpu", "--only", "eigenfaces", "--only", "cnn",
                           "--cache", str(cache)])
    second = json.loads(cache.read_text())
    assert set(second) == {"lbph_lfw", "eigenfaces_orl", "cnn_verification", "_meta"}
    assert second["lbph_lfw"] == first["lbph_lfw"]  # not selected: the cached row
    assert os.listdir(tmp_path) == ["cache.json"]  # atomic: no temporary left


# ---- the oracle ----

RNG = np.random.default_rng(7)


def test_oracle_functions_equal_the_references():
    x = RNG.uniform(0, 255, (3, 20, 22)).astype(np.float32)
    for radius in (2, 3):
        np.testing.assert_array_equal(oracle_parity.lbp_codes_np(x, radius=radius),
                                      ref_oracle.lbp_codes_np(x, radius=radius))
    codes = RNG.integers(0, 256, (2, 33, 35))
    for grid in ((4, 4), (6, 6)):
        np.testing.assert_array_equal(oracle_parity.spatial_hist_np(codes, grid=grid),
                                      ref_oracle.spatial_hist_np(codes, grid=grid))
    x = RNG.uniform(0, 255, (2, 40, 40)).astype(np.float32)
    np.testing.assert_allclose(oracle_parity.tan_triggs_np(x), ref_oracle.tan_triggs_np(x),
                               rtol=0, atol=1e-6)
    X = RNG.normal(size=(30, 50))
    mean_p, W_p = oracle_parity.pca_fit_np(X, 10)
    mean_r, W_r = ref_oracle.pca_fit_np(X, 10)
    np.testing.assert_allclose(mean_p, mean_r, atol=1e-12)
    assert np.linalg.norm(W_p @ W_p.T - W_r @ W_r.T) < 1e-8
    c, n_per, d = 4, 12, 64
    means = RNG.normal(size=(c, d)) * 3
    X = np.concatenate([means[i] + RNG.normal(size=(n_per, d)) for i in range(c)])
    y = np.repeat(np.arange(c), n_per)
    mean_p, W_p = oracle_parity.fisherfaces_fit_np(X, y)
    mean_r, W_r = ref_oracle.fisherfaces_fit_np(X, y)
    np.testing.assert_allclose(mean_p, mean_r, atol=1e-12)
    Q_p, Q_r = np.linalg.qr(W_p)[0], np.linalg.qr(W_r)[0]
    assert np.linalg.norm(Q_p @ Q_p.T - Q_r @ Q_r.T) < 1e-6
    test = RNG.normal(size=(9, d)) + means[y[:9] % c]
    for metric in ("euclidean", "chi_square", "cosine"):
        a, b = (np.abs(X), np.abs(test)) if metric == "chi_square" else (X, test)
        np.testing.assert_array_equal(oracle_parity.nn_classify_np(a, y, b, metric),
                                      ref_oracle.nn_classify_np(a, y, b, metric))
    assert oracle_parity.CONFIGS == ref_oracle.CONFIGS


KINDS = ["eigenfaces", "fisherfaces", "lbph", "lbp_fisherfaces"]


def _tiny_faces():
    """5 subjects x 6 faces at SMALL_SIZE with the hard axes on."""
    return make_synthetic_faces(num_subjects=5, per_subject=6, size=SMALL_SIZE, seed=2,
                                illumination=0.7, noise=14.0, **measure_accuracy.HARD_POSE)


def test_oracle_kfold_equals_the_references():
    X, y, _names = _tiny_faces()
    for kind in KINDS:
        assert oracle_parity.oracle_kfold(kind, X, y, 3) == ref_oracle.oracle_kfold(
            kind, X, y, 3), kind


@pytest.mark.parametrize("kind", ["eigenfaces", "lbph"])
def test_framework_kfold_equals_the_references(kind, monkeypatch):
    """The framework column: the port's trainer on the CPU against the
    reference's ``framework_kfold`` (the JAX trainer), 3-fold on the tiny
    faces. The other families' k-folds are held to the reference's through
    the classic rows above, on the same trainer."""
    X, y, names = _tiny_faces()
    got = oracle_parity.framework_kfold(kind, X, y, names, 3, device="cpu")
    _small_reference(monkeypatch, SMALL_SIZE)
    assert got == ref_oracle.framework_kfold(kind, X, y, names, 3)


def test_oracle_block_names_the_card_and_keeps_the_references_rows(tmp_path, monkeypatch):
    """The port's ``main`` over tiny rows writes the cache and the ORACLE
    block only where told; the block has the reference's rows, labels
    and order, its framework column named for the device."""
    monkeypatch.setattr(oracle_parity, "CONFIGS", {
        key: (kind, dict(kw, num_subjects=4, per_subject=4), 2)
        for key, (kind, kw, _k) in oracle_parity.CONFIGS.items()})
    md = tmp_path / "BASELINE.md"
    shutil.copy(os.path.join(REPO, "BASELINE.md"), md)
    cache = tmp_path / "oracle.json"
    argv = ["--device", "cpu", "--only", "lbph_easy", "--only", "eigenfaces_hard"]
    assert oracle_parity.main([*argv, "--cache", str(cache), "--baseline-md", str(md)]) == 0
    rows = json.loads(cache.read_text())
    assert set(rows) == {"lbph_easy", "eigenfaces_hard", "_meta"}
    for row in (rows["lbph_easy"], rows["eigenfaces_hard"]):
        assert set(row) == {"oracle", "oracle_s", "framework", "framework_s", "delta", "dataset"}
    block = _block(md.read_text(), oracle_parity.BEGIN, oracle_parity.END)
    lines = block.splitlines()
    assert "| Config | Protocol | Framework (cpu) | Oracle (NumPy/SciPy) | Delta |" in lines
    assert "TPU" not in block
    body = [line for line in lines if line.startswith("| ") and "**" in line]
    assert [line.split(" | ")[:2] for line in body] == [
        ["| Eigenfaces (PCA+NN)", "hard"], ["| LBPH (ExtendedLBP r=2 + ChiSquare NN)", "easy"]]
    old = _read(os.path.join(REPO, "BASELINE.md"))
    assert md.read_text().replace(block, "") == old.replace(
        _block(old, oracle_parity.BEGIN, oracle_parity.END), "")
    # --skip-framework keeps the cached framework column
    oracle_parity.main(["--device", "cpu", "--only", "lbph_easy", "--skip-framework",
                        "--cache", str(cache)])
    again = json.loads(cache.read_text())["lbph_easy"]
    assert again["framework"] == rows["lbph_easy"]["framework"]
    assert again["delta"] == rows["lbph_easy"]["delta"]


# ---- the gate ----


def _reference_flags():
    """{flag: default} of the reference gate's ``add_argument`` calls."""
    tree = ast.parse(_read(ref_gate_path))
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            default = next((ast.literal_eval(k.value) for k in node.keywords
                            if k.arg == "default"), None)
            flags[node.args[0].value] = default
    return flags


def _reference_row_fields():
    tree = ast.parse(_read(ref_gate_path))
    row = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "row")
    config = next(v for k, v in zip(row.keys, row.values) if k.value == "config")
    return [k.value for k in row.keys], [k.value for k in config.keys]


def test_gate_flags_are_the_references_plus_device_and_out():
    want = _reference_flags()
    ap = gate_embedder.build_parser()
    got = {a.option_strings[0]: a.default for a in ap._actions if a.option_strings
           and a.option_strings[0] != "-h"}
    assert got == {**want, "--device": "cuda", "--out": None}


GATE_SMALL = ["--stage-features", "8,16", "--stage-blocks", "1,1", "--embed-dim", "16",
              "--batch-size", "8", "--input-size", "32"]


def test_gate_row_has_the_references_fields_and_tag(tmp_path, monkeypatch, capsys):
    """At 2 steps on a tiny protocol: the reference's fields in its order,
    its default tag, the config; ``--out`` appends one line per run."""
    data = (*make_synthetic_faces(4, 4, (32, 32), seed=11)[:2],
            *make_synthetic_faces(3, 4, (32, 32), seed=77)[:2])
    monkeypatch.setattr(measure_accuracy, "hard_protocol", lambda: data)
    fields, config_fields = _reference_row_fields()
    out = tmp_path / "gate.jsonl"
    argv = ["--block", "dense", "--space-to-depth", "2", "--norm", "light", "--steps", "2",
            "--device", "cpu", *GATE_SMALL]
    row = gate_embedder.main([*argv, "--out", str(out)])
    assert list(row) == fields and list(row["config"]) == config_fields
    assert row["tag"] == "dense_s2d2_light"
    assert row["config"] == {"block": "dense", "space_to_depth": 2, "norm": "light",
                             "steps": 2, "stage_features": "8,16", "stage_blocks": "1,1",
                             "embed_dim": 16, "batch_size": 8, "learning_rate": 2e-3,
                             "seed": 3, "input_size": 32}
    assert json.loads(capsys.readouterr().out) == row
    assert abs(row["mean_minus_2std"] - (row["accuracy"] - 2 * row["std"])) <= 2e-4
    gate_embedder.main([*argv, "--tag", "again", "--out", str(out)])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["tag"] for r in lines] == ["dense_s2d2_light", "again"]


@pytest.mark.parametrize("variant", [["--block", "dense"], ["--space-to-depth", "2"],
                                     ["--norm", "light"]])
def test_gate_embedder_tree_equals_the_jax_embedders(variant):
    """The port's net from the gate's flags has the JAX ``CNNEmbedding``'s
    parameter tree for the same flags: the same paths and shapes."""
    import jax

    from opencv_facerecognizer_tpu.models.embedder import CNNEmbedding as JaxEmbedding
    from opencv_facerecognizer_tpu.models.embedder import init_embedder
    from opencv_facerecognizer_tpu_torch.utils.params import embedder_params_to_flax

    args = gate_embedder.build_parser().parse_args([*variant, *GATE_SMALL])
    port = gate_embedder.build_embedder(args, "cpu")
    ref = JaxEmbedding(
        embed_dim=args.embed_dim, input_size=(args.input_size, args.input_size),
        stem_features=32, stage_features=(8, 16), stage_blocks=(1, 1), block=args.block,
        space_to_depth=args.space_to_depth, norm=args.norm)
    want = jax.eval_shape(lambda: init_embedder(ref.net, 2, ref.input_size, 0))["net"]
    got = embedder_params_to_flax(port.net)

    def shapes(tree):
        return {jax.tree_util.keystr(path): tuple(np.shape(leaf))
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert shapes(got) == shapes(want)
    assert port.get_config() == ref.get_config() | {"train_steps": args.steps,
                                                     "batch_size": args.batch_size,
                                                     "learning_rate": args.learning_rate,
                                                     "seed": args.seed, "augment": True,
                                                     "lr_schedule": "cosine", "tta": True}


def test_no_tool_writes_a_file_unless_told(tmp_path, monkeypatch):
    """Each tool's ``main`` run in an empty directory leaves it empty, and
    ``BASELINE.md`` and ``scripts/`` as they were."""
    rows = _fixed_rows()
    monkeypatch.setattr(measure_accuracy, "CONFIGS", {
        k: (rk, lambda device, steps, k=k: dict(rows[k]))
        for k, (rk, _) in measure_accuracy.CONFIGS.items()})
    monkeypatch.setattr(oracle_parity, "CONFIGS", {
        key: (kind, dict(kw, num_subjects=4, per_subject=4), 2)
        for key, (kind, kw, _k) in oracle_parity.CONFIGS.items()})
    data = (*make_synthetic_faces(4, 4, (32, 32), seed=11)[:2],
            *make_synthetic_faces(3, 4, (32, 32), seed=77)[:2])
    monkeypatch.setattr(measure_accuracy, "hard_protocol", lambda: data)
    scripts = os.path.join(REPO, "scripts")

    def state():  # bytecode caches aside: another test process may write them
        return (sorted(f for f in os.listdir(scripts) if f != "__pycache__"),
                os.stat(os.path.join(REPO, "BASELINE.md")).st_mtime_ns)

    before = state()
    monkeypatch.chdir(tmp_path)
    assert measure_accuracy.main(["--device", "cpu"]) == 0
    assert oracle_parity.main(["--device", "cpu", "--only", "lbph_hard"]) == 0
    gate_embedder.main(["--steps", "1", "--device", "cpu", *GATE_SMALL])
    assert os.listdir(tmp_path) == []
    assert state() == before
