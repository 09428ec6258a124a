"""The PyTorch port stands alone: importing any of its modules loads
neither JAX, flax, msgpack nor the JAX package (nor cv2 or PIL, which the
image reader imports only when a file needs them), its sources (and
``chip_smoke.py``) import none of the first four, and its entry points
run on the card by default and raise without one."""

import ast
import inspect
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "opencv_facerecognizer_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "opencv_facerecognizer_tpu"}
#: optional decoders the port imports only inside the functions that use them
LAZY = {"cv2", "PIL"}


def _port_modules():
    mods = []
    for root, _dirs, files in os.walk(PORT):
        for name in sorted(files):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, name), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_importing_the_port_loads_no_jax():
    # A subprocess: this test process already imported JAX (conftest).
    mods = _port_modules()
    assert len(mods) >= 33, mods
    for mod in ("opencv_facerecognizer_tpu_torch.parallel.quantizer",
                "opencv_facerecognizer_tpu_torch.ops.ivf_match",
                "opencv_facerecognizer_tpu_torch.utils._msgpack",
                "opencv_facerecognizer_tpu_torch.utils.serialization",
                "opencv_facerecognizer_tpu_torch.utils.dataset",
                "opencv_facerecognizer_tpu_torch.runtime.tracker",
                "opencv_facerecognizer_tpu_torch.apps.recognize",
                "opencv_facerecognizer_tpu_torch.utils.histogram",
                "opencv_facerecognizer_tpu_torch.models.cascade",
                "opencv_facerecognizer_tpu_torch.entry", *DURABILITY_MODULES,
                *OVERLOAD_MODULES, *INGEST_ROLLOUT_MODULES, *REPLICATION_MODULES,
                *MULTI_GPU_MODULES, *CHAOS_MODULES, *CLASSIC_MODULES, *TRAINING_MODULES,
                *ACCURACY_TOOL_MODULES):
        assert mod in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(set({sorted(FORBIDDEN | LAZY)!r}) & set(sys.modules))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


#: the crash-safe state slice's modules
DURABILITY_MODULES = ("opencv_facerecognizer_tpu_torch.runtime.faults",
                      "opencv_facerecognizer_tpu_torch.runtime.journal",
                      "opencv_facerecognizer_tpu_torch.runtime.state_store",
                      "opencv_facerecognizer_tpu_torch.runtime.registry",
                      "opencv_facerecognizer_tpu_torch.runtime.replication",
                      "opencv_facerecognizer_tpu_torch.runtime.resilience",
                      "opencv_facerecognizer_tpu_torch.utils.backend_probe")


#: the overload-control and observability slice's modules
OVERLOAD_MODULES = ("opencv_facerecognizer_tpu_torch.runtime.admission",
                    "opencv_facerecognizer_tpu_torch.runtime.batcher",
                    "opencv_facerecognizer_tpu_torch.runtime.expo",
                    "opencv_facerecognizer_tpu_torch.runtime.fakes",
                    "opencv_facerecognizer_tpu_torch.runtime.promtext",
                    "opencv_facerecognizer_tpu_torch.runtime.slo",
                    "opencv_facerecognizer_tpu_torch.utils.tracing")


#: the ingest and embedder-rollout slice's modules
INGEST_ROLLOUT_MODULES = ("opencv_facerecognizer_tpu_torch.runtime.ingest",
                          "opencv_facerecognizer_tpu_torch.runtime.rollout")

#: the cascade and registry slice's modules
CASCADE_REGISTRY_MODULES = ("opencv_facerecognizer_tpu_torch.models.cascade",
                            "opencv_facerecognizer_tpu_torch.runtime.registry")


#: the replication, router and verifier slice's modules
REPLICATION_MODULES = ("opencv_facerecognizer_tpu_torch.runtime.replication",
                       "opencv_facerecognizer_tpu_torch.runtime.connector",
                       "opencv_facerecognizer_tpu_torch.runtime.faults",
                       "opencv_facerecognizer_tpu_torch.apps.recognize",
                       "opencv_facerecognizer_tpu_torch.apps.verify_checkpoint")


#: the multi-GPU slice's modules
MULTI_GPU_MODULES = ("opencv_facerecognizer_tpu_torch.parallel",
                     "opencv_facerecognizer_tpu_torch.parallel.mesh",
                     "opencv_facerecognizer_tpu_torch.parallel.pp",
                     "opencv_facerecognizer_tpu_torch.parallel.gallery",
                     "opencv_facerecognizer_tpu_torch.parallel.pipeline",
                     "opencv_facerecognizer_tpu_torch.parallel.train",
                     "opencv_facerecognizer_tpu_torch.entry")


#: the chaos soak slice's modules
CHAOS_MODULES = ("opencv_facerecognizer_tpu_torch.runtime.faults",
                 "opencv_facerecognizer_tpu_torch.runtime.batcher",
                 "opencv_facerecognizer_tpu_torch.runtime.recognizer",
                 "opencv_facerecognizer_tpu_torch.runtime.fakes",
                 "opencv_facerecognizer_tpu_torch.utils.metric_names",
                 "opencv_facerecognizer_tpu_torch.utils.metrics",
                 "opencv_facerecognizer_tpu_torch.utils.debug_lock",
                 "opencv_facerecognizer_tpu_torch.apps.chaos_soak")


#: the ocvf-train slice's modules: the embedder variants, the classic
#: models and the classic trainer with its CLI
CLASSIC_MODULES = ("opencv_facerecognizer_tpu_torch.models.embedder",
                   "opencv_facerecognizer_tpu_torch.models.feature",
                   "opencv_facerecognizer_tpu_torch.models.classifier",
                   "opencv_facerecognizer_tpu_torch.models.operators",
                   "opencv_facerecognizer_tpu_torch.ops.image",
                   "opencv_facerecognizer_tpu_torch.ops.lbp",
                   "opencv_facerecognizer_tpu_torch.ops.histogram",
                   "opencv_facerecognizer_tpu_torch.ops.distance",
                   "opencv_facerecognizer_tpu_torch.ops.linalg",
                   "opencv_facerecognizer_tpu_torch.utils.dataset",
                   "opencv_facerecognizer_tpu_torch.utils.validation",
                   "opencv_facerecognizer_tpu_torch.utils.verification",
                   "opencv_facerecognizer_tpu_torch.utils.visual",
                   "opencv_facerecognizer_tpu_torch.utils.serialization",
                   "opencv_facerecognizer_tpu_torch.utils.stage_clock",
                   "opencv_facerecognizer_tpu_torch.utils.params",
                   "opencv_facerecognizer_tpu_torch.runtime.trainer",
                   "opencv_facerecognizer_tpu_torch.apps.train")


def _imported_top_names(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    paths = [os.path.join(root, f) for root, _d, files in os.walk(PORT)
             for f in files if f.endswith(".py")]
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    offenders = {p: sorted(FORBIDDEN & set(_imported_top_names(p))) for p in paths}
    assert not {p: b for p, b in offenders.items() if b}, offenders


def test_entry_points_default_to_the_card():
    from opencv_facerecognizer_tpu_torch.models.detector import CNNFaceDetector
    from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery
    from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline
    from opencv_facerecognizer_tpu_torch.utils import device as device_mod
    from opencv_facerecognizer_tpu_torch.utils.params import ivf_data_from_numpy

    from opencv_facerecognizer_tpu_torch.apps.recognize import build_parser
    from opencv_facerecognizer_tpu_torch.models.classifier import NearestNeighbor
    from opencv_facerecognizer_tpu_torch.models.embedder import CNNEmbedding
    from opencv_facerecognizer_tpu_torch.utils.serialization import load_model
    from opencv_facerecognizer_tpu_torch.entry import dryrun_multichip
    from opencv_facerecognizer_tpu_torch.entry import entry as port_entry

    for entry in (CNNFaceDetector, ShardedGallery, RecognitionPipeline,
                  device_mod.resolve_device, ivf_data_from_numpy, CNNEmbedding,
                  NearestNeighbor, load_model, CNNFaceDetector.load, port_entry,
                  dryrun_multichip):
        assert inspect.signature(entry).parameters["device"].default == "cuda", entry
    assert device_mod.DEFAULT_DEVICE == "cuda"
    assert build_parser().get_default("device") == "cuda"


def test_no_card_raises(monkeypatch):
    from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery
    from opencv_facerecognizer_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedGallery(8, 4)  # default device: the card
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """A wrapper never falls back quietly: a tensor neither on the CPU nor
    on a CUDA card is refused."""
    from opencv_facerecognizer_tpu_torch.ops.nms import nms_mask
    from opencv_facerecognizer_tpu_torch.ops.sepblock import fused_sep_block
    from opencv_facerecognizer_tpu_torch.ops.streaming_match import streaming_match_topk

    meta = torch.device("meta")
    with pytest.raises(ValueError):
        nms_mask(torch.empty(2, 8, 4, device=meta), torch.empty(2, 8, device=meta))
    with pytest.raises(ValueError):
        streaming_match_topk(torch.empty(4, 16, device=meta),
                             torch.empty(8, 16, device=meta),
                             torch.empty(8, dtype=torch.bool, device=meta))
    with pytest.raises(ValueError):
        fused_sep_block(torch.empty(1, 4, 4, 8, device=meta),
                        torch.empty(8, 1, 3, 3), torch.empty(8), torch.empty(8),
                        torch.empty(8, 8, 1, 1), torch.empty(8), torch.empty(8))


@pytest.mark.parametrize("mod", DURABILITY_MODULES)
def test_durability_module_imports_only_the_port(mod):
    """Each module of the crash-safe state imports no JAX, flax or JAX
    package, and keeps its own copies (it names nothing of the JAX
    package)."""
    path = os.path.join(REPO, *mod.split(".")) + ".py"
    names = set(_imported_top_names(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "opencv_facerecognizer_tpu." not in open(path).read()


def test_state_dir_cli_without_a_card_raises_and_releases_the_lease(tmp_path, monkeypatch):
    """``--state-dir`` does not change the device rule: without a card the
    CLI raises, and the writer lease it took is released again."""
    from opencv_facerecognizer_tpu_torch.apps.recognize import main
    from opencv_facerecognizer_tpu_torch.runtime.replication import WriterLease

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--model", "m", "--detector", "d", "--gallery", "g", "--source", "dir",
              "--dir", "f", "--state-dir", str(tmp_path)])
    WriterLease(str(tmp_path)).acquire().release()


@pytest.mark.parametrize("mod", OVERLOAD_MODULES)
def test_overload_module_imports_only_the_port(mod):
    """The host-only modules of the overload and observability slice keep
    their own copies: no JAX, no flax, nothing of the JAX package."""
    path = os.path.join(REPO, *mod.split(".")) + ".py"
    names = set(_imported_top_names(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "opencv_facerecognizer_tpu." not in open(path).read()


@pytest.mark.parametrize("mod", CASCADE_REGISTRY_MODULES)
def test_cascade_registry_module_imports_only_the_port(mod):
    """The stage-1 gate and the registry's swaps keep their own copies: no
    JAX, no flax, nothing of the JAX package."""
    path = os.path.join(REPO, *mod.split(".")) + ".py"
    names = set(_imported_top_names(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "opencv_facerecognizer_tpu." not in open(path).read()


@pytest.mark.parametrize("mod", REPLICATION_MODULES)
def test_replication_module_imports_only_the_port(mod):
    """The replicas, the router, the transports and the offline verifier
    keep their own copies: no JAX, no flax, nothing of the JAX package."""
    path = os.path.join(REPO, *mod.split(".")) + ".py"
    names = set(_imported_top_names(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "opencv_facerecognizer_tpu." not in open(path).read()


def test_reader_cli_without_a_card_raises_and_writes_nothing(tmp_path, monkeypatch):
    """A reader raises without a card like any entry point, and takes no
    lease: a writer can start on the dir at once."""
    from opencv_facerecognizer_tpu_torch.apps.recognize import main
    from opencv_facerecognizer_tpu_torch.runtime.replication import WriterLease

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--model", "m", "--detector", "d", "--gallery", "g", "--source", "dir",
              "--dir", "f", "--state-dir", str(tmp_path), "--replica-role", "reader"])
    assert os.listdir(tmp_path) == []
    WriterLease(str(tmp_path)).acquire().release()


@pytest.mark.parametrize("mod", MULTI_GPU_MODULES)
def test_multi_gpu_module_imports_only_the_port(mod):
    """The mesh, the sharded gallery, the two-stage pipeline, the sharded
    training step and the dryrun keep their own copies: no JAX, no flax,
    nothing of the JAX package."""
    parts = mod.split(".")
    path = os.path.join(REPO, *parts) + ".py"
    if not os.path.exists(path):
        path = os.path.join(REPO, *parts, "__init__.py")
    names = set(_imported_top_names(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "opencv_facerecognizer_tpu." not in open(path).read()


def test_make_mesh_and_the_pp_pipeline_default_to_the_card(monkeypatch):
    """``make_mesh`` lays its mesh over the cards unless given devices,
    and raises without one; ``split_mesh``, ``TwoStagePipeline`` and
    ``ShardedArcFaceStep`` load lazily from ``parallel``."""
    import opencv_facerecognizer_tpu_torch.parallel as parallel
    from opencv_facerecognizer_tpu_torch.parallel import pp, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        parallel.make_mesh()
    assert parallel.split_mesh is pp.split_mesh
    assert parallel.TwoStagePipeline is pp.TwoStagePipeline
    assert parallel.ShardedArcFaceStep is train.ShardedArcFaceStep
    with pytest.raises(AttributeError):
        parallel.NoSuchThing  # noqa: B018


@pytest.mark.parametrize("mod", CHAOS_MODULES)
def test_chaos_module_imports_only_the_port(mod):
    """Each module of the chaos soak slice imports no JAX, flax or JAX
    package (its own copies: the fakes, the lock monitor, the names)."""
    path = os.path.join(REPO, *mod.split(".")) + ".py"
    names = set(_imported_top_names(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "opencv_facerecognizer_tpu." not in open(path).read()


def test_chaos_soak_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """``--device`` defaults to cuda: without a card every scenario exits
    with the missing card, never a quiet CPU run; so do the Python entry
    points of the card's stack."""
    from opencv_facerecognizer_tpu_torch.apps import chaos_soak

    for fn in (chaos_soak.build_stack, chaos_soak.run_soak):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for scenario in ("soak", "video"):
        with pytest.raises(RuntimeError, match="cuda"):
            chaos_soak.main(["--scenario", scenario, "--seconds", "0.1", "--seed", "7"])
    with pytest.raises(RuntimeError, match="cuda"):
        chaos_soak.build_stack()


def test_metric_names_equal_the_references_but_two():
    """``utils/metric_names.py`` holds the reference's names, less
    ``cpu_fallbacks`` (no CPU fallback: ROADMAP C.7) and plus the port's
    ``replication_install_errors`` (C.15); ``utils.metrics`` re-exports
    the same objects, so the list lives once."""
    import importlib.util

    from opencv_facerecognizer_tpu_torch.utils import metric_names, metrics

    spec = importlib.util.spec_from_file_location(
        "ref_metric_names", os.path.join(REPO, "opencv_facerecognizer_tpu", "utils",
                                         "metric_names.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    got = set(metric_names.all_names())
    want = set(ref.all_names())
    assert want - got == {"cpu_fallbacks"}
    assert got - want == {"replication_install_errors"}
    assert metric_names.all_prefixes() == ref.all_prefixes()
    assert len(metric_names.all_names()) == len(got)  # no name registered twice
    for table in ("LEDGER_COMPLETION_COUNTERS", "LEDGER_DROP_COUNTERS", "PROM_FOLDED_PREFIXES"):
        assert getattr(metric_names, table) == getattr(ref, table)
        assert getattr(metrics, table) is getattr(metric_names, table)
    for name in dir(metric_names):
        if name.isupper():
            assert getattr(metrics, name) is getattr(metric_names, name), name
    source = open(os.path.join(PORT, "utils", "metrics.py")).read()
    assert not any(line.split("=")[0].strip().isupper() and "= \"" in line
                   for line in source.splitlines()), "a name is defined in metrics.py too"


@pytest.mark.parametrize("mod", CLASSIC_MODULES)
def test_classic_module_imports_only_the_port(mod):
    """The ocvf-train slice keeps its own copies (the numpy dataset and
    validation code among them): no JAX, flax or optax, nothing of the
    JAX package, and matplotlib only inside the functions that draw."""
    path = os.path.join(REPO, *mod.split(".")) + ".py"
    names = set(_imported_top_names(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "opencv_facerecognizer_tpu." not in open(path).read()
    tree = ast.parse(open(path).read())
    top = {a.name.split(".")[0] for node in tree.body if isinstance(node, ast.Import)
           for a in node.names}
    top |= {node.module.split(".")[0] for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.module}
    assert "matplotlib" not in top


def test_classic_entry_points_default_to_the_card_and_raise_without_one(tmp_path, monkeypatch):
    from opencv_facerecognizer_tpu_torch.apps import train as train_app
    from opencv_facerecognizer_tpu_torch.models import classifier, feature
    from opencv_facerecognizer_tpu_torch.runtime import trainer

    entries = (trainer.TheTrainer, trainer.select_model, feature.PCA, feature.LDA,
               feature.Fisherfaces, feature.SpatialHistogram, feature.TanTriggsPreprocessing,
               feature.Identity, feature.Resize, feature.HistogramEqualization,
               feature.MinMaxNormalize, feature.as_row_matrix, classifier.SVM,
               classifier.KernelSVM)
    for entry in entries:
        assert inspect.signature(entry).parameters["device"].default == "cuda", entry
    assert train_app.build_parser().get_default("device") == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.TheTrainer()
    with pytest.raises(RuntimeError, match="cuda"):
        feature.Fisherfaces()
    with pytest.raises(RuntimeError, match="cuda"):
        train_app.main([str(tmp_path), str(tmp_path / "m.ckpt")])


#: the training slice's modules: ArcFace, detector and gate training, the
#: CNN half of the trainer, the accuracy protocol and the timing instrument
TRAINING_MODULES = ("opencv_facerecognizer_tpu_torch.models._train",
                    "opencv_facerecognizer_tpu_torch.models.embedder",
                    "opencv_facerecognizer_tpu_torch.models.detector",
                    "opencv_facerecognizer_tpu_torch.models.cascade",
                    "opencv_facerecognizer_tpu_torch.runtime.trainer",
                    "opencv_facerecognizer_tpu_torch.apps.train",
                    "opencv_facerecognizer_tpu_torch.apps.measure_accuracy",
                    "opencv_facerecognizer_tpu_torch.utils.benchtime",
                    "opencv_facerecognizer_tpu_torch.utils.params")


@pytest.mark.parametrize("mod", TRAINING_MODULES)
def test_training_module_imports_only_the_port(mod):
    """No JAX, flax or optax (the port's Adam and cosine decay are its
    own), nothing of the JAX package."""
    path = os.path.join(REPO, *mod.split(".")) + ".py"
    names = set(_imported_top_names(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "opencv_facerecognizer_tpu." not in open(path).read()


def test_training_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    import numpy as np

    from opencv_facerecognizer_tpu_torch.apps import measure_accuracy
    from opencv_facerecognizer_tpu_torch.models import cascade, detector, embedder
    from opencv_facerecognizer_tpu_torch.utils import benchtime

    for entry in (embedder.CNNEmbedding, detector.CNNFaceDetector, cascade.FaceGate,
                  measure_accuracy.hard_embedder, measure_accuracy.cnn_verification):
        assert inspect.signature(entry).parameters["device"].default == "cuda", entry
    with pytest.raises(ValueError, match="CUDA tensor"):
        benchtime.scalar_chain_ms(lambda x: x.sum(), (torch.ones(3),))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: embedder.CNNEmbedding(), lambda: detector.CNNFaceDetector(),
                  lambda: cascade.FaceGate(), lambda: measure_accuracy.cnn_verification(3),
                  lambda: measure_accuracy.main(["--steps", "3"])):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    # the trainers run where their net lives: a CPU net trains on the CPU only
    net = embedder.FaceEmbedNet(embed_dim=8, stem_features=4, stage_features=(4, 8),
                                stage_blocks=(1, 1), input_size=(16, 16))
    head = embedder.train_embedder(net, embedder.draw_head(2, 8, 0),
                                   np.zeros((4, 16, 16), np.float32), [0, 1, 0, 1], steps=1)
    assert head.device.type == "cpu"


#: the accuracy tools: the seven rows, the oracle column, the embedder gate
ACCURACY_TOOL_MODULES = ("opencv_facerecognizer_tpu_torch.apps.measure_accuracy",
                         "opencv_facerecognizer_tpu_torch.apps.oracle_parity",
                         "opencv_facerecognizer_tpu_torch.apps.gate_embedder",
                         "opencv_facerecognizer_tpu_torch.apps.explore_perf",
                         "opencv_facerecognizer_tpu_torch.apps.explore_fisherfaces")


@pytest.mark.parametrize("mod", ACCURACY_TOOL_MODULES)
def test_accuracy_tool_imports_only_the_port(mod):
    """No JAX, flax or optax, nothing of the JAX package, and nothing of
    the reference's ``scripts/`` (the oracle is the port's own copy)."""
    path = os.path.join(REPO, *mod.split(".")) + ".py"
    source = open(path).read()
    names = set(_imported_top_names(path))
    assert not names & (FORBIDDEN | {"scripts"}), names & (FORBIDDEN | {"scripts"})
    assert "opencv_facerecognizer_tpu." not in source
    assert "spec_from_file_location" not in source and "sys.path" not in source


def test_accuracy_tools_default_to_the_card_and_raise_without_one(monkeypatch):
    from opencv_facerecognizer_tpu_torch.apps import gate_embedder, measure_accuracy, oracle_parity

    for fn in (measure_accuracy.classic_kfold, measure_accuracy.cnn_verification,
               oracle_parity.framework_kfold, oracle_parity.parity_row,
               gate_embedder.build_embedder):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert gate_embedder.build_parser().get_default("device") == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((measure_accuracy.main, []), (oracle_parity.main, []),
                       (gate_embedder.main, [])):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        measure_accuracy.classic_kfold("eigenfaces", 2, 2, 2)


def test_exploration_apps_default_to_the_card_and_raise_without_one(monkeypatch):
    from opencv_facerecognizer_tpu_torch.apps import explore_fisherfaces, explore_perf

    for fn in (explore_perf.detector_variants, explore_perf.embedder_variants,
               explore_perf.embedder_net, explore_fisherfaces.run_candidate):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (explore_perf.detector_variants, explore_perf.embedder_variants,
               explore_perf.main, explore_fisherfaces.main):
        with pytest.raises(RuntimeError, match="cuda"):
            fn([]) if fn.__name__ == "main" else fn()
    with pytest.raises(RuntimeError, match="cuda"):
        explore_fisherfaces.run_candidate("baseline_fisher_nn",
                                          explore_fisherfaces.candidates()["baseline_fisher_nn"])
