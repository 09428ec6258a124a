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
    assert len(mods) >= 31, mods
    for mod in ("opencv_facerecognizer_tpu_torch.parallel.quantizer",
                "opencv_facerecognizer_tpu_torch.ops.ivf_match",
                "opencv_facerecognizer_tpu_torch.utils._msgpack",
                "opencv_facerecognizer_tpu_torch.utils.serialization",
                "opencv_facerecognizer_tpu_torch.utils.dataset",
                "opencv_facerecognizer_tpu_torch.runtime.tracker",
                "opencv_facerecognizer_tpu_torch.apps.recognize", *DURABILITY_MODULES):
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

    for entry in (CNNFaceDetector, ShardedGallery, RecognitionPipeline,
                  device_mod.resolve_device, ivf_data_from_numpy, CNNEmbedding,
                  NearestNeighbor, load_model, CNNFaceDetector.load):
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
    from opencv_facerecognizer_tpu_torch.ops.sepblock import fused_sep_block
    from opencv_facerecognizer_tpu_torch.ops.streaming_match import streaming_match_topk

    meta = torch.device("meta")
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
