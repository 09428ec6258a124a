"""No host sync on the graphed serving step: an AST scan of the modules
the step runs through, in place of the ``ocvf-lint`` host-sync rules
(which scan the JAX package only).

Inside any function of these modules, a call of ``.item()``, ``.cpu()``,
``.tolist()``, ``.numpy()`` or ``synchronize`` waits for the card, a
``.query()`` asks it (an event query: no wait, but a CUDA runtime call), and
``torch.tensor(..., device=...)`` copies from pageable host memory; both
are illegal while a CUDA graph captures the step and stall the host when
it runs eagerly. Host-only helpers that never run on the step are
allowed by name, each with its reason."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "opencv_facerecognizer_tpu_torch")
STEP_MODULES = ("parallel/pipeline.py", "models/detector.py", "models/embedder.py",
                "models/cascade.py", "models/_layers.py", "ops/image.py", "ops/nms.py",
                "ops/streaming_match.py", "ops/sepblock.py", "ops/ivf_match.py",
                "utils/tracing.py", "runtime/ingest.py", "parallel/pp.py",
                "parallel/mesh.py")
#: the serving loop's functions that emit spans or run the overload
#: control around the step: host timestamps only, never a wait for the card
#: (the one wait stays the readback's, in ``_Readback`` and the worker)
RECOGNIZER_SPAN_CODE = (
    "RecognizerService._on_frame", "RecognizerService._intake_frame",
    "RecognizerService._serve_one", "RecognizerService._dispatch_with_retry",
    "RecognizerService._complete_head", "RecognizerService._publish",
    "RecognizerService._dead_letter", "RecognizerService._trace_settle",
    "RecognizerService._set_brownout", "RecognizerService._note_queue_wait",
    "RecognizerService._note_recompile", "RecognizerService._observe_e2e",
    "RecognizerService._complete_cached", "RecognizerService._serve_loop",
    "RecognizerService._intake_decoded", "RecognizerService._decode_failed",
    "RecognizerService._cascade_keep_mask", "RecognizerService._complete_empty")
SYNC_ATTRS = {"item", "cpu", "tolist", "numpy", "synchronize", "query"}
#: (module, qualified function) -> why it may wait for the card
ALLOWED = {
    ("parallel/pipeline.py", "RecognitionPipeline.prewarm_batch_shapes"):
        "warmup, before serving: it waits for each rung's capture to land",
    ("parallel/pp.py", "TwoStagePipeline.prewarm_capacity"):
        "the gallery's grow hook, off the serving path: it waits for stage B at the new tier",
    ("models/detector.py", "CNNFaceDetector.detect"):
        "the one-image host API (Python box tuples), never on the batched step",
    ("models/cascade.py", "evaluate_gate"):
        "the offline operating-point measurement against the detector's verdicts",
    ("runtime/recognizer.py", "RecognizerService._cascade_keep_mask"):
        "the cascade's designed decision readback (the reference's): the [B] stage-1 "
        "scores decide whether the full step runs at all; once per scored batch",
    ("models/embedder.py", "CNNEmbedding.get_state"):
        "the checkpoint writer: parameters to numpy",
    ("models/embedder.py", "CNNEmbedding.compute"):
        "training, never on the step: the trained ArcFace head to the host once, after the "
        "last step",
    ("models/detector.py", "_host"):
        "evaluate_detector's offline matching loop on the host (the reference's): one "
        "chunk's detections to numpy",
    ("runtime/ingest.py", "StagingRing._alloc"):
        "ring construction and outage heals: the numpy view of a pinned host tensor",
    ("runtime/ingest.py", "StagingRing._sweep_fenced_locked"):
        "the release path: a parked buffer's upload event, queried, never waited on",
    ("runtime/ingest.py", "StagingRing.release"):
        "the release path: the released buffer's upload event, queried, never waited on",
    ("parallel/mesh.py", "_Comm.exchange"):
        "the pp hop between processes over gloo, which sends only host tensors (its send "
        "of a card tensor aborts the process): the transport's staging, on the eager pp "
        "step (it captures no graph), never over nccl",
    ("parallel/mesh.py", "_Comm._sync"):
        "measurement only: with ``sync_timing`` set (off by default) a collective's "
        "seconds are timed to its end on the card",
}


def _syncs(path):
    """(qualified function, what, line) of every host sync in ``path``."""
    tree = ast.parse(open(path).read(), filename=path)
    found = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                visit(child, scope + [child.name])
                continue
            if isinstance(child, ast.Call) and scope:
                f = child.func
                if isinstance(f, ast.Attribute) and f.attr in SYNC_ATTRS:
                    found.append((".".join(scope), f".{f.attr}()", child.lineno))
                elif (isinstance(f, ast.Attribute) and f.attr == "tensor"
                      and isinstance(f.value, ast.Name) and f.value.id == "torch"
                      and any(k.arg == "device" for k in child.keywords)):
                    found.append((".".join(scope), "torch.tensor(device=)", child.lineno))
            visit(child, scope)

    visit(tree, [])
    return found


@pytest.mark.parametrize("module", STEP_MODULES)
def test_step_module_has_no_host_sync(module):
    offenders = [(fn, what, line) for fn, what, line in _syncs(os.path.join(PORT, module))
                 if fn and (module, fn) not in ALLOWED]
    assert not offenders, f"{module}: host syncs on the step: {offenders}"


def test_allowlist_names_live_functions():
    """Every allowed function exists and still syncs (a stale entry would
    hide a new sync under an old name)."""
    for (module, fn), reason in ALLOWED.items():
        assert reason
        assert fn in {f for f, _w, _l in _syncs(os.path.join(PORT, module))}, (module, fn)


def test_the_scan_finds_what_it_looks_for(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import torch\n"
                   "class A:\n"
                   "    def f(self, x):\n"
                   "        def g():\n"
                   "            return x.item()\n"
                   "        torch.cuda.synchronize()\n"
                   "        return torch.tensor([1.0], device=x.device), x.cpu(), g\n"
                   "def h(x):\n"
                   "    return x.tolist(), x.numpy()\n")
    got = {(fn, what) for fn, what, _line in _syncs(str(src))}
    assert got == {("A.f.g", ".item()"), ("A.f", ".synchronize()"),
                   ("A.f", "torch.tensor(device=)"), ("A.f", ".cpu()"),
                   ("h", ".tolist()"), ("h", ".numpy()")}


def _functions(path):
    """Qualified name -> AST node of every function in ``path``."""
    tree = ast.parse(open(path).read(), filename=path)
    out = {}

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                name = ".".join(scope + [child.name])
                if not isinstance(child, ast.ClassDef):
                    out[name] = child
                visit(child, scope + [child.name])

    visit(tree, [])
    return out


@pytest.mark.parametrize("fn", RECOGNIZER_SPAN_CODE)
def test_recognizer_span_code_has_no_host_sync(fn):
    """None, but in an allowed function its one named sync (ALLOWED)."""
    path = os.path.join(PORT, "runtime/recognizer.py")
    assert fn in _functions(path), fn
    offenders = [(f, what, line) for f, what, line in _syncs(path)
                 if f == fn or f.startswith(fn + ".")]
    if ("runtime/recognizer.py", fn) in ALLOWED:
        assert len(offenders) == 1, f"{fn} may sync once, not {offenders}"
        offenders = []
    assert not offenders, f"host syncs in {fn}: {offenders}"
