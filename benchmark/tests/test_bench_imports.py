"""The whole-name import check, and what the reference and a run load."""

import ast
import subprocess
import sys
from pathlib import Path

import run

BENCH = Path(__file__).resolve().parents[1]


def test_whole_top_level_names():
    assert run.forbidden_modules(["jax", "jax.numpy", "numpy"]) == ["jax"]
    assert run.forbidden_modules(["opencv_facerecognizer_tpu.ops.nms"]) == [
        "opencv_facerecognizer_tpu"]
    assert run.forbidden_modules(["opencv_facerecognizer_tpu_torch",
                                  "opencv_facerecognizer_tpu_torch.ops", "jaxtyping",
                                  "flaxen", "optax_torch"]) == []
    assert run.forbidden_modules(["flax.linen", "optax", "jaxlib.xla_client"]) == [
        "flax", "jaxlib", "optax"]


def test_reference_imports_nothing_of_the_system():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax",
                                   "opencv_facerecognizer_tpu",
                                   "opencv_facerecognizer_tpu_torch"), (path, name)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run, small; r = small.run(); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(run.FORBIDDEN)), "
            "r['forbidden'])" % (str(BENCH / "tests"), str(BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"
