"""Build and load the port's CUDA kernels from the package's own sources.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so
         csrc/<name>.cu

The output lands in ``build/kernels/`` beside the package (listed in
``.gitignore``), keyed by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one loads at once. Nothing is built when
a module is imported: the first call of a kernel's wrapper on a CUDA
tensor builds it, or ``build_all()`` builds every kernel in parallel (one
``nvcc`` process per source) ahead of time. A failed build raises with the
compiler's output. ``-Xptxas -v`` prints each kernel's registers, shared
memory and spills into ``<name>-<hash>.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
KERNELS = ("streaming_match", "sepblock")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's kernels are compiled from csrc/ at first use")


def _source(name: str) -> Path:
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; known: {KERNELS}")
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where the build of ``name``'s current source lands."""
    digest = hashlib.sha256()
    digest.update(_source(name).read_bytes())
    digest.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str, out: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(_tmp_path(out)),
           str(_source(name))]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _tmp_path(out: Path) -> Path:
    return out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")


def _finish_build(name: str, out: Path, proc: subprocess.Popen) -> None:
    output, _ = proc.communicate()
    tmp = _tmp_path(out)
    out.with_suffix(".log").write_text(output)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n{output}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial .so


def build_all(names: Optional[Iterable[str]] = None) -> List[Path]:
    """Build every kernel whose current source has no library yet, one
    ``nvcc`` per source, all started together. Returns the libraries'
    paths; raises if any build failed."""
    names = list(KERNELS if names is None else names)
    outs = [library_path(n) for n in names]
    procs = [(n, o, _start_build(n, o)) for n, o in zip(names, outs)
             if not o.exists()]
    errors = []
    for name, out, proc in procs:
        try:
            _finish_build(name, out, proc)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) of ``name``'s last build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = library_path(name)
            if not out.exists():
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(out))
        return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero CUDA error code returned by a kernel's launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
