"""Deadline-bounded probe of the card: port of
``opencv_facerecognizer_tpu/utils/backend_probe.py``.

The probe runs in a subprocess with a deadline, so a CUDA runtime that
hangs in its initialization costs the caller one timeout, never a wedge. The
child imports ``torch``, checks ``torch.cuda.is_available()`` and the
device count, and runs one operation on the card; its exit code is the
verdict (0 usable, 3 too few devices, 4 no card at all; any other code
means the initialization or the first operation raised).

"Usable" means the card answers. The reference's ``OCVF_DRYRUN_FORCE_CPU``
override, which reports the backend unusable to send callers to their
CPU fallback, is not ported: the port has no CPU fallback (ROADMAP C).
"""

from __future__ import annotations

import os
import subprocess
import sys

TIMEOUT_ENV = "OCVF_BACKEND_PROBE_TIMEOUT_S"
DEFAULT_TIMEOUT_S = 60.0
#: the degraded-mode probe's shorter deadline: the serving loop is already
#: failing, so a quick verdict beats a precise one
RECOVERY_TIMEOUT_ENV = "OCVF_RECOVERY_PROBE_TIMEOUT_S"
DEFAULT_RECOVERY_TIMEOUT_S = 15.0

# the child's exit codes (anything else: initialization or the op raised)
_RC_OK = 0
_RC_TOO_FEW_DEVICES = 3
_RC_CPU_FALLBACK = 4


def _probe_source(min_devices: int) -> str:
    """The child: the card present, enough devices, one op that completes."""
    return "\n".join([
        "import sys",
        "import torch",
        "if not torch.cuda.is_available():",
        f"    sys.exit({_RC_CPU_FALLBACK})",
        f"if torch.cuda.device_count() < {int(min_devices)}:",
        f"    sys.exit({_RC_TOO_FEW_DEVICES})",
        "(torch.zeros((), device='cuda') + 1).item()",
        f"sys.exit({_RC_OK})",
    ]) + "\n"


def _timeout_from_env(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def probe_default_backend(min_devices: int = 1, timeout_s: float | None = None,
                          probe_source: str | None = None) -> tuple[bool, str]:
    """``(usable, reason)`` for the card, never hanging. ``probe_source``
    replaces the child program (tests inject a sleeping child)."""
    if timeout_s is None:
        timeout_s = _timeout_from_env(TIMEOUT_ENV, DEFAULT_TIMEOUT_S)
    source = probe_source if probe_source is not None else _probe_source(min_devices)
    try:
        proc = subprocess.run([sys.executable, "-c", source], stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False, f"probe exceeded {timeout_s:.0f}s deadline (backend hang-mode)"
    except OSError as exc:
        return False, f"probe spawn failed: {exc}"
    if proc.returncode == _RC_OK:
        return True, "ok"
    if proc.returncode == _RC_TOO_FEW_DEVICES:
        return False, f"backend has fewer than {min_devices} devices"
    if proc.returncode == _RC_CPU_FALLBACK:
        return False, "no CUDA device (torch.cuda.is_available() is false)"
    return False, f"backend init/first-op failed (probe rc={proc.returncode})"


def probe_for_recovery(timeout_s: float | None = None,
                       probe_source: str | None = None) -> tuple[bool, str]:
    """The degraded-mode check of the serving loop: the same probe with
    the shorter deadline (``OCVF_RECOVERY_PROBE_TIMEOUT_S``, else 15 s)."""
    if timeout_s is None:
        timeout_s = _timeout_from_env(RECOVERY_TIMEOUT_ENV, DEFAULT_RECOVERY_TIMEOUT_S)
    return probe_default_backend(timeout_s=timeout_s, probe_source=probe_source)
