"""The port's ``runtime.faults.FaultInjector`` against the JAX package's:
with the same seed, rates and sequence of crossings both return the same
outputs and the same ``summary()``, at every boundary, scripted or drawn.
Both draw from ``random.Random(seed)``, so equality is exact. Plus the
readback wrappers, in the port's readback interface (``pending``,
``ready``, ``wait``, ``result``): a stuck one never materializes and
never blocks."""

import random

import numpy as np
import pytest

from opencv_facerecognizer_tpu.runtime import faults as jax_faults
from opencv_facerecognizer_tpu_torch.runtime import faults as port_faults
from opencv_facerecognizer_tpu_torch.runtime.fakes import FakePacked

PKGS = {"jax": jax_faults, "torch": port_faults}
#: the stalls of slow faults, zeroed: the draws are what is compared
NO_STALLS = dict(slow_decode_s=0.0, slow_fsync_s=0.0)
MSG = {"__frame__": "AAAA", "shape": [2, 2], "dtype": "uint8", "meta": {"seq": 5}}
ALL_RATES = {
    "receive": {"drop": 0.1, "duplicate": 0.1, "corrupt": 0.1, "flood": 0.1},
    "put": {"corrupt": 0.3},
    "dispatch": {"unavailable": 0.3},
    "readback": {"stuck": 0.2, "slow": 0.2},
    "cascade": {"reject_all": 0.3},
    "decode": {"slow": 0.2, "corrupt": 0.2},
    "wal": {"torn": 0.1, "crash": 0.1},
    "checkpoint": {"torn": 0.1, "crash": 0.1, "late": 0.1},
    "stage": {"torn": 0.1, "crash": 0.1},
    "cutover": {"crash_before_record": 0.1, "crash_after_record": 0.1},
    "storage": {"enospc": 0.1, "eio": 0.1, "slow_fsync": 0.1, "read_error": 0.2},
    "transport": {"drop": 0.1, "duplicate": 0.1, "reorder": 0.1},
}
CROSSINGS = ("receive", "put", "dispatch", "readback", "cascade", "decode", "wal",
             "checkpoint", "stage", "cutover", "storage", "storage_read", "transport")


def _cross(fi, boundary, i):
    """One crossing, reduced to a package-neutral value."""
    if boundary == "receive":
        return ("receive", fi.on_receive({**MSG, "meta": {"seq": i}}))
    if boundary == "put":
        frame = np.full((2, 2), i, np.float32)
        out = fi.on_put(frame)
        return ("put", "same" if out is frame else (out.shape, bool(np.isnan(out).all())))
    if boundary == "dispatch":
        try:
            fi.on_dispatch()
            return ("dispatch", None)
        except RuntimeError as exc:
            return ("dispatch", type(exc).__name__, str(exc))
    if boundary == "readback":
        token = object()
        out = fi.on_readback(token)
        return ("readback", "same" if out is token else type(out).__name__)
    if boundary == "cascade":
        return ("cascade", fi.on_cascade(np.ones(3, bool)).tolist())
    if boundary == "decode":
        return ("decode", fi.on_decode(b"jpeg-bytes"))
    if boundary in ("wal", "checkpoint", "stage", "cutover"):
        return (boundary, getattr(fi, {"wal": "on_wal_append"}.get(boundary,
                                                                   "on_" + boundary))())
    if boundary in ("storage", "storage_read"):
        try:
            (fi.on_storage if boundary == "storage" else fi.on_storage_read)("op")
            return (boundary, None)
        except OSError as exc:
            return (boundary, exc.errno, str(exc))
    return ("transport", fi.on_transport("peer", "send", {"i": i}))


def _run(pkg, seq, rates=None, script=(), **kw):
    fi = PKGS[pkg].FaultInjector(seed=11, rates=rates, **{**NO_STALLS, **kw})
    for boundary, faults in script:
        fi.script(boundary, *faults)
    return [_cross(fi, b, i) for i, b in enumerate(seq)], fi.summary()


@pytest.mark.parametrize("boundary", ["receive", "put", "readback", "all"])
def test_rate_draws_equal_the_reference(boundary):
    rng = random.Random(3)
    pool = CROSSINGS if boundary == "all" else (boundary,)
    seq = [rng.choice(pool) for _ in range(400)]
    rates = (ALL_RATES if boundary == "all"
             else {boundary: ALL_RATES[boundary]})
    want, want_sum = _run("jax", seq, rates)
    got, got_sum = _run("torch", seq, rates)
    assert got == want
    assert got_sum == want_sum
    fired = {k.split(":")[0] for k in got_sum}
    assert fired >= ({boundary} if boundary != "all"
                     else {"receive", "put", "dispatch", "readback"}), got_sum


def test_scripted_order_equals_the_reference():
    """The reference's scripted-order case, in both packages: consumed in
    order once each, scripted before rates, the queue drained to a
    passthrough."""
    script = [("receive", ("drop", "duplicate", "corrupt", "flood")),
              ("put", ("corrupt",)), ("readback", ("stuck", "slow", "stuck")),
              ("dispatch", ("unavailable", "unavailable"))]
    seq = ["receive"] * 5 + ["put"] * 2 + ["readback"] * 4 + ["dispatch"] * 3
    want, want_sum = _run("jax", seq, {"put": {"corrupt": 0.5}}, script)
    got, got_sum = _run("torch", seq, {"put": {"corrupt": 0.5}}, script)
    assert got == want and got_sum == want_sum
    received = [v[1] for v in got[:5]]
    assert received[0] == [] and len(received[1]) == 2 and len(received[3]) == 8
    assert received[2][0]["__frame__"] == "corrupt!" and received[2][0]["meta"] == {"seq": 2}
    assert received[4] == [{**MSG, "meta": {"seq": 4}}]
    assert [v[1] for v in got[7:11]] == ["StuckReadback", "SlowReadback", "StuckReadback",
                                         "same"]
    for pkg in PKGS.values():
        fi = pkg.FaultInjector()
        with pytest.raises(ValueError):
            fi.script("put", "stuck")
        with pytest.raises(ValueError):
            fi.script("bogus", "drop")


@pytest.mark.parametrize("factor", [2, 4, 1])
def test_flood_factor_equals_the_reference(factor):
    seq = ["receive"] * 6
    want = _run("jax", seq, {"receive": {"flood": 0.5}}, flood_factor=factor)
    got = _run("torch", seq, {"receive": {"flood": 0.5}}, flood_factor=factor)
    assert got == want
    assert {len(v[1]) for v in got[0]} <= {1, max(2, factor)}


def test_disarm_and_arm_equal_the_reference():
    seq = ["readback", "dispatch", "receive", "put"]
    outs = {}
    for pkg, mod in PKGS.items():
        fi = mod.FaultInjector(seed=0, rates={"dispatch": {"unavailable": 1.0}})
        fi.script("readback", "stuck")
        fi.disarm()
        disarmed = [_cross(fi, b, i) for i, b in enumerate(seq)]
        summary = fi.summary()
        fi.arm()
        outs[pkg] = (disarmed, summary, [_cross(fi, b, i) for i, b in enumerate(seq)],
                     fi.summary())
    assert outs["torch"] == outs["jax"]
    disarmed, summary, armed, _ = outs["torch"]
    assert summary == {} and all(v[1] in ("same", None) or v[0] == "receive"
                                 for v in disarmed)
    assert armed[0] == ("readback", "StuckReadback")


def test_stuck_readback_never_materializes():
    """Reference: ``is_ready`` False, materializing raises. The port's:
    ``ready`` False, ``wait`` raises at once (a blocker thread never
    parks on it), ``result`` raises."""
    ref = jax_faults.StuckReadback(np.zeros(3))
    assert ref.is_ready() is False
    with pytest.raises(RuntimeError, match="stuck"):
        np.asarray(ref)
    inner = FakePacked(np.zeros(3, np.float32), ready_at=0.0)
    stuck = port_faults.StuckReadback(inner)
    assert stuck.pending and inner.ready()
    assert stuck.ready() is False
    with pytest.raises(RuntimeError, match="stuck"):
        stuck.wait()
    with pytest.raises(RuntimeError, match="stuck"):
        stuck.result()


def test_slow_readback_lands_after_its_delay():
    import time

    inner = FakePacked(np.arange(3, dtype=np.float32), ready_at=0.0)
    slow = port_faults.SlowReadback(inner, 0.05)
    assert slow.pending and not slow.ready()
    t0 = time.monotonic()
    np.testing.assert_array_equal(slow.result(), np.arange(3))
    assert time.monotonic() - t0 >= 0.04
    assert slow.ready()
    # not ready while the wrapped readback is not, whatever the delay
    late = port_faults.SlowReadback(FakePacked(np.zeros(1), time.monotonic() + 30), 0.0)
    assert not late.ready()


def test_seeded_rates_reproduce_like_the_reference():
    runs = {}
    for pkg, mod in PKGS.items():
        out = []
        for _ in range(2):
            fi = mod.FaultInjector(seed=42, rates={"dispatch": {"unavailable": 0.5}})
            out.append([_cross(fi, "dispatch", i)[1:] != (None,) for i in range(32)])
        assert out[0] == out[1]
        runs[pkg] = out[0]
    assert runs["torch"] == runs["jax"]
    assert any(runs["torch"]) and not all(runs["torch"])


def test_boundaries_equal_the_reference():
    assert port_faults.BOUNDARIES == jax_faults.BOUNDARIES
    with pytest.raises(ValueError):
        port_faults.FaultInjector(rates={"readback": {"melt": 0.1}})
