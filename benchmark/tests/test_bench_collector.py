"""The garbage collector across a run: what set-up made is frozen before
the traffic starts, and nothing is left frozen once the run is over."""

import gc

import small


def test_setup_frozen_then_released():
    before = gc.get_freeze_count()  # the interpreter's own, a few hundred
    seen = []

    def watch(phase, info):
        if phase == "start":
            seen.append(gc.get_freeze_count())

    gc.callbacks.append(watch)
    try:
        r = small.run()
    finally:
        gc.callbacks.remove(watch)
    assert r["correct"] and "gc_freeze_s" in r["timings"]
    assert max(seen) > before + 1000  # the window's collections ran with set-up frozen
    assert gc.get_freeze_count() <= before
