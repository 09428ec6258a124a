"""What decides ``correct``: a small run of the whole harness on the CPU
judges the system's answers correct; the fp8 control, put in the system's
place, is not; and each fault planted under the timed path makes the run
come out not correct."""

import numpy as np
import pytest
import torch

import check
import run
import small


@pytest.fixture(scope="module")
def sound():
    return small.run()


def test_a_sound_run_is_correct(sound):
    assert sound["correct"] and sound["kept"] > 50
    assert sound["numbers"]["lost"] == 0 and sound["measured"]["failed"] == 0
    assert not sound["forbidden"]


def test_the_fp8_control_fails_the_limits():
    cfg = run.load_json(run.HERE / "configs" / "serve_1m.json")
    cfg["gallery"]["rows"] = 4096
    cfg["frames"]["pool"] = 16
    failed = 0
    for seed in (5, 2 ** 31 + 7, 2 ** 33 + 1):
        prep = run.prepare_inputs(cfg, seed, torch.device("cpu"))
        ref = run.reference_for(cfg, seed, prep, "cpu")
        ctl = run.reference_for(cfg, seed, prep, "cpu", quant=check.fp8_quant)
        numbers = check.judge(check.control_answers(ctl, range(16), 0.3), ref,
                              cfg["detector"])
        failed += any(numbers[k] > cfg["limits"][k] for k in cfg["limits"])
    assert failed == 3


def _stale(pipeline):
    """A step that hands back its first output every time."""
    real = pipeline.recognize_batch_packed
    held = []

    def step(frames):
        out = real(frames)
        if not held:
            held.append(out.clone())
        return held[0].clone()

    pipeline.recognize_batch_packed = step


def _half(pipeline):
    """Half of the batch left out: its rows carry the other half's answers."""
    real = pipeline.recognize_batch_packed

    def step(frames):
        out = real(frames).clone()
        half = out.shape[0] // 2
        out[half:2 * half] = out[:half]
        return out

    pipeline.recognize_batch_packed = step


def _altered(pipeline):
    """One answer altered where it is produced: frame 0's labels point at
    the next gallery row."""
    real = pipeline.recognize_batch_packed

    def step(frames):
        out = real(frames).clone()
        out[0, :, 6] += 1.0  # the labels column of the packed layout
        return out

    pipeline.recognize_batch_packed = step


@pytest.mark.parametrize("fault", [_stale, _half, _altered], ids=lambda f: f.__name__[1:])
def test_a_broken_step_is_not_correct(fault):
    r = small.run(fault=fault)
    assert not r["correct"]


def test_a_result_that_never_comes_is_not_correct(monkeypatch):
    import connector

    real = connector.BenchConnector.publish

    def publish(self, topic, message):
        if topic.endswith("results") and message["meta"] % 97 == 5:
            return  # delivered nowhere
        real(self, topic, message)

    monkeypatch.setattr(connector.BenchConnector, "publish", publish)
    r = small.run()
    assert r["numbers"]["lost"] > 0 and not r["correct"]
