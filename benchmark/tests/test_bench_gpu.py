"""On the card, at the cells' own sizes: the fp8 control fails the check on
three seeds for each configuration, and a short run of each cell
is correct. Skips without a card (decided in the fixture)."""

import pytest
import torch

import check
import run


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["serve_1m", "serve_8m"])
def test_control_fails_at_full_size(card, config):
    cfg = run.load_json(run.HERE / "configs" / f"{config}.json")
    for seed in (2 ** 31 + 101, 2 ** 32 + 202, 303):
        prep = run.prepare_inputs(cfg, seed, card)
        ref = run.reference_for(cfg, seed, prep, card)
        ctl = run.reference_for(cfg, seed, prep, card, quant=check.fp8_quant)
        numbers = check.judge(check.control_answers(ctl, range(cfg["frames"]["pool"]), 0.3),
                              ref, cfg["detector"])
        assert any(numbers[k] > cfg["limits"][k] for k in cfg["limits"]), numbers
        del prep, ref, ctl
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["serve_1m.live", "serve_8m.live"])
def test_a_short_run_is_correct(card, cell):
    r = run.run_cell(cell, 2 ** 32 + 17, 3.0, False, card)
    assert r["correct"] and r["numbers"]["lost"] == 0 and not r["forbidden"], r["numbers"]
    torch.cuda.empty_cache()
