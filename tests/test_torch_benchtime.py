"""``utils/benchtime.py`` of the PyTorch port against the JAX package's:
``measure_chained`` (host-only differencing, copied) returns the
reference's tuple for the same chain times, resolved at the first rung,
escalated, unresolved, and below its 1 us floor; ``scalar_chain_ms``
times the card only (its run on the card is in ``tests/test_torch_gpu.py``)."""

import pytest
import torch

from opencv_facerecognizer_tpu.utils import benchtime as jax_benchtime
from opencv_facerecognizer_tpu_torch.utils import benchtime as port_benchtime


def _chain(per_iter_s, base_s=0.01, jitter=(0.0, 0.002, 0.001)):
    calls = {"n": 0}

    def run_chain(k):
        calls["n"] += 1
        return base_s + per_iter_s * k + jitter[calls["n"] % len(jitter)]

    return run_chain


@pytest.mark.parametrize("per_iter_s", [1e-2, 1e-3, 4e-5, 1e-9])
@pytest.mark.parametrize("kw", [{}, dict(min_delta_s=1e-3, pairs=2, k2_ladder=(8, 64))])
def test_measure_chained_equals_the_reference(per_iter_s, kw):
    want = jax_benchtime.measure_chained(_chain(per_iter_s), **kw)
    got = port_benchtime.measure_chained(_chain(per_iter_s), **kw)
    assert got == want
    assert (port_benchtime.CHAIN_K1, port_benchtime.CHAIN_K2_LADDER,
            port_benchtime.MIN_DELTA_S, port_benchtime.MEASURE_PAIRS) == (
        jax_benchtime.CHAIN_K1, jax_benchtime.CHAIN_K2_LADDER, jax_benchtime.MIN_DELTA_S,
        jax_benchtime.MEASURE_PAIRS)


def test_scalar_chain_ms_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_benchtime.scalar_chain_ms(lambda a, x: (a * x).sum(), (torch.ones(4), torch.ones(4)))
