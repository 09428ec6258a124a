"""The inputs and the traffic are functions of the seed."""

import numpy as np
import pytest
import torch

import inputs
import run


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11, 2 ** 33 + 5])
def test_camera_fleet_schedule_is_the_seed_s(seed):
    fleet = run.load_module(run.HERE / "traffic" / "camera_fleet.py")
    params = {"cameras": 50, "fps": 15.0, "jitter": 0.1, "preroll_s": 1.0}
    a = fleet.make(params, seed, 256).schedule(3.0)
    b = fleet.make(params, seed, 256).schedule(3.0)
    c = fleet.make(params, seed + 1, 256).schedule(3.0)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    # every camera at its rate, jitter within 10%: about 50 x 15 x 3 frames
    assert abs(len(a[0]) - 2250) < 80 and np.all(np.diff(a[0]) >= 0)


def test_weights_frames_and_rows_are_the_seed_s():
    cfg = run.load_json(run.HERE / "configs" / "serve_1m.json")
    a = inputs.make_weights(2 ** 32 + 3, cfg["detector"], cfg["embedder"], "cpu")
    b = inputs.make_weights(2 ** 32 + 3, cfg["detector"], cfg["embedder"], "cpu")
    c = inputs.make_weights(2 ** 32 + 4, cfg["detector"], cfg["embedder"], "cpu")
    for x, y, z in zip(a, b, c):
        assert all(torch.equal(x[k], y[k]) for k in x)
        assert not all(torch.equal(x[k], z[k]) for k in x if k not in cfg["detector"]["init"])
    assert np.array_equal(inputs.make_scenes(4, (64, 64), 3, (16, 24), 9),
                          inputs.make_scenes(4, (64, 64), 3, (16, 24), 9))
    assert torch.equal(inputs.row_block(11, 2, 64, 8, "cpu"), inputs.row_block(11, 2, 64, 8, "cpu"))
    assert not torch.equal(inputs.row_block(11, 2, 64, 8, "cpu"),
                           inputs.row_block(11, 3, 64, 8, "cpu"))
