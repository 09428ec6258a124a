"""What the three trainers share (the embedder's ArcFace, the detector's
and the stage-1 gate's): optax's Adam, and the reference's batches.

Each reference trainer draws its batch indices per step from one numpy
``default_rng(seed)``; drawing the same sequence up front gives the same
batches, index for index, and one upload instead of one a step.
"""

from __future__ import annotations

import numpy as np
import torch


def adam(params, learning_rate: float) -> torch.optim.Adam:
    """``optax.adam(learning_rate)``: betas (0.9, 0.999), eps 1e-8 outside
    the square root, the same bias corrections; one multi-tensor update."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            foreach=True)


def fixed_batches(n: int, batch_size: int, steps: int, seed: int, device) -> torch.Tensor:
    """[steps, batch_size] sample indices on ``device``: the reference's
    ``default_rng(seed).choice(n, size=batch_size, replace=n < batch_size)``
    for each step in turn."""
    rng = np.random.default_rng(seed)
    picks = [rng.choice(n, size=batch_size, replace=n < batch_size) for _ in range(steps)]
    return torch.as_tensor(np.stack(picks) if picks else np.zeros((0, batch_size), np.int64),
                           dtype=torch.long).to(device)
