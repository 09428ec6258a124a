"""Device resolution: the card by default, never a silent CPU path.

Every entry point of the port takes ``device=`` and resolves it here.
``"cuda"`` is the default; asking for it on a machine without a card
raises. The CPU runs only when the caller names it (the tests do), and
there the kernel wrappers take their plain PyTorch versions.
"""

from __future__ import annotations

import functools
from typing import Union

import torch

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names a CUDA card
    that this process cannot see."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda is not "
                "available; pass device='cpu' explicitly to run the plain "
                "PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA ``device`` (cached): the
    kernel wrappers size their grids by it."""
    return _sm_count_of(device.index if device.index is not None
                        else torch.cuda.current_device())


def disable_tf32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    ``torch.backends.cuda.matmul.allow_tf32`` defaults to False but
    ``torch.backends.cudnn.allow_tf32`` defaults to True, and TF32 keeps
    about three decimal digits. The crop (two tent-weight contractions the
    reference runs at ``Precision.HIGHEST``) and the detector's float32
    heads need full float32, so the port sets both switches off where it
    runs them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
