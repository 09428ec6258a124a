"""PyTorch / CUDA port of ``opencv_facerecognizer_tpu`` for one NVIDIA H100.

The subpackages mirror the JAX package's layout (``ops``, ``models``,
``parallel``, ``runtime``, ``utils``), so each module's reference sits at
the same relative path there. The port imports ``torch`` and numpy only:
no JAX, and nothing from the JAX package.

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
card it raises instead of carrying on quietly on the CPU. The two Pallas
kernels of the JAX package are hand-written CUDA C++ kernels here
(``csrc/``), each with a plain PyTorch version beside its wrapper that
serves CPU tensors and is the kernel's oracle.
"""

__version__ = "0.1.0"
