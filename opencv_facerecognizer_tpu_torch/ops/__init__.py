"""Tensor ops of the port: NMS, image crops and preprocessing, LBP codes,
spatial histograms, distances, the subspace eigen-solvers, and the two
kernels (``streaming_match``, ``sepblock``) with their plain PyTorch
versions."""
