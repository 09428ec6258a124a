"""Tensor ops of the port: NMS, image crops, and the two kernels
(``streaming_match``, ``sepblock``) with their plain PyTorch versions."""
