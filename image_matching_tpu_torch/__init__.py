"""PyTorch/CUDA port of image_matching_tpu for one NVIDIA H100.

Imports torch and numpy only, never JAX or the JAX package. Entry points
run on the card unless the caller passes device="cpu"; hand-written CUDA
kernels (csrc/) carry the JAX package's TPU kernels, each with a plain
PyTorch version beside it that CPU tensors take.
"""
