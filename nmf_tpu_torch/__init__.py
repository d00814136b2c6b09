"""PyTorch/CUDA port of nmf_tpu for NVIDIA Hopper (H100).

The JAX package ``nmf_tpu`` is the reference; this package mirrors its
layout module for module and imports nothing of it. Every Pallas TPU
kernel on the ported path is a hand-written CUDA kernel under ``csrc/``,
built with ``nvcc`` at first use (``ops/kernels/build.py``).
"""
