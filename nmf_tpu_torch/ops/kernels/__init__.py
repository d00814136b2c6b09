"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version beside it only for CPU tensors."""
