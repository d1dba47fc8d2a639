"""Wrappers of the CUDA kernels in ``csrc/`` with their plain PyTorch twins."""
