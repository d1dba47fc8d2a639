"""Operators of the port: hand-written CUDA kernels and their plain versions."""
