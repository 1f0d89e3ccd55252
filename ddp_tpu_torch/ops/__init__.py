"""Attention and decode ops; CUDA kernels under ``csrc``."""
