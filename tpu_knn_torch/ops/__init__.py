"""Tensor primitives and the CUDA kernel wrappers."""
