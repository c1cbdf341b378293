"""Tensor operations of the port and its CUDA kernels."""
