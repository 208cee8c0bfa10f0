"""Sparse attention (CUDA kernel + plain version), selection, initializers."""
