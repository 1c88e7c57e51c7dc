"""Compute ops: the plain PyTorch path, the CUDA kernel wrapper and frame orchestration."""
