"""Operators of the PyTorch port: GroupNorm (with its CUDA kernels), losses
and mask bit-packing."""
