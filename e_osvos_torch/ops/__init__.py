"""Operators of the PyTorch port: GroupNorm and greedy NMS (with their CUDA
kernels), boxes, Fast NMS, ROI-align, losses and mask bit-packing."""
