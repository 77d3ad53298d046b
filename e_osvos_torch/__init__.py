"""PyTorch/CUDA port of e_osvos_tpu.

Same subpackage layout as the JAX package, which stays the numerical
reference: ``ops`` (GroupNorm with hand-written CUDA kernels for Hopper,
losses, mask bit-packing), ``models`` (ResNet trunk, DeepLabV3/V3+, weight
transfer from the JAX package's variables), ``meta_optim`` (learned
per-neuron learning rates and the first-order inner SGD loop), ``data``
(on-device augmentation, synthetic sequences) and ``engine`` (one-shot
evaluation with online adaptation).

The package imports torch, numpy and the standard library only. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
