"""PyTorch/CUDA port of e_osvos_tpu.

Same subpackage layout as the JAX package, which stays the numerical
reference: ``ops`` (GroupNorm and greedy NMS with hand-written CUDA kernels
for Hopper, boxes, ROI-align, losses, mask bit-packing), ``models`` (ResNet
trunk, DeepLabV3/V3+, Mask R-CNN with FPN and RPN, weight transfer from the
JAX package's variables), ``meta_optim`` (learned per-neuron learning rates,
the inner SGD loop, the truncated-BPTT meta-gradient, meta-task sampling),
``parallel`` (the meta-training step), ``data`` (on-device augmentation,
synthetic sequences), ``engine`` (one-shot segmentation and detection
evaluation with online adaptation, the meta-training loop) and ``utils``
(device selection, seeds, metrics logging, checkpoints).

The package imports torch, numpy and the standard library only. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
