"""The plain reference of the benchmark: a frozen copy of the port's model
code (DeepLabV3+, Mask R-CNN, the object-stacked form, transforms, losses,
boxes, RoI-align) with the kernels replaced by their plain twins
(``plain_kernels``), computed in float32 unless the control asks for
less. It imports nothing of the port, of JAX or of the JAX package, and
takes no weight from the program: the benchmark hands both sides the same
seeded tensors."""
