"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions (:mod:`.ref`), the nvcc build (:mod:`.build`) and the wrappers
that pick between them by the device of their tensors (:mod:`.ops`)."""
