"""PyTorch + CUDA port of the streaming distributed-PCA serving path.

``repro_torch`` mirrors the layout of the JAX package ``repro`` module for
module, so each function here has a counterpart of the same name there.
It imports ``torch`` and never ``jax`` or ``repro``: the pure-Python
reference modules it needs are copied in.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; the hand-written CUDA kernels
(``kernels/csrc``) run on CUDA tensors and their plain PyTorch versions
(``kernels/ref.py``) on CPU tensors.
"""
