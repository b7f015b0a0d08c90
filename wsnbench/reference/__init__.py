"""The plain reference: the semantics of the benchmarked paths written out
in plain PyTorch, with dense and blocked matrix products, in any dtype.

It imports nothing of the program and takes nothing the program made:
the benchmark hands it the same inputs (readings, initial bases, starting
vectors) as the program, and where it follows the program from the
program's own state it says so.  The benchmark runs it in float64 as the
reference and, as the control, in float32 with TF32 products switched on
(:func:`precision`)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 matrix products on (the control) or off (the reference and the
    program), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
