"""Named spans at the port's layer boundaries, recorded only while a
``torch.profiler`` session runs.

``span("repro_torch.<layer>.<part>")`` is a ``record_function`` range
when the profiler is on, so the span lands in the same trace (and on the
same clock) as the device's operations; with the profiler off it is one
shared null context, and a span costs the flag check alone.  Every span
of the package goes through here (repolint's ``span-gate`` rule)."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span", "OFF"]

OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` when the profiler runs, else
    :data:`OFF`.  It adds no host read, allocation or tensor operation."""
    if not torch._C._autograd._profiler_enabled():
        return OFF
    return torch.autograd.profiler.record_function(name)
