"""The numbers a run compares with the reference: errors measured in
float64 against the reference's own scale."""

from __future__ import annotations

import math

import torch


def rel_err(got: torch.Tensor, ref: torch.Tensor,
            where: torch.Tensor | None = None) -> float:
    """max |got - ref| / max |ref| over the entries ``where`` selects;
    infinite where ``got`` is not finite or ``ref`` is all zero and
    ``got`` is not."""
    g, r = got.double(), ref.double()
    d = (g - r).abs()
    if where is not None:
        d, r = d[where], r[where]
    if not d.numel():
        return 0.0
    dm, scale = float(d.max()), float(r.abs().max())
    if math.isnan(dm) or math.isinf(dm):
        return math.inf
    if scale > 0:
        return dm / scale
    return 0.0 if dm == 0 else math.inf


def max_rel_each(got: torch.Tensor, ref: torch.Tensor,
                 floor: float = 0.0) -> float:
    """max over entries of |got - ref| / max(|ref|, floor)."""
    g, r = got.double(), ref.double()
    if not r.numel():
        return 0.0
    e = float(((g - r).abs() / r.abs().clamp(min=floor)).max())
    return math.inf if math.isnan(e) else e


def subspace_sine(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The sine of the largest principal angle between span(A) and
    span(B) (..., p, r), each orthonormalised in float64 first: the norm
    of A's part outside span(B); (...) values."""
    a = torch.linalg.qr(A.double()).Q
    b = torch.linalg.qr(B.double()).Q
    return torch.linalg.matrix_norm(a - b @ (b.mT @ a), ord=2)


def column_angles(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """1 - |cos| between matching columns of A and B (..., p, q), each
    column's sign free."""
    a, b = A.double(), B.double()
    cos = (a * b).sum(-2) / (a.norm(dim=-2) * b.norm(dim=-2)).clamp(
        min=1e-300)
    return 1.0 - cos.abs()


def column_signs(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """+-1 per column that turns A's columns towards B's."""
    s = torch.sign((A.double() * B.double()).sum(-2))
    return torch.where(s == 0, torch.ones_like(s), s)
