"""Blocked orthogonal iteration (the paper's power iteration method,
blocked), as the benchmarked paths run it: ``V <- C V``, a Gram matrix, a
Cholesky factor and ``V chol^{-T}`` a step, the per-column update norm
as the stopping rule, and a Rayleigh-Ritz ``eigh`` at the end."""

from __future__ import annotations

from typing import Callable

import torch


def orthonormalize(V: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``V inv(L)^T`` with ``L = chol(V^T V + eps I)``, over any leading
    axes."""
    q = V.shape[-1]
    eye = torch.eye(q, dtype=V.dtype, device=V.device)
    L = torch.linalg.cholesky_ex(V.mT @ V + eps * eye).L
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return V @ Linv.mT


def rayleigh_ritz(V: torch.Tensor, CV: torch.Tensor,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Ritz vectors and values of span(V), descending."""
    H = V.mT @ CV
    evals, U = torch.linalg.eigh(0.5 * (H + H.mT))
    return V @ U.flip(-1), evals.flip(-1)


def orthogonal_iteration(matmul: Callable[[torch.Tensor], torch.Tensor],
                         v0: torch.Tensor, t_max: int, delta: float,
                         eps: float = 1e-8,
                         ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """A cold fit from ``v0`` (p, q): at most ``t_max`` products, stopping
    once ``sqrt(||V_next sign - V||^2 / q) <= delta``.  Returns the basis
    and eigenvalue estimates, descending, and the iterations run."""
    q = v0.shape[-1]
    V = orthonormalize(v0, eps)
    t, d = 0, float("inf")
    while t < t_max and d > delta:
        V_next = orthonormalize(matmul(V), eps)
        sign = torch.sign((V * V_next).sum(0))
        d = float(torch.sqrt(((V_next * sign - V) ** 2).sum() / q))
        V, t = V_next, t + 1
    W, lam = rayleigh_ritz(V, matmul(V))
    return W, lam, t


def refresh(matmul: Callable[[torch.Tensor], torch.Tensor],
            W0: torch.Tensor, iters: int, eps: float = 1e-8,
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """A fixed number of steps warm-started from ``W0`` (..., p, q), then
    Rayleigh-Ritz: the fleet scheduler's refresh."""
    V = orthonormalize(W0, eps)
    for _ in range(iters):
        V = orthonormalize(matmul(V), eps)
    return rayleigh_ritz(V, matmul(V))
