"""Distributed PCA orchestrator (counterpart of ``repro.core.pca``: the
paper's end-to-end system), in PyTorch on an explicit device.

1. estimate the covariance — centralized (Sec. 3.2) or under the local
   covariance hypothesis (Sec. 3.3, masked or banded),
2. extract q principal components — exact eigendecomposition (the
   paper's centralized baseline), the deflated power iteration
   (Algorithm 2) or the blocked orthogonal iteration,
3. expose transform / inverse_transform (PCAg scores, Sec. 2.3) and
   retained-variance accounting (Eq. 4).

``fit`` takes numpy or a tensor, computes on ``device`` (``cuda`` unless
the caller asks for another) and returns a :class:`PCAResult` of numpy
fields, as the reference does, so the numpy oracles
(:mod:`repro_torch.core.compression`, :mod:`repro_torch.core.spatiotemporal`)
run on top of it unchanged.  On the banded layout the batch fold is kernel
6 (:func:`repro_torch.core.covariance.banded_update`), ``power``'s ``C v``
kernel 11 (:func:`repro_torch.kernels.ops.banded_matvec`) and ``ortho``'s
``C V`` kernel 10 (:func:`repro_torch.kernels.ops.banded_matmul`); the
dense and masked layouts multiply with ``torch.matmul``, as the reference
does outside any kernel.  The dense (p, p) estimate is formed for every
mode (the reference's ``eigh`` reads it and its total variance is the
trace of the full one), so ``fit`` serves p up to a few thousand; the
wsn-1m width goes through :mod:`repro_torch.core.production`.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.core import covariance as cov
from repro_torch.core import power_iteration as pim
from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels import ops

__all__ = ["PCAResult", "DistributedPCA", "retained_variance"]

Method = Literal["eigh", "power", "ortho"]
CovMode = Literal["full", "masked", "banded"]


@dataclasses.dataclass
class PCAResult:
    components: np.ndarray      # (p, q) columns = w_k
    eigenvalues: np.ndarray     # (q,)
    mean: np.ndarray            # (p,)
    valid: np.ndarray           # (q,) bool (sign-criterion mask, Alg. 2)
    iterations: np.ndarray | int
    total_variance: float       # trace of the (unmasked) sample covariance

    @property
    def q(self) -> int:
        return int(self.components.shape[1])

    def retained_fraction(self) -> np.ndarray:
        """Eq. (4) on the training covariance, cumulative over components."""
        lam = np.where(self.valid, np.maximum(self.eigenvalues, 0.0), 0.0)
        return np.cumsum(lam) / max(self.total_variance, 1e-30)


def retained_variance(x: np.ndarray, components: np.ndarray,
                      mean: np.ndarray | None = None) -> float:
    """Fraction of the variance of ``x`` retained by projecting on the
    basis: the paper's test-set metric (Sec. 4.3), in numpy float64."""
    x = np.asarray(x, dtype=np.float64)
    mu = x.mean(axis=0) if mean is None else np.asarray(mean, np.float64)
    xc = x - mu
    W = np.asarray(components, dtype=np.float64)
    xhat = (xc @ W) @ W.T
    num = float(np.sum((xc - xhat) ** 2))
    den = float(np.sum(xc ** 2))
    return 1.0 - num / max(den, 1e-30)


class DistributedPCA:
    """fit/transform interface over the paper's algorithm variants.

    Parameters
    ----------
    q: number of principal components to extract.
    method: 'eigh' (centralized baseline), 'power' (Algorithm 2), 'ortho'
        (blocked orthogonal iteration).
    cov_mode: 'full', 'masked' (explicit neighbourhood mask) or 'banded'
        (band of half-width ``halfwidth``).
    mask: (p, p) bool — required for 'masked'.
    halfwidth: band half-width — required for 'banded'.
    t_max, delta: the iterations' stopping rule (Algorithm 1).
    seed: seeds the ``torch.Generator`` that draws the initial vectors
        when ``init`` is None.
    init: the initial vectors — (q, p) for 'power' (row k starts
        component k), (p, q) for 'ortho' — e.g. the reference's own
        ``jax.random`` draws carried across; ignored by 'eigh'.
    device: where ``fit`` computes (``cuda`` unless asked otherwise).
    """

    def __init__(self, q: int, method: Method = "power",
                 cov_mode: CovMode = "full",
                 mask: np.ndarray | None = None,
                 halfwidth: int | None = None,
                 t_max: int = 50, delta: float = 1e-3, seed: int = 0,
                 init=None, device="cuda"):
        if cov_mode == "masked" and mask is None:
            raise ValueError("cov_mode='masked' requires a neighborhood mask")
        if cov_mode == "banded" and halfwidth is None:
            raise ValueError("cov_mode='banded' requires halfwidth")
        self.q = q
        self.method = method
        self.cov_mode = cov_mode
        self.mask = mask
        self.halfwidth = halfwidth
        self.t_max = t_max
        self.delta = delta
        self.seed = seed
        self.init = init
        self.device = device

    # -- covariance --------------------------------------------------------
    def _estimate_cov(self, x: torch.Tensor):
        p = x.shape[1]
        if self.cov_mode == "banded":
            state = cov.banded_init(p, self.halfwidth, device=x.device)
            band = cov.banded_estimate(cov.banded_update(state, x))
            return band, cov.band_to_dense(band)
        mask = None if self.cov_mode == "full" else self.mask
        state = cov.cov_update(cov.cov_init(p, mask=mask, device=x.device),
                               x)
        return None, cov.cov_estimate(state)

    # -- fit ----------------------------------------------------------------
    def fit(self, x) -> PCAResult:
        dev = resolve_device(self.device)
        x = as_tensor(x, torch.float32, dev)
        mean = x.mean(0)
        band, c = self._estimate_cov(x)
        p = x.shape[1]
        total_var = float(torch.trace(cov.cov_estimate(
            cov.cov_update(cov.cov_init(p, device=dev), x))))
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        kw = dict(t_max=self.t_max, delta=self.delta, device=dev,
                  generator=gen, v0=self.init)

        if self.method == "eigh":
            # jnp.linalg.eigh symmetrizes its input; torch reads one triangle
            evals, evecs = torch.linalg.eigh(0.5 * (c + c.T))
            order = torch.argsort(-evals, stable=True)[: self.q]
            W, lam = evecs[:, order], evals[order]
            valid, iters = lam > 0, 0
        elif self.method == "power":
            if band is not None:
                matvec = lambda v: ops.banded_matvec(band, v)
            else:
                matvec = lambda v: c @ v
            res = pim.deflated_power_iteration(matvec, p, self.q, **kw)
            W, lam, valid, iters = (res.W, res.eigenvalues, res.valid,
                                    res.iterations)
        elif self.method == "ortho":
            if band is not None:
                matmul = lambda V: ops.banded_matmul(band, V)
            else:
                matmul = lambda V: c @ V
            res = pim.orthogonal_iteration(matmul, p, self.q, **kw)
            W, lam, iters = res.W, res.eigenvalues, res.iterations
            valid = lam > 0
        else:
            raise ValueError(f"unknown method {self.method!r}")

        return PCAResult(
            components=W.double().cpu().numpy(),
            eigenvalues=lam.double().cpu().numpy(),
            mean=mean.double().cpu().numpy(),
            valid=valid.cpu().numpy().astype(bool),
            iterations=np.asarray(iters),
            total_variance=total_var,
        )

    # -- transform (PCAg scores, Sec. 2.3) ----------------------------------
    @staticmethod
    def transform(result: PCAResult, x: np.ndarray,
                  use_valid_only: bool = True) -> np.ndarray:
        W = result.components
        if use_valid_only:
            W = W * result.valid[None, :]
        return (np.asarray(x) - result.mean) @ W

    @staticmethod
    def inverse_transform(result: PCAResult, z: np.ndarray,
                          use_valid_only: bool = True) -> np.ndarray:
        W = result.components
        if use_valid_only:
            W = W * result.valid[None, :]
        return z @ W.T + result.mean
