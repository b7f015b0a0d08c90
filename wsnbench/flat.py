"""The flat band at wsn-1m's full width: the port's production steps
(``repro_torch.core.production``, ``core.covariance``,
``core.power_iteration``) and, in their place for the control, the
plain reference in float32 with TF32 products."""

from __future__ import annotations

import torch

from wsnbench.reference import band as rb
from wsnbench.reference import pim, precision


class Program:
    """The port's flat-band steps."""

    def __init__(self, cfg: dict, device: torch.device):
        self.cfg, self.device = cfg, device
        self.p, self.h, self.q = cfg["p"], cfg["halfwidth"], cfg["q"]

    def build(self) -> None:
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build_all()

    def init(self):
        from repro_torch.core import covariance
        return covariance.banded_init(self.p, self.h, device=self.device)

    def fold(self, state, x):
        from repro_torch.core import production
        return production.cov_update_step(state, x)

    def estimate(self, state):
        from repro_torch.core import covariance
        return covariance.banded_estimate(state)

    def refit(self, band, v0):
        """``orthogonal_iteration`` with ``C V`` by the banded product
        kernel, wired as ``core/pca.py`` wires the banded ortho fit."""
        from repro_torch.core import power_iteration as pi
        from repro_torch.kernels import ops
        res = pi.orthogonal_iteration(
            lambda V: ops.banded_matmul(band, V), self.p, self.q, v0=v0,
            t_max=self.cfg["t_max"], delta=self.cfg["delta"],
            device=self.device)
        return res.W, res.eigenvalues, res.iterations

    def transform(self, W, mean, x):
        from repro_torch.core import production
        return production.transform_step(W, mean, x)

    @staticmethod
    def state_view(state) -> dict:
        return dict(t=state.t, s=state.s, band=state.band)


class Control(Program):
    """The reference in the program's place, float32 with TF32."""

    def build(self) -> None:
        pass

    def init(self):
        z = lambda *s: torch.zeros(s, device=self.device)
        return dict(t=z(), s=z(self.p), band=z(2 * self.h + 1, self.p))

    def fold(self, state, x):
        with precision(True):
            delta = rb.fold(x[None], self.h)[0]
        return dict(t=state["t"] + x.shape[0], s=state["s"] + x.sum(0),
                    band=state["band"] + delta)

    def estimate(self, state):
        return estimate(state, self.h)

    def refit(self, band, v0):
        if getattr(self, "_band", None) is not band:
            self._band, self._D = band, rb.dense_blocks(band)
        with precision(True):
            return pim.orthogonal_iteration(
                lambda V: rb.product(self._D, V), v0, self.cfg["t_max"],
                self.cfg["delta"])

    def transform(self, W, mean, x):
        with precision(True):
            return (x - mean[None, :]) @ W

    @staticmethod
    def state_view(state) -> dict:
        return state


def estimate(state: dict, h: int) -> torch.Tensor:
    """The band of the covariance: the products over the count less the
    means' products, zero out of range."""
    t = state["t"].clamp(min=1.0)
    s = state["s"]
    c = state["band"] / t - s * rb.shifted(s, h) / (t * t)
    return torch.where(rb.valid(s.shape[-1], h, c.device), c, 0.0)


def fold64(x: torch.Tensor, h: int) -> dict:
    """The reference's statistics of one batch, float64."""
    x = x.double()
    return dict(t=torch.tensor(float(x.shape[0]), dtype=torch.float64,
                               device=x.device),
                s=x.sum(0), band=rb.fold(x[None], h)[0])
