"""Sensor fields made on the device from a seeded ``torch.Generator``.

Both are copied from the port's card script (``chip_smoke.py``'s
``signal`` and ``planted_field``) and rewritten as device-side torch, so
that a run's data costs milliseconds of set-up and no host copy.

* :func:`local_field` and :func:`signal_rounds`: a spatially local field
  of ``rank`` smooth bumps (so the covariance is banded), a per-sensor
  mean, small noise and rare +-5 spikes that the stages flag.
* :func:`planted_field`: wsn-1m's field of q planted local modes with
  known variances, i.i.d. noise and a per-sensor mean.
"""

from __future__ import annotations

import torch


def local_field(p: int, rank: int, device) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The (p, rank) unit-norm bumps (sd 1.2 sensors, centred evenly over
    [0.1 p, 0.9 p]) and their score scales 0.9 ... 0.4."""
    j = torch.arange(p, device=device, dtype=torch.float32)
    centres = torch.linspace(0.1, 0.9, rank, device=device) * p
    U = torch.exp(-0.5 * ((j[:, None] - centres[None, :]) / 1.2) ** 2)
    U /= U.norm(dim=0)
    return U, torch.linspace(0.9, 0.4, rank, device=device)


def signal_rounds(g: torch.Generator, U: torch.Tensor, scale: torch.Tensor,
                  mean: torch.Tensor, rounds: int, n: int, *,
                  noise: float = 0.05, spike_rate: float = 3e-4,
                  spike: float = 5.0, block: int = 32) -> torch.Tensor:
    """(S, rounds, n, p) readings of S networks, ``mean`` (S, p) their
    per-sensor means: scores ~ N(0, scale^2) on the bumps ``U``, noise of
    sd ``noise`` and spikes of +-``spike`` at rate ``spike_rate``, made
    ``block`` networks at a time so that the temporaries stay small."""
    S, p = mean.shape
    rank = U.shape[1]
    dev = mean.device
    out = torch.empty((S, rounds, n, p), device=dev, dtype=torch.float32)
    for a in range(0, S, block):
        b = min(S, a + block)
        shape = (b - a, rounds, n, p)
        gs = torch.randn((b - a, rounds, n, rank), device=dev,
                         generator=g) * scale
        x = out[a:b]
        torch.matmul(gs, U.T, out=x)
        x += mean[a:b, None, None, :]
        x += noise * torch.randn(shape, device=dev, generator=g)
        hit = torch.rand(shape, device=dev, generator=g) < spike_rate
        sign = torch.rand(shape, device=dev, generator=g) < 0.5
        x += hit * torch.where(sign, -spike, spike)
    return out


def planted_field(p: int, q: int, device, g: torch.Generator):
    """wsn-1m's field: q planted local modes (mode k a Gaussian bump of sd
    8 sensors cut at +-32, unit norm, centred at (k + 1/2) p / q, so no two
    modes share a band row) with score variances 4, 2, 1, 0.5 and then
    0.45 x 0.97^i, i.i.d. noise of sd 0.01 and a per-sensor mean of sd
    0.5.  Returns the (p, q) modes, their variances and a maker of (n, p)
    batches drawn from ``g``."""
    j = torch.arange(-32, 33, device=device)
    bump = torch.exp(-0.5 * (j.float() / 8) ** 2)
    bump /= bump.norm()
    centres = ((torch.arange(q, device=device) + 0.5) * (p / q)).long()
    U = torch.zeros((p, q), device=device)
    U[centres[None, :] + j[:, None],
      torch.arange(q, device=device)[None, :]] = bump[:, None]
    lam = torch.tensor([4.0, 2.0, 1.0, 0.5]
                       + [0.45 * 0.97 ** i for i in range(q - 4)],
                       device=device)
    mu = 0.5 * torch.randn(p, device=device, generator=g)

    def batch(n: int) -> torch.Tensor:
        s = torch.randn((n, q), device=device, generator=g) * lam.sqrt()
        x = s @ U.T
        x += 0.01 * torch.randn((n, p), device=device, generator=g)
        return x.add_(mu)

    return U, lam, batch
