"""The fleet's chunk step as the streaming path defines it, for fleets
without liveness masks and with every round real: K rounds of n epochs
folded with per-round forgetting, one scheduler decision a network (the
retained fraction, a warm-started refresh where the basis drifted or was
never fit), the ε-compression and T²/SPE monitoring stages against the
basis in force after the decision, and the detector's healthy windows.

State is a dict of tensors with a leading axis of networks; any float
dtype.  The program's packet books are linear in the counts this module
returns (flags, alarms, refreshes) and are not re-derived here."""

from __future__ import annotations

import dataclasses
import statistics

import torch

from wsnbench.reference import band as rb
from wsnbench.reference import pim


@dataclasses.dataclass(frozen=True)
class Spec:
    p: int
    q: int
    h: int
    n: int
    K: int
    forgetting: float
    drift_threshold: float
    refresh_iters: int
    warmup_rounds: int
    epsilon: float
    alpha: float
    calib_rounds: int
    min_lambda: float = 1e-9

    @property
    def z_alpha(self) -> float:
        return statistics.NormalDist().inv_cdf(1.0 - self.alpha)


def init(spec: Spec, W0: torch.Tensor) -> dict:
    """The state of S fresh networks around initial bases W0 (S, p, q)."""
    S, p, q = W0.shape
    nd = 2 * spec.h + 1
    z = lambda *s: W0.new_zeros((S,) + s)
    inf = torch.full((S,), float("inf"), dtype=W0.dtype, device=W0.device)
    return dict(t=z(), s=z(p), band=z(nd, p), t_band=z(nd, p), W=W0.clone(),
                rho_ref=z(), refreshes=z().long(), lam=W0.new_ones((S, q)),
                rounds=z().long(), t2_threshold=inf, spe_threshold=inf.clone(),
                calib_left=z().long(), t2_sum=z(), t2_sumsq=z(), spe_sum=z(),
                spe_sumsq=z(), count=z())


def estimate(st: dict, h: int) -> torch.Tensor:
    """The live band estimate, every sum over its own effective count."""
    mean = st["s"] / st["t_band"][:, h].clamp(min=1.0)
    c = st["band"] / st["t_band"].clamp(min=1.0) \
        - mean[:, None, :] * rb.shifted(mean, h)
    return torch.where(rb.valid(mean.shape[-1], h, c.device), c, 0.0)


def total_variance(st: dict, h: int) -> torch.Tensor:
    ti = st["t_band"][:, h].clamp(min=1.0)
    return (st["band"][:, h] / ti - (st["s"] / ti) ** 2).sum(-1)


def fold_chunk(spec: Spec, st: dict, x: torch.Tensor) -> dict:
    """The covariance statistics after folding x (S, K, n, p)."""
    S, K, n, p = x.shape
    dt, dev = x.dtype, x.device
    pw = torch.tensor([spec.forgetting ** j for j in range(K + 1)],
                      dtype=dt, device=dev)
    w = pw[torch.arange(K - 1, -1, -1, device=dev)]        # beta^(K-1-t)
    beta = pw[K]
    rows = w.repeat_interleave(n).expand(S, K * n)
    delta = rb.fold(x.reshape(S, K * n, p), spec.h, rows)
    count = w.sum() * n
    return dict(t=beta * st["t"] + count,
                s=beta * st["s"] + torch.einsum("t,stp->sp", w, x.sum(-2)),
                band=beta * st["band"] + delta,
                t_band=beta * st["t_band"]
                + count * rb.valid(p, spec.h, dev).to(dt))


def _moment_threshold(s, ss, cnt, z):
    cnt = cnt.clamp(min=1.0)
    m = (s / cnt).clamp(min=1e-12)
    v = (ss / cnt - m * m).clamp(min=1e-12)
    return v / (2.0 * m) * _wilson_hilferty(2.0 * m * m / v, z)


def _wilson_hilferty(df, z):
    a = 2.0 / (9.0 * df.clamp(min=1e-12))
    return df * (1.0 - a + z * torch.sqrt(a)) ** 3


def chunk_step(spec: Spec, st: dict, x: torch.Tensor,
               ) -> tuple[dict, dict]:
    """One chunk x (S, K, n, p) for every network: the new state and the
    chunk's record (the decision's drift, whether it fired, the stages'
    per-reading and per-epoch outputs, the alarms)."""
    S, K, n, p = x.shape
    h, q = spec.h, spec.q
    cov = fold_chunk(spec, st, x)
    mean = cov["s"] / cov["t_band"][:, h].clamp(min=1.0)
    D = rb.dense_blocks(estimate(cov, h))
    mm = lambda V: rb.product(D, V)
    tv = total_variance(cov, h).clamp(min=1e-30)
    W0 = st["W"]
    rho = (W0 * mm(W0)).sum((-2, -1)) / tv
    drift = st["rho_ref"] - rho
    last = st["rounds"] + K - 1
    fire = (last >= spec.warmup_rounds) & (
        (st["refreshes"] == 0) | (drift > spec.drift_threshold))
    W_new, lam_new = pim.refresh(mm, W0, spec.refresh_iters)
    rho_new = (W_new * mm(W_new)).sum((-2, -1)) / tv
    f3 = fire[:, None, None]
    W = torch.where(f3, W_new, W0)
    lam = torch.where(fire[:, None], lam_new, st["lam"])
    new = dict(cov, W=W, rho_ref=torch.where(fire, rho_new, st["rho_ref"]),
               refreshes=st["refreshes"] + fire.long(), lam=lam,
               rounds=st["rounds"] + K)

    # the stages, against the basis and variances after the decision
    xv = x.reshape(S, K * n, p)
    xc = xv - mean[:, None, :]
    z = xc @ W
    xh_r = z @ W.mT
    xh = xh_r + mean[:, None, :]
    flags = (xv - xh).abs() > spec.epsilon
    x_sink = torch.where(flags, xv, xh)
    il = 1.0 / lam.clamp(min=spec.min_lambda)
    t2 = (z * z * il[:, None, :]).sum(-1)
    spe = ((xc - xh_r) ** 2).sum(-1)

    # the detector: a fresh healthy window where the basis changed
    zero = torch.zeros_like(st["t2_sum"])
    calib = torch.where(fire, torch.full_like(st["calib_left"],
                                              spec.calib_rounds),
                        st["calib_left"])
    keep = lambda a: torch.where(fire, zero, a)
    calibrating = calib > 0
    cf = calibrating.to(x.dtype)
    sums = dict(t2_sum=keep(st["t2_sum"]) + cf * t2.sum(-1),
                t2_sumsq=keep(st["t2_sumsq"]) + cf * (t2 * t2).sum(-1),
                spe_sum=keep(st["spe_sum"]) + cf * spe.sum(-1),
                spe_sumsq=keep(st["spe_sumsq"]) + cf * (spe * spe).sum(-1),
                count=keep(st["count"]) + cf * (K * n))
    calib = calib - calibrating.long()
    closing = calibrating & (calib == 0)
    zq = spec.z_alpha
    floor = _wilson_hilferty(torch.full((), float(q), dtype=x.dtype,
                                        device=x.device), zq)
    t2_new = torch.maximum(_moment_threshold(sums["t2_sum"],
                                             sums["t2_sumsq"],
                                             sums["count"], zq), floor)
    spe_new = _moment_threshold(sums["spe_sum"], sums["spe_sumsq"],
                                sums["count"], zq).clamp(min=0.0)
    armed = ~calibrating
    t2_thr, spe_thr = st["t2_threshold"], st["spe_threshold"]
    events = armed[:, None] & ((t2 > t2_thr[:, None])
                               | (spe > spe_thr[:, None]))
    new.update(sums, calib_left=calib,
               t2_threshold=torch.where(closing, t2_new, t2_thr),
               spe_threshold=torch.where(closing, spe_new, spe_thr))
    record = dict(drift=drift, fired=fire, z=z, x_hat=xh, flags=flags,
                  x_sink=x_sink, t2=t2, spe=spe, events=events,
                  t2_thr=t2_thr, spe_thr=spe_thr,
                  alarms=events.sum(-1))
    return new, record


def run(spec: Spec, st: dict, xs: torch.Tensor) -> tuple[dict, list]:
    """Stream xs (S, R, n, p), R a whole number of chunks; the state after
    it and the record of each chunk."""
    S, R, n, p = xs.shape
    if R % spec.K:
        raise ValueError(f"{R} rounds are not whole chunks of {spec.K}")
    records = []
    for c in range(R // spec.K):
        st, rec = chunk_step(spec, st, xs[:, c * spec.K:(c + 1) * spec.K])
        records.append(rec)
    return st, records
