"""Refits of the flat band's basis back to back: each a cold
``orthogonal_iteration`` from a seeded (p, q) start, C V by the banded
product kernel, timed on the host from its dispatch to its basis on the
card.

Data: the band of ``setup_batches`` batches of the planted field folded
at set-up, and ``starts`` seeded starting blocks, used in turn.  Set-up
warms one refit.

The check, after the window, in float64: the reference folds the same
batches again (made anew from the generator's saved state), fits from
each start, and holds every refit's eigenvalues and iteration count and
each start's last basis against its own."""

from __future__ import annotations

import math
import time

import torch

from wsnbench import compare, fields
from wsnbench import flat
from wsnbench.reference import band as rb
from wsnbench.reference import pim, precision

Program, Control = flat.Program, flat.Control


class Driver:
    unit = "refit"

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, program=None):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = int(seed), device
        self.program = (program or Program)(cfg, device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _batches(self, g):
        cfg = self.cfg
        _, _, batch = fields.planted_field(cfg["p"], cfg["q"], self.device,
                                           g)
        for _ in range(self.traffic["setup_batches"]):
            yield batch(cfg["batch_epochs"])

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.program.build()
        g = torch.Generator(device=dev).manual_seed(self.seed)
        self.g_state = g.get_state()
        st = self.program.init()
        for x in self._batches(g):
            st = self.program.fold(st, x)
        self.band = self.program.estimate(st)
        del st
        self.v0 = torch.randn((self.traffic["starts"], cfg["p"], cfg["q"]),
                              device=dev, generator=g)
        self.results = []                 # (start, eigenvalues, iterations)
        self.bases = {}                   # start -> its last basis
        self.latencies = []
        self._unit(-1)                    # the window's shapes, warmed
        self.latencies.clear()

    def _unit(self, i):
        from torch.autograd.profiler import record_function
        j = (i + 1) % self.v0.shape[0]
        t0 = time.perf_counter()
        with record_function("wsnbench.refit"):
            W, lam, iters = self.program.refit(self.band, self.v0[j])
            self._sync()
        self.latencies.append((time.perf_counter() - t0) * 1e3)
        self.results.append((j, lam, int(iters)))
        self.bases[j] = W

    def measure(self, window) -> dict:
        window.run(self._unit, self._sync)
        return dict(seconds=window.elapsed, attempted=window.units,
                    refits=window.units, latencies_ms=list(self.latencies))

    def release(self) -> None:
        pass

    def check(self) -> dict:
        cfg, h = self.cfg, self.cfg["halfwidth"]
        got = {}
        with precision(False):
            g = torch.Generator(device=self.device)
            g.set_state(self.g_state)
            acc = None
            for x in self._batches(g):
                f = flat.fold64(x, h)
                acc = f if acc is None else {k: acc[k] + f[k] for k in f}
                del f
            band = flat.estimate(acc, h)
            del acc
            got["band_err"] = compare.rel_err(
                self.band, band, rb.valid(cfg["p"], h, self.device))
            self.band = None
            D = rb.dense_blocks(band)
            del band
            lam_err = basis_err = 0.0
            iter_diff = 0
            for j in sorted({r[0] for r in self.results}):
                W, lam, it = pim.orthogonal_iteration(
                    lambda V: rb.product(D, V), self.v0[j].double(),
                    cfg["t_max"], cfg["delta"])
                for jj, lam_p, it_p in self.results:
                    if jj == j:
                        lam_err = max(lam_err,
                                      compare.max_rel_each(lam_p, lam))
                        iter_diff = max(iter_diff, abs(it_p - it))
                ang = float(compare.column_angles(self.bases[j], W).max())
                basis_err = max(basis_err, math.inf if math.isnan(ang)
                                else ang)
            got["lam_err"] = lam_err
            got["basis_err"] = basis_err
            got["iter_diff"] = iter_diff
            got["iterations_min"] = min(r[2] for r in self.results)
        return got
