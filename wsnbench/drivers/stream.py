"""The flat band's production stream: every batch folded into the band
(``cov_update_step``, the band-fold kernel) and compressed against the
basis fitted at set-up (``transform_step``), dispatched ahead of the
card with at most ``in_flight`` batches outstanding.

Data: a pool of ``pool_batches`` batches of the planted field, made on
the card from the seed and cycled.  Set-up folds the pool once, fits the
basis (``orthogonal_iteration`` from a seeded start) and warms one fold
and one transform; no refit runs in the window.

The check, after the window, in float64: the fold of one batch of the
window's first ``sampled_from`` (drawn from the seed), read as the change
of the program's band across it, against the reference's fold of that
batch; the epoch count the window leaves; and every batch's scores in the
window against ``(x - mean) W`` with the reference's mean and the
program's own basis (the fit is set-up; the refit cell holds the fit).
The band the whole window leaves is printed beside the reference's sum
of the pool's folds but not compared: after some thousands of float32
additions its rounding grows past a TF32 fold's error (PERF.md)."""

from __future__ import annotations

import torch

from wsnbench import compare, fields
from wsnbench import flat
from wsnbench.reference import band as rb
from wsnbench.reference import precision

Program, Control = flat.Program, flat.Control


class Driver:
    unit = "batch"

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, program=None):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = int(seed), device
        self.program = (program or Program)(cfg, device)
        self.n = cfg["batch_epochs"]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.program.build()
        g = torch.Generator(device=dev).manual_seed(self.seed)
        _, _, batch = fields.planted_field(cfg["p"], cfg["q"], dev, g)
        P = self.traffic["pool_batches"]
        self.pool = [batch(self.n) for _ in range(P)]
        v0 = torch.randn((cfg["p"], cfg["q"]), device=dev, generator=g)
        st = self.program.init()
        for x in self.pool:
            st = self.program.fold(st, x)
        view = self.program.state_view(st)
        self.mean = view["s"] / view["t"]
        self.W = self.program.refit(self.program.estimate(st), v0)[0]
        self.counts = [1] * P
        self.zs = [[] for _ in range(P)]
        self.state = st
        pick = torch.Generator().manual_seed(self.seed)
        self.sampled = int(torch.randint(self.traffic.get("sampled_from", 8), (1,),
                                         generator=pick))
        self.around = None
        self._unit(-1)              # the window's shapes, warmed
        self._sync()

    def _unit(self, i):
        from torch.autograd.profiler import record_function
        b = (i + 1) % len(self.pool)
        x = self.pool[b]
        with record_function("wsnbench.fold"):
            self.state = self.program.fold(self.state, x)
        with record_function("wsnbench.transform"):
            self.zs[b].append(self.program.transform(self.W, self.mean, x))
        self.counts[b] += 1

    def measure(self, window) -> dict:
        depth = self.traffic["in_flight"]
        ring = []

        def unit(i):
            if i == self.sampled:
                before = self.program.state_view(self.state)
                self._unit(i)
                self.around = ((i + 1) % len(self.pool), before,
                               self.program.state_view(self.state))
            else:
                self._unit(i)
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                ring.append(ev)
                if len(ring) > depth:
                    ring.pop(0).synchronize()

        window.run(unit, self._sync)
        return dict(seconds=window.elapsed, attempted=window.units,
                    readings=window.units * self.n * self.cfg["p"],
                    batches=window.units)

    def release(self) -> None:
        self.final = self.program.state_view(self.state)
        self.state = None

    def check(self) -> dict:
        h = self.cfg["halfwidth"]
        got = {}
        with precision(False):
            acc = None
            mean = None
            for b, x in enumerate(self.pool):
                f = flat.fold64(x, h)
                mean = f["s"] if mean is None else mean + f["s"]
                c = self.counts[b]
                acc = ({k: c * v for k, v in f.items()} if acc is None else
                       {k: acc[k] + c * v for k, v in f.items()})
                del f
            mean = mean / (len(self.pool) * self.n)
            valid = rb.valid(self.cfg["p"], h, self.device)
            got["window_band_err"] = compare.rel_err(self.final["band"],
                                                     acc["band"], valid)
            got["window_s_err"] = compare.rel_err(self.final["s"], acc["s"])
            got["t_err"] = abs(float(self.final["t"]) - float(acc["t"]))
            del acc
            if self.around is None:
                got["fold_err"] = float("inf")     # the window was too short
            else:
                b, before, after = self.around
                f = flat.fold64(self.pool[b], h)
                got["fold_err"] = compare.rel_err(
                    after["band"].double() - before["band"].double(),
                    f["band"], valid)
                got["fold_t_err"] = abs(float(after["t"]) - float(before["t"])
                                        - float(f["t"]))
                del f, before, after
                self.around = None
            W = self.W.double()
            z_err, n_z = 0.0, 0
            for b, x in enumerate(self.pool):
                if not self.zs[b]:
                    continue
                zr = (x.double() - mean[None, :]) @ W
                zp = torch.stack(self.zs[b])
                n_z += zp.shape[0]
                z_err = max(z_err, compare.rel_err(zp, zr.expand_as(zp)))
            got["z_err"] = z_err
            got["z_batches"] = n_z
        return got
