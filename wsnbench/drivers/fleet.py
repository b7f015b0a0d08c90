"""The region fleet: ``repro_torch.streaming.batched_stream_run`` on
successive segments of rounds of every network held on the card, in a
closed loop (each call dispatched when the last returns), the networks'
states carried from call to call.

Data: ``segments`` segments of ``segment_rounds`` rounds of every
network, made on the card from the seed by the local field
(:func:`wsnbench.fields.signal_rounds`) and streamed in turn.  Set-up
streams the first segment from the networks' initial bases (the start);
the window streams the others in turn, then the first again, and so on.

The check, after the window, against :mod:`wsnbench.reference.fleet` in
float64 (every number is listed in the cell's limits file):

* ``start_*``: the set-up's call, from the initial bases, against the
  reference run from the same bases on the same segment;
* ``carry_*``: the covariance statistics the window's calls carried up
  to its last call, against the reference's statistics of the same
  segments (the statistics are linear in the folds: each call decays the
  carried sums by beta^rounds and adds its segment's fold);
* ``last_*``: the window's last call, against the reference run from the
  program's own state before that call (what the program's state holds
  beyond the statistics, its bases, variances and detector windows,
  follows from calls the reference does not repeat).
"""

from __future__ import annotations

import math

import torch

from wsnbench import compare, fields
from wsnbench.reference import fleet as ref
from wsnbench.reference import precision


def spec_of(cfg: dict) -> ref.Spec:
    return ref.Spec(
        p=cfg["region_p"], q=cfg["q"], h=cfg["halfwidth"],
        n=cfg["epochs_per_round"], K=cfg["chunk_rounds"],
        forgetting=cfg["forgetting"], drift_threshold=cfg["drift_threshold"],
        refresh_iters=cfg["refresh_iters"],
        warmup_rounds=cfg["warmup_rounds"], epsilon=cfg["epsilon"],
        alpha=cfg["alpha"], calib_rounds=cfg["calib_rounds"])


class Program:
    """The port's fleet path at the configuration's settings."""

    def __init__(self, cfg: dict, device: torch.device):
        from repro_torch.streaming import (CompressionConfig,
                                           DetectionConfig, StreamConfig)
        self.cfg = cfg
        self.device = device
        self.scfg = StreamConfig(
            p=cfg["region_p"], q=cfg["q"], halfwidth=cfg["halfwidth"],
            forgetting=cfg["forgetting"],
            drift_threshold=cfg["drift_threshold"],
            refresh_iters=cfg["refresh_iters"],
            warmup_rounds=cfg["warmup_rounds"],
            compression=CompressionConfig(epsilon=cfg["epsilon"],
                                          emit_reconstruction=True),
            detection=DetectionConfig(alpha=cfg["alpha"],
                                      calib_rounds=cfg["calib_rounds"]),
            fused=cfg["fused"], precision=cfg["precision"])

    def build(self) -> None:
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build_all()

    def init(self, W0: torch.Tensor):
        from repro_torch.streaming import batched_stream_init
        return batched_stream_init(self.scfg, W0.shape[0], W0=W0,
                                   device=self.device)

    def run(self, state, xs: torch.Tensor):
        from repro_torch.streaming import batched_stream_run
        return batched_stream_run(self.scfg, state, xs,
                                  chunk=self.cfg["chunk_rounds"])

    @staticmethod
    def state_view(st) -> dict:
        """The program's state in the reference's names."""
        c, s, d = st.cov, st.sched, st.det
        return dict(t=c.t, s=c.s, band=c.band, t_band=c.t_band, W=s.W,
                    rho_ref=s.rho_ref, refreshes=s.refreshes.long(),
                    lam=s.lam, rounds=st.rounds.long(),
                    t2_threshold=d.t2_threshold,
                    spe_threshold=d.spe_threshold,
                    calib_left=d.calib_left.long(), t2_sum=d.t2_sum,
                    t2_sumsq=d.t2_sumsq, spe_sum=d.spe_sum,
                    spe_sumsq=d.spe_sumsq, count=d.count)

    @staticmethod
    def out_view(out) -> dict:
        """A call's outputs, (S, chunks, ...) each."""
        c, d = out.compression, out.detection
        return dict(fired=out.did_refresh.bool(), z=c.z, x_sink=c.x_sink,
                    flags=c.flagged > 0, t2=d.t2, spe=d.spe,
                    events=d.events > 0, alarms=d.alarms)


class Control(Program):
    """The reference in the program's place, in float32 with TF32
    products: the control that the comparison must fail."""

    def build(self) -> None:
        pass

    def init(self, W0: torch.Tensor):
        return ref.init(spec_of(self.cfg), W0.float())

    def run(self, state, xs: torch.Tensor):
        with precision(True):
            st, recs = ref.run(spec_of(self.cfg), state, xs.float())
        return st, recs

    @staticmethod
    def state_view(st) -> dict:
        return st

    @staticmethod
    def out_view(recs) -> dict:
        keys = ("fired", "z", "x_sink", "flags", "t2", "spe", "events",
                "alarms")
        return {k: torch.stack([r[k] for r in recs], 1) for k in keys}


class Driver:
    unit = "call"

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, program=None):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = int(seed), device
        self.program = (program or Program)(cfg, device)
        self.S = cfg["n_regions"]
        self.R = traffic["segment_rounds"]

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        cfg, tr, dev = self.cfg, self.traffic, self.device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.program.build()
        g = torch.Generator(device=dev).manual_seed(self.seed)
        p, q, n = cfg["region_p"], cfg["q"], cfg["epochs_per_round"]
        U, scale = fields.local_field(p, tr["signal_rank"], dev)
        mean = tr["mean_sd"] * torch.randn((self.S, p), device=dev,
                                           generator=g)
        self.segs = [fields.signal_rounds(
            g, U, scale, mean, self.R, n, noise=tr["noise"],
            spike_rate=tr["spike_rate"], spike=tr["spike"])
            for _ in range(tr["segments"])]
        self.W0 = torch.linalg.qr(torch.randn((self.S, p, q), device=dev,
                                              generator=g)).Q
        # the start: the first segment from the initial bases (this call
        # also warms every shape of the window)
        st, out = self.program.run(self.program.init(self.W0), self.segs[0])
        self._sync()
        self.start = (self.program.state_view(st),
                      self.program.out_view(out))
        self.state, self.calls = st, 1

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- the window ---------------------------------------------------------
    def measure(self, window) -> dict:
        nseg = len(self.segs)
        self.last = None

        def unit(i):
            k = (self.calls + i) % nseg
            prev = self.state
            self.state, out = self.program.run(prev, self.segs[k])
            self.last = (prev, k, out)

        window.run(unit, self._sync)
        self.calls += window.units
        S, R = self.S, self.R
        n, p = self.cfg["epochs_per_round"], self.cfg["region_p"]
        return dict(seconds=window.elapsed, attempted=window.units,
                    readings=window.units * S * R * n * p,
                    chunks=window.units * R // self.cfg["chunk_rounds"])

    def release(self) -> None:
        prev, k, out = self.last
        self.last = (self.program.state_view(prev), k,
                     self.program.out_view(out),
                     self.program.state_view(self.state))
        self.state = None

    # -- the check ----------------------------------------------------------
    def check(self) -> dict:
        spec = spec_of(self.cfg)
        r = self.traffic["signal_rank"]
        got = {}
        with precision(False):
            x0 = self.segs[0].double()
            st1, sure = self._follow(spec, ref.init(spec, self.W0.double()),
                                     x0, self.segs[0], self.start[1], got,
                                     "start_", r)
            self._states(self.start[0], st1, sure, got, "start_", r)
            del x0
            # the statistics carried to the last call
            prev, k, out, final = self.last
            folds = [self._fold(spec, seg) for seg in self.segs]
            beta = spec.forgetting ** self.R
            carry = {f: torch.zeros_like(v) for f, v in folds[0].items()}
            for c in range(self.calls - 1):
                carry = {f: beta * carry[f] + folds[c % len(folds)][f]
                         for f in carry}
            for f in ("band", "t_band", "s", "t"):
                got[f"carry_{f}_err"] = compare.rel_err(prev[f], carry[f])
            del folds, carry
            st0 = {f: (v.double() if v.is_floating_point() else v)
                   for f, v in prev.items()}
            stN, sure = self._follow(spec, st0, self.segs[k].double(),
                                     self.segs[k], out, got, "last_", r)
            self._states(final, stN, sure, got, "last_", r)
        return got

    def _fold(self, spec, seg) -> dict:
        st = ref.init(spec, seg.new_zeros((seg.shape[0], spec.p, spec.q),
                                          dtype=torch.float64))
        st = {f: st[f] for f in ("t", "s", "band", "t_band")}
        for c in range(seg.shape[1] // spec.K):
            st = ref.fold_chunk(spec, st, seg[:, c * spec.K:(c + 1) * spec.K]
                                .double())
        return st

    def _follow(self, spec, st, xs, seg, out, got, tag, r):
        """The reference streamed over ``xs`` (float64; ``seg`` the same
        readings as the program read them) from ``st``, each chunk's
        record held against the program's outputs ``out``.  Returns the
        reference's state and the networks whose every decision was clear
        of the drift threshold (a decision within 1e-3 of it may go either
        way, and the network's later state with it)."""
        m = dict(fired_diff=0, flag_diff=0, event_diff=0, eps_excess=-1e30,
                 z_err=0.0, xsink_err=0.0, t2_err=0.0, spe_err=0.0)
        K, eps = spec.K, spec.epsilon
        S = xs.shape[0]
        dev = xs.device
        fired_any = torch.zeros(S, dtype=torch.bool, device=dev)
        sure = torch.ones(S, dtype=torch.bool, device=dev)
        for c in range(xs.shape[1] // K):
            sl = slice(c * K, (c + 1) * K)
            first = st["refreshes"] == 0
            st, rec = ref.chunk_step(spec, st, xs[:, sl])
            sure &= first | ((rec["drift"] - spec.drift_threshold).abs()
                             > 1e-3)
            fp = out["fired"][:, c]
            m["fired_diff"] += int(((fp != rec["fired"]) & sure).sum())
            fired_any |= fp | rec["fired"]
            # the guarantee, in the program's own precision
            xv = seg[:, sl].reshape(out["x_sink"][:, c].shape)
            gap = float((xv - out["x_sink"][:, c]).abs().max()) - eps
            m["eps_excess"] = max(m["eps_excess"],
                                  math.inf if math.isnan(gap) else gap)
            # a flag whose residual lies within 0.02 of eps may go either way
            clear = ((xs[:, sl].reshape(xv.shape) - rec["x_hat"]).abs()
                     - eps).abs() > 0.02
            m["flag_diff"] += int(((out["flags"][:, c] != rec["flags"])
                                   & clear & sure[:, None, None]).sum())
            # the signal's scores, each column's sign free
            zp = out["z"][:, c, :, :r].double()
            zr = rec["z"][..., :r]
            sg = torch.sign((zp * zr).sum(-2, keepdim=True))
            m["z_err"] = max(m["z_err"], compare.rel_err(
                zp * torch.where(sg == 0, 1.0, sg), zr, sure))
            # where no decision fired in the call, the basis is the one the
            # call started from and every stage output is held
            same = (out["flags"][:, c] == rec["flags"]) & sure[:, None, None]
            m["sink_err_all"] = max(m.get("sink_err_all", 0.0),
                                    compare.rel_err(out["x_sink"][:, c],
                                                    rec["x_sink"], same))
            keep = ~fired_any & sure
            if bool(keep.any()):
                m["xsink_err"] = max(m["xsink_err"], compare.rel_err(
                    out["x_sink"][:, c], rec["x_sink"],
                    same & keep[:, None, None]))
                m["t2_err"] = max(m["t2_err"], compare.rel_err(
                    out["t2"][:, c][keep], rec["t2"][keep]))
                m["spe_err"] = max(m["spe_err"], compare.rel_err(
                    out["spe"][:, c][keep], rec["spe"][keep]))
                apart = lambda a, t: ((a - t[:, None]).abs()
                                      > 1e-4 * t[:, None].abs())
                sure_ev = (apart(rec["t2"], rec["t2_thr"])
                           & apart(rec["spe"], rec["spe_thr"]))
                ev = (out["events"][:, c] != rec["events"]) & sure_ev
                m["event_diff"] += int(ev[keep].sum())
            del rec
        m["held_networks"] = int((~fired_any & sure).sum())
        m["unsure_networks"] = int((~sure).sum())
        for f, v in m.items():
            got[tag + f] = v
        return st, sure

    @staticmethod
    def _states(prog: dict, st: dict, sure: torch.Tensor, got: dict,
                tag: str, r: int) -> None:
        """The program's state after a call against the reference's, the
        statistics of every network, the rest of the networks whose
        decisions were clear."""
        for f in ("band", "t_band", "s", "t"):
            got[f"{tag}{f}_err"] = compare.rel_err(prog[f], st[f])
        prog = {f: v[sure] for f, v in prog.items()}
        st = {f: v[sure] for f, v in st.items()}
        got[tag + "refresh_diff"] = int(
            (prog["refreshes"] != st["refreshes"]).sum())
        got[tag + "basis_sine"] = float(compare.subspace_sine(
            prog["W"][..., :r], st["W"][..., :r]).max())
        got[tag + "lam_err"] = compare.max_rel_each(prog["lam"][:, :r],
                                                    st["lam"][:, :r])
        got[tag + "rho_err"] = float((prog["rho_ref"].double()
                                      - st["rho_ref"]).abs().max())
        got[tag + "calib_diff"] = int(
            (prog["calib_left"] != st["calib_left"]).sum())
        for f in ("t2_threshold", "spe_threshold"):
            a, b = prog[f].double(), st[f]
            fin = torch.isfinite(b)
            got[f"{tag}{f}_err"] = (
                compare.max_rel_each(a[fin], b[fin])
                if bool((torch.isfinite(a) == fin).all()) else float("inf"))
