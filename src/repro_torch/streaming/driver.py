"""Stream drivers, per round and chunked (counterpart of
``repro.streaming.driver``).

* :func:`fleet_round_step` — ONE round for EVERY network of a fleet: the
  per-round band fold (one kernel launch for the fleet), one scheduler
  decision per network, the split compression/detection stages and the
  per-epoch Table-1 books.  :func:`stream_step` is the same for one
  network; :func:`stream_run` loops it over a (rounds, n, p) stream and
  :func:`batched_stream_run` (``chunk=None``) over a (networks, rounds,
  n, p) fleet — the reference's ``vmap`` of the scan, with the networks
  axis written out and taken by the kernels as a grid axis.
* :func:`sharded_stream_run` — :func:`batched_stream_run` with the
  networks axis split over the ranks of a ``torch.distributed`` group:
  each rank streams its contiguous slice, with no collective.
* :func:`fleet_chunk_step` — K rounds for every slot in one pass: the
  chunk fold, one decision per slot, the stages and the books.  It
  replaces the reference's vmapped, jitted ``engine_chunk_step_fn``.
  :func:`chunk_stream_step` is the same for ONE network;
  :func:`chunked_stream_run` and ``batched_stream_run(chunk=K)`` loop it,
  with the tail padded by invalid rounds.  At K = 1 it gives the
  per-round step's bits (``probe_every=1``).

With a compression and/or detection stage configured the chunk body is,
by default (``cfg.fused``), the fused kernel
(:func:`repro_torch.kernels.ops.fused_stream_update`): one launch emits
the band delta and the stage outputs against the pre-decision basis;
where the scheduler then fires, the stages are recomputed against the
rotated basis in plain torch and selected per slot with ``torch.where``.
The split body (``fused=False``, always for quantized scores,
``score_bits > 0``, whose quantizer needs every row's scores between
projection and reconstruction, and always per round) folds through the
band kernel, decides, and then runs the stages once against the
post-decision basis: the supervised-compression kernel (or projection,
quantizer, reconstruction) and the monitoring kernel.  A band-only
configuration folds through the band kernel
(:mod:`repro_torch.streaming.online_cov`).  Every decision's banded
products go through the banded-product kernel
(:mod:`repro_torch.streaming.scheduler`).

``precision="bf16"`` acts on the fused body alone, as in the reference:
the chunk is rounded to bf16 once, and the kernel's bf16 tile mode and the
post-refresh recompute both take that tensor (with the basis rounded
too); the statistics, the mean estimate and the books keep the fp32
chunk.  Every other body — split, quantized, band-only, per round —
ignores it and gives the bits it gives at fp32.

Under ``torch.profiler`` a step is four sibling spans
(:mod:`repro_torch.spans`): ``repro_torch.chunk.fold`` (the liveness and
the fold), ``.decide`` (the scheduler's decision and the round bill),
``.stages`` (the stages against the post-decision basis; once a stage on
the split body, between book lines) and ``.books`` (the compressor's and
the detector's books, the bills, the new state); a call's padding and
the stack of its outputs are ``repro_torch.fleet.stack``.

The drivers take per-round (…, rounds, p) liveness masks, as the
reference's do; per-reading dropout masks are taken by
:func:`repro_torch.streaming.online_cov.online_update` and
``online_update_chunk``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.faults import expected_transmissions
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.spans import span
from repro_torch.streaming.compressor import (CompressionConfig,
                                              RoundCompression,
                                              compress_round,
                                              compression_books,
                                              compression_round_cost,
                                              epoch_packet_split, row_mask)
from repro_torch.streaming.detector import (DetectionConfig, DetectorState,
                                            RoundDetection, detect_apply,
                                            detect_round,
                                            detection_packet_split,
                                            detector_init, inv_lambda,
                                            row_liveness)
from repro_torch.streaming.online_cov import (OnlineCovariance,
                                              online_apply_chunk,
                                              online_chunk_stats, online_init,
                                              online_update,
                                              online_update_chunk)
from repro_torch.streaming.scheduler import RecomputeScheduler, SchedulerState

__all__ = ["StreamConfig", "StreamState", "RoundMetrics", "random_bases",
           "stream_init", "batched_stream_init", "fleet_round_step",
           "stream_step", "stream_run", "batched_stream_run",
           "fleet_chunk_step", "chunk_stream_step", "chunked_stream_run",
           "sharded_stream_run", "tree_map"]

# the per-step functions of every driver (repolint's host-pull rule)
HOT_PATHS = ("fleet_chunk_step", "_decide_and_stage", "_churn",
             "fleet_round_step", "_fleet_round_run", "_fleet_chunked_run")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static configuration shared by every network of a fleet (the same
    fields as ``repro.streaming.driver.StreamConfig``; ``interpret`` is
    accepted and ignored — there is no interpret mode on this side)."""

    p: int
    q: int
    halfwidth: int
    forgetting: float = 1.0
    drift_threshold: float = 0.02
    refresh_iters: int = 8
    warmup_rounds: int = 10
    n_max: int = 8
    c_max: int = 4
    link_loss: float = 0.0
    max_retries: int = 3
    interpret: bool | None = None
    compression: CompressionConfig | None = None
    detection: DetectionConfig | None = None
    fused: bool = True
    precision: str = "fp32"

    def __post_init__(self):
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(
                f"precision must be 'fp32' or 'bf16', got {self.precision!r}")

    def scheduler(self) -> RecomputeScheduler:
        return RecomputeScheduler(
            q=self.q, drift_threshold=self.drift_threshold,
            refresh_iters=self.refresh_iters,
            warmup_rounds=self.warmup_rounds,
            n_max=self.n_max, c_max=self.c_max,
            link_loss=self.link_loss, max_retries=self.max_retries)

    @property
    def use_fused(self) -> bool:
        """The chunk body is the fused kernel: stages configured,
        ``fused`` set, and no quantizer (whose scales need every row's
        scores between projection and reconstruction)."""
        has_stage = self.compression is not None or self.detection is not None
        quantized = (self.compression is not None
                     and self.compression.score_bits > 0)
        return self.fused and has_stage and not quantized


class StreamState(NamedTuple):
    cov: OnlineCovariance
    sched: SchedulerState
    rounds: torch.Tensor             # (...) int32 rounds streamed so far
    alive: torch.Tensor              # (..., p) liveness seen last round
    det: DetectorState | None = None


class RoundMetrics(NamedTuple):
    """Per-chunk record (leading axes: the slots)."""

    rho: torch.Tensor                # retained fraction before any refresh
    did_refresh: torch.Tensor        # bool — the scheduler fired
    refreshes: torch.Tensor          # cumulative refresh count
    comm_packets: torch.Tensor       # cumulative communication (packets)
    compression: RoundCompression | None = None
    detection: RoundDetection | None = None


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensors of (nested) NamedTuples of one
    structure, leaf by leaf; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *leaves)
                            for leaves in zip(tree, *rest)))
    return fn(tree, *rest)


def _tree_stack(trees: list):
    """Stack a list of same-structure NamedTuples leaf by leaf."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_stack([t[i] for t in trees])
                             for i in range(len(first))))
    return torch.stack(trees)


def random_bases(slots: int | None, p: int, q: int, seed: int = 0,
                 device="cuda") -> torch.Tensor:
    """Orthonormal initial bases (slots, p, q) — or (p, q) for ``slots``
    None — from ``torch.Generator(seed)``, returned on ``device`` (drawn
    on the CPU so a seed gives the same bases on every device)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    shape = (p, q) if slots is None else (slots, p, q)
    A = torch.randn(shape, generator=g, dtype=torch.float32)
    return torch.linalg.qr(A).Q.to(dev)


def stream_init(cfg: StreamConfig, slots: int | None = None, *,
                init_bases: torch.Tensor | None = None, seed: int = 0,
                device="cuda") -> StreamState:
    """Fresh state for one network (``slots`` None) or a fleet of
    ``slots``: the initial bases are ``init_bases`` ((slots,) p, q) or
    drawn by :func:`random_bases`.  Switches fp32 matrix products to full
    fp32 (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(device)
    lead = () if slots is None else (slots,)
    if init_bases is None:
        init_bases = random_bases(slots, cfg.p, cfg.q, seed, device=dev)
    W0 = init_bases.to(device=dev, dtype=torch.float32)
    if W0.shape != lead + (cfg.p, cfg.q):
        raise ValueError(f"init_bases shape {tuple(W0.shape)} != "
                         f"{lead + (cfg.p, cfg.q)}")
    return StreamState(
        cov=online_init(cfg.p, cfg.halfwidth, lead, device=dev),
        sched=cfg.scheduler().init(W0),
        rounds=torch.zeros(lead, device=dev, dtype=torch.int32),
        alive=torch.ones(lead + (cfg.p,), device=dev),
        det=(detector_init(lead, device=dev)
             if cfg.detection is not None else None))


def _churn(state_alive, masks, rv):
    """Any liveness change across the chunk (vs. the last-seen liveness),
    counting only valid rounds; returns (churn, alive)."""
    alive = state_alive
    churn = torch.zeros(alive.shape[:-1], dtype=torch.bool,
                        device=alive.device)
    for t in range(masks.shape[-2]):
        changed = (masks[..., t, :] != alive).any(-1)
        if rv is None:
            churn = churn | changed
            alive = masks[..., t, :]
        else:
            v_t = rv[..., t] > 0
            churn = churn | (v_t & changed)
            alive = torch.where(v_t[..., None], masks[..., t, :], alive)
    return churn, alive


def fleet_chunk_step(cfg: StreamConfig, state: StreamState, x: torch.Tensor,
                     masks: torch.Tensor | None = None,
                     round_valid: torch.Tensor | None = None,
                     ) -> tuple[StreamState, RoundMetrics]:
    """K rounds for every slot: ``x`` (S, K, n, p) chunks, ``masks``
    (S, K, p) per-round liveness or None, ``round_valid`` (S, K) or None
    (every round real).  ``state`` leaves carry the leading slot axis.

    Invalid rounds (stream tail padding, idle slots) contribute nothing to
    the fold, the stages, the books or the round counter."""
    # the driver's fold: the chunk's liveness and validity, the band fold
    # (fused: with the stages against the pre-decision basis)
    with span("repro_torch.chunk.fold"):
        S, K, n, p = x.shape
        dev = x.device
        x = x.to(torch.float32)
        if masks is not None:
            if masks.shape != (S, K, p):
                raise ValueError(
                    f"the chunk driver takes (slots, K, p) liveness masks, "
                    f"as the reference's does, got {tuple(masks.shape)}; "
                    "per-reading dropout masks go to online_update_chunk")
            masks = masks.to(state.alive.dtype)
        has_stage = cfg.compression is not None or cfg.detection is not None
        if round_valid is None:
            rv = None
            live = torch.full((S,), float(K), device=dev)
        else:
            rv = round_valid.to(torch.float32)
            live = rv.sum(-1)
        if masks is None:
            churn = torch.zeros((S,), dtype=torch.bool, device=dev)
            alive = state.alive
        else:
            churn, alive = _churn(state.alive, masks, rv)
        # the stages' per-round validity: liveness x round validity (a
        # padded round is a dead round: no record, no flag); None = all live
        stage_mask = None
        if has_stage and (masks is not None or rv is not None):
            stage_mask = (torch.ones((S, K, p), device=dev) if masks is None
                          else masks)
            if rv is not None:
                stage_mask = stage_mask * rv[..., None]

        fused = mean_est = None
        if cfg.use_fused:
            with_c = cfg.compression is not None
            with_m = cfg.detection is not None
            w, beta_eff, delta_s, delta_tb = online_chunk_stats(
                state.cov, x, forgetting=cfg.forgetting, masks=masks,
                round_valid=rv)
            s_new = beta_eff[..., None] * state.cov.s + delta_s
            t_i_new = (beta_eff[..., None, None] * state.cov.t_band
                       + delta_tb)[..., cfg.halfwidth, :]
            mean_est = s_new / t_i_new.clamp(min=1.0)
            il = (inv_lambda(state.sched.lam, cfg.detection) if with_m
                  else torch.ones((S, cfg.q), device=dev))
            eps = cfg.compression.epsilon if with_c else 0.0
            # the kernel's tile operand, rounded once for the kernel and
            # the recompute (bf16 tile mode); the statistics keep the fp32
            # chunk
            tiles = ops.fused_tiles(x, cfg.precision)
            # ONE launch: band fold + stages against the pre-decision basis
            band_delta, *outs = ops.fused_stream_update(
                tiles, w, state.sched.W, mean_est, il,
                halfwidth=cfg.halfwidth, epsilon=eps, with_compress=with_c,
                with_monitor=with_m, mask=stage_mask,
                precision=cfg.precision)
            cov = online_apply_chunk(state.cov, band_delta, w, beta_eff,
                                     delta_s, delta_tb, n)
            fused = (outs, il, eps, tiles)
        else:
            cov = online_update_chunk(state.cov, x,
                                      forgetting=cfg.forgetting, masks=masks,
                                      round_valid=rv)
            if has_stage:
                mean_est = cov.s / cov.t_i.clamp(min=1.0)
    return _decide_and_stage(cfg, state, cov, x, churn, alive, stage_mask,
                             live, mean_est, fused)


def _decide_and_stage(cfg, state, cov, x, churn, alive, stage_mask, live,
                      mean_est, fused):
    """What follows the fold of ``x`` (S, K, n, p) into ``cov``: one
    scheduler decision per slot at the last folded round, the per-epoch
    books of the ``live`` (S,) rounds, and the stages against the
    post-decision basis — split (compression and monitoring launches), or
    the fused kernel's outputs ``fused`` = (outputs, inv_lambda, eps, the
    kernel's tile operand) recomputed where the decision fired."""
    S, K, n, p = x.shape
    dev = x.device
    with_c, with_m = cfg.compression is not None, cfg.detection is not None
    # the scheduler's layer: the drift probe, the refresh computed for every
    # slot (its eigh, the post-refresh probe, the selects), the round bill
    with span("repro_torch.chunk.decide"):
        live_i = live.to(torch.int32)
        sched_cfg = cfg.scheduler()
        # one decision at the boundary, indexed at the LAST folded round
        sched, rho, fired = sched_cfg.step(state.sched, cov,
                                           state.rounds + (live_i - 1), churn)
        # step() booked one per-round record; book the chunk's other rounds
        sched = sched._replace(comm_packets=sched.comm_packets
                               + (live - 1) * sched_cfg.round_cost())
    factor = expected_transmissions(cfg.link_loss, cfg.max_retries)

    def close(sched, compression, det_state, detection):
        return (StreamState(cov=cov, sched=sched,
                            rounds=state.rounds + live_i, alive=alive,
                            det=det_state),
                RoundMetrics(rho=rho, did_refresh=fired,
                             refreshes=sched.refreshes,
                             comm_packets=sched.comm_packets,
                             compression=compression, detection=detection))

    compression, det_state, detection = None, state.det, None
    if fused is not None:
        # the driver's stages against the post-decision basis
        with span("repro_torch.chunk.stages"):
            (z, x_hat, flags, t2, spe), il, eps, tiles = fused
            # where the decision fired the stages must see the rotated
            # basis (and its λ̂): recompute for every slot, select per slot
            il2 = inv_lambda(sched.lam, cfg.detection) if with_m else il
            re = ops.fused_stream_stages_blocked(
                tiles, sched.W, mean_est, il2, epsilon=eps,
                with_compress=with_c, with_monitor=with_m, mask=stage_mask,
                precision=cfg.precision)
            pick = lambda new, old: None if old is None else torch.where(
                fired.reshape((S,) + (1,) * (old.dim() - 1)), new, old)
            z, x_hat, flags, t2, spe = (pick(a, b) for a, b in
                                        zip(re, (z, x_hat, flags, t2, spe)))
        # the compressor's and the detector's books, the bills, the state
        with span("repro_torch.chunk.books"):
            xv = x.reshape(S, K * n, p)
            if with_c:
                mask2d = (1.0 if stage_mask is None
                          else row_mask(stage_mask, n))
                compression = compression_books(xv, z, x_hat, flags, mask2d,
                                                cfg.compression, cfg.q,
                                                cfg.c_max)
                sched, compression = _bill_compression(cfg, sched,
                                                       compression, live,
                                                       factor)
            if with_m:
                row_live = row_liveness(stage_mask, K, (S,), device=dev) \
                    .repeat_interleave(n, dim=-1)
                det_state, detection = detect_apply(t2, spe, row_live, cfg.q,
                                                    state.det, cfg.detection,
                                                    refreshed=fired)
                sched = _bill_detection(cfg, sched, detection, live, factor)
            return close(sched, compression, det_state, detection)
    # the split body: each stage once, against the POST-decision basis,
    # between the book lines
    with span("repro_torch.chunk.books"):
        xv = x.reshape(S, K * n, p)
    if with_c:
        with span("repro_torch.chunk.stages"):
            compression = compress_round(sched.W, mean_est, xv,
                                         cfg.compression, cfg.c_max,
                                         mask=stage_mask, n=n)
        with span("repro_torch.chunk.books"):
            sched, compression = _bill_compression(cfg, sched, compression,
                                                   live, factor)
    if with_m:
        with span("repro_torch.chunk.stages"):
            det_state, detection = detect_round(
                sched.W, mean_est, sched.lam, xv, state.det, cfg.detection,
                refreshed=fired, mask=stage_mask, n=n)
        with span("repro_torch.chunk.books"):
            sched = _bill_detection(cfg, sched, detection, live, factor)
    with span("repro_torch.chunk.books"):
        return close(sched, compression, det_state, detection)


def _bill_compression(cfg, sched, compression, live, factor):
    """The compression stage's packets on the bill, and its fixed A/F
    record (one epoch round) scaled to the ``live`` rounds of the chunk,
    as the reference does."""
    flagfree = compression_round_cost(cfg.q, cfg.c_max, cfg.compression)
    bill = (flagfree * live + compression.extra_packets) * factor
    sched = sched._replace(comm_packets=sched.comm_packets + bill)
    a_pk, f_pk = epoch_packet_split(cfg.q, cfg.c_max, cfg.compression)
    return sched, compression._replace(
        score_packets=compression.score_packets * live,
        feedback_packets=compression.feedback_packets * live,
        bits_on_air=compression.bits_on_air
        + (live - 1) * (a_pk + f_pk) * cfg.compression.word_bits)


def _bill_detection(cfg, sched, detection, live, factor):
    """The monitoring stage's packets on the bill: the flag-free record of
    every live round and each alarm's packets."""
    flagfree, per_alarm = detection_packet_split(cfg.q, cfg.c_max)
    bill = (flagfree * live + detection.alarms * per_alarm) * factor
    return sched._replace(comm_packets=sched.comm_packets + bill)


def fleet_round_step(cfg: StreamConfig, state: StreamState, x: torch.Tensor,
                     mask: torch.Tensor | None = None,
                     ) -> tuple[StreamState, RoundMetrics]:
    """ONE round for every network of a fleet (``repro.streaming.driver
    .stream_step`` with the networks axis written out): ``x`` (S, n, p),
    ``mask`` (S, p) sensor liveness or None.

    The round folds through the per-round band kernel (masked with a
    mask); a liveness change against the last-seen liveness is churn, a
    drift trigger; then one scheduler decision per network at
    ``state.rounds``, and the stages against the post-decision basis and
    the post-fold mean: :func:`compress_round` (the supervised-compression
    kernel, or projection, quantizer and reconstruction with
    ``score_bits > 0``) and :func:`detect_round` (the monitoring kernel),
    with the per-epoch books.  Equal to :func:`fleet_chunk_step` on
    one-round chunks: the same statistics, decision, stages and books."""
    # the driver's fold: the round's liveness and its band fold
    with span("repro_torch.chunk.fold"):
        S, n, p = x.shape
        x = x.to(torch.float32)
        stage_mask = None
        if mask is None:
            churn = torch.zeros((S,), dtype=torch.bool, device=x.device)
            alive = state.alive
        else:
            if mask.shape != (S, p):
                raise ValueError(f"the per-round driver takes (networks, p) "
                                 f"liveness masks, got {tuple(mask.shape)}")
            mask = mask.to(state.alive.dtype)
            churn = (mask != state.alive).any(-1)
            alive = mask
            stage_mask = mask[:, None, :]
        cov = online_update(state.cov, x, forgetting=cfg.forgetting,
                            mask=mask)
        mean_est = cov.s / cov.t_i.clamp(min=1.0)
        live = torch.ones((S,), device=x.device)
        x = x[:, None]
    return _decide_and_stage(cfg, state, cov, x, churn, alive, stage_mask,
                             live, mean_est, None)


def stream_step(cfg: StreamConfig, state: StreamState, x_round: torch.Tensor,
                mask: torch.Tensor | None = None,
                ) -> tuple[StreamState, RoundMetrics]:
    """One round for ONE network: ``x_round`` (n, p), ``mask`` (p,) or
    None — :func:`fleet_round_step` with a fleet of one."""
    return _one(fleet_round_step, cfg, state, x_round, mask)


def _one(step, cfg, state, *arrays):
    """``step`` on a fleet of one: a leading axis added to the state and
    every array (None stays None), and dropped from the results."""
    new, metrics = step(cfg, tree_map(lambda t: t[None], state),
                        *(None if a is None else a[None] for a in arrays))
    drop = lambda t: t[0]
    return tree_map(drop, new), tree_map(drop, metrics)


def chunk_stream_step(cfg: StreamConfig, state: StreamState,
                      x_chunk: torch.Tensor,
                      masks: torch.Tensor | None = None,
                      round_valid: torch.Tensor | None = None,
                      ) -> tuple[StreamState, RoundMetrics]:
    """K rounds for ONE network: ``x_chunk`` (K, n, p), ``masks`` (K, p),
    ``round_valid`` (K,) — :func:`fleet_chunk_step` with a fleet of one."""
    return _one(fleet_chunk_step, cfg, state, x_chunk, masks, round_valid)


def _fleet_round_run(cfg, states, xs, masks):
    """The per-round loop over a fleet: ``xs`` (N, R, n, p), ``masks``
    (N, R, p) or None; metrics (N, R, ...)."""
    rows = []
    for r in range(xs.shape[1]):
        states, m = fleet_round_step(cfg, states, xs[:, r],
                                     None if masks is None else masks[:, r])
        rows.append(m)
    # the call's outputs, stacked (the driver's call loop)
    with span("repro_torch.fleet.stack"):
        return states, tree_map(lambda t: t.movedim(0, 1),
                                _tree_stack(rows))


def _fleet_chunked_run(cfg, states, xs, masks, chunk, probe_every):
    """The chunk loop over a fleet: ``probe_every`` rounds (default
    ``chunk``) per :func:`fleet_chunk_step`, the tail padded with invalid
    rounds; metrics (N, decisions, ...)."""
    N, R = xs.shape[:2]
    step_rounds = chunk if probe_every is None else probe_every
    if chunk < 1 or step_rounds < 1:
        raise ValueError(f"chunk/probe_every must be >= 1, got "
                         f"{chunk}/{probe_every}")
    if chunk % step_rounds != 0:
        raise ValueError(
            f"probe_every ({step_rounds}) must divide chunk ({chunk})")
    S = step_rounds
    n_steps = -(-R // S)
    pad = n_steps * S - R
    rv = None
    if pad:
        # the tail padded with invalid rounds (the driver's call loop)
        with span("repro_torch.fleet.stack"):
            zeros = lambda a: a.new_zeros((N, pad) + a.shape[2:])
            xs = torch.cat([xs, zeros(xs)], 1)
            if masks is not None:
                masks = torch.cat([masks, zeros(masks)], 1)
            rv = torch.cat([torch.ones(R, device=xs.device),
                            torch.zeros(pad, device=xs.device)])
            rv = rv.expand(N, n_steps * S)
    rows = []
    for i in range(n_steps):
        sl = slice(i * S, (i + 1) * S)
        states, m = fleet_chunk_step(
            cfg, states, xs[:, sl], None if masks is None else masks[:, sl],
            None if rv is None else rv[:, sl])
        rows.append(m)
    # the call's outputs, stacked (the driver's call loop)
    with span("repro_torch.fleet.stack"):
        return states, tree_map(lambda t: t.movedim(0, 1),
                                _tree_stack(rows))


def stream_run(cfg: StreamConfig, state: StreamState, xs: torch.Tensor,
               masks: torch.Tensor | None = None,
               ) -> tuple[StreamState, RoundMetrics]:
    """Stream ``xs`` (rounds, n, p) round by round through
    :func:`stream_step`, ``masks`` (rounds, p) the liveness schedule or
    None; metrics come back stacked, one row per round."""
    return _one(_fleet_round_run, cfg, state, xs, masks)


def chunked_stream_run(cfg: StreamConfig, state: StreamState,
                       xs: torch.Tensor, masks: torch.Tensor | None = None,
                       *, chunk: int = 8, probe_every: int | None = None,
                       ) -> tuple[StreamState, RoundMetrics]:
    """Stream ``xs`` (rounds, n, p) through :func:`chunk_stream_step`,
    ``probe_every`` rounds per decision (default: the whole chunk); a
    tail shorter than the step is padded with invalid rounds.  Metrics
    come back stacked, one row per decision.  ``probe_every=1`` gives
    :func:`stream_run`'s bits."""
    run = lambda c, s, x, m: _fleet_chunked_run(c, s, x, m, chunk,
                                                probe_every)
    return _one(run, cfg, state, xs, masks)


def batched_stream_init(cfg: StreamConfig, n_networks: int, *,
                        W0: torch.Tensor | None = None, seed: int = 0,
                        device="cuda") -> StreamState:
    """Per-network states stacked on a leading networks axis, the initial
    bases ``W0`` (n_networks, p, q) or drawn from ``seed``
    (:func:`stream_init` with ``slots=n_networks``)."""
    return stream_init(cfg, n_networks, init_bases=W0, seed=seed,
                       device=device)


def batched_stream_run(cfg: StreamConfig, states: StreamState,
                       xs: torch.Tensor, masks: torch.Tensor | None = None,
                       *, chunk: int | None = None,
                       probe_every: int | None = None,
                       ) -> tuple[StreamState, RoundMetrics]:
    """Stream a fleet: ``xs`` (networks, rounds, n, p), ``masks``
    (networks, rounds, p) liveness or None; metrics come back as
    (networks, rounds) leaves (``repro.streaming.driver
    .batched_stream_run``).

    ``chunk=None`` is the per-round path: one :func:`fleet_round_step` a
    round for the whole fleet — one fold launch, one decision with its
    refresh computed for every network and selected, one launch per
    stage.  ``chunk=K`` is the chunk path (:func:`fleet_chunk_step`, K or
    ``probe_every`` rounds per decision, metrics per decision);
    ``probe_every`` needs ``chunk``."""
    if chunk is None:
        if probe_every is not None:
            raise ValueError("probe_every requires chunk (the per-round "
                             "path has no dispatch granularity to probe)")
        return _fleet_round_run(cfg, states, xs, masks)
    return _fleet_chunked_run(cfg, states, xs, masks, chunk, probe_every)


def sharded_stream_run(cfg: StreamConfig, group, states: StreamState,
                       xs: torch.Tensor, *, chunk: int | None = None,
                       probe_every: int | None = None,
                       ) -> tuple[StreamState, RoundMetrics]:
    """:func:`batched_stream_run` with the networks axis split over the
    ranks of the process group ``group`` (``repro.streaming.driver
    .sharded_stream_run`` over a mesh axis): ``states`` and ``xs``
    (networks, rounds, n, p) are the whole fleet, the same on every rank;
    rank r streams its contiguous slice
    (:func:`repro_torch.distributed.sharding.shard_networks`, which raises
    when the ranks do not divide the networks) and returns that slice's
    final states and metrics.  No collective: the networks are
    independent."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import shard_networks

    rank, world = dist.get_rank(group), dist.get_world_size(group)
    return batched_stream_run(cfg, shard_networks(states, rank, world),
                              shard_networks(xs, rank, world), chunk=chunk,
                              probe_every=probe_every)


# ===========================================================================
# Program contracts (checked by ``python -m repro_torch.analysis.check``).
# Each runs its entry point once under the op recorder: at a tiny size on
# the CPU, at the engine's widths on the card (one wsn-1m region a slot).
# The refresh's banded products are kernel 10's (1 + refresh_iters + 2 a
# decision), where the reference's refresh is plain jnp and counts none.
# ===========================================================================
from repro_torch.analysis import contracts as _contracts  # noqa: E402
from repro_torch.analysis import op_lint as _ol  # noqa: E402
from repro_torch.analysis import resources as _res  # noqa: E402

_REFRESH_ITERS = 8
_DECISION = 1 + _REFRESH_ITERS + 2         # kernel 10 launches a decision


def _contract_dims(dev):
    """(slots, p, q, h, n) of the contracts: tiny on the CPU (the
    reference's p = 12, q = 3, h = 2, n = 4), the engine's on the card."""
    return (8, 1024, 32, 128, 32) if dev.type == "cuda" else (2, 12, 3, 2, 4)


def _contract_cfg(dev, *, fused=True, stages=True,
                  precision="fp32") -> StreamConfig:
    _, p, q, h, _ = _contract_dims(dev)
    return StreamConfig(
        p=p, q=q, halfwidth=h, warmup_rounds=4, refresh_iters=_REFRESH_ITERS,
        compression=CompressionConfig(epsilon=0.5) if stages else None,
        detection=(DetectionConfig(alpha=1e-3, calib_rounds=3) if stages
                   else None),
        fused=fused, precision=precision)


def _contract_data(dev, shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


def _chunk_body(dev, ks=(1, 4, 8), **kw):
    """One decision's chunk body (``fleet_chunk_step``) on fresh fleet
    states, past warmup so the refresh fires, at each K of ``ks``."""
    S, p, _, _, n = _contract_dims(dev)
    cfg = _contract_cfg(dev, **kw)

    def body(k):
        st = stream_init(cfg, S, device=dev)
        st = st._replace(rounds=st.rounds + cfg.warmup_rounds)
        x = _contract_data(dev, (S, k, n, p))
        return lambda: fleet_chunk_step(cfg, st, x)
    return {f"K={k}": body(k) for k in ks}


def _stream_runs(dev, **variants):
    """Whole runs of 8 rounds for one network: ``{label: (driver, cfg)}``
    with driver "rounds" (``stream_run``) or a chunk size."""
    _, p, _, _, n = _contract_dims(dev)
    xs = _contract_data(dev, (8, n, p))
    out = {}
    for label, (chunk, cfg) in variants.items():
        st = stream_init(cfg, device=dev)
        out[label] = (
            (lambda c=cfg, s=st: stream_run(c, s, xs)) if chunk is None else
            (lambda c=cfg, s=st, k=chunk: chunked_stream_run(c, s, xs,
                                                             chunk=k)))
    return out


_BODY_RULES = (_ol.KernelBudget("banded_matmul", exact=_DECISION),
               _ol.OpBudget(_ol.EIGH_OP, max=1), _ol.NoHostRead(),
               _ol.NoF64(), _res.HbmTrafficBudget())

_contracts.register(_contracts.Contract(
    id="chunk.body",
    where="repro_torch.streaming.driver.fleet_chunk_step",
    claim="the band-only chunk body launches kernel 2 once and kernel 10 "
          "1 + refresh_iters + 2 times a decision, independent of K; at "
          "most one eigh; no host read",
    run=lambda dev: _chunk_body(dev, stages=False),
    rules=(_ol.KernelBudget("band_fold", exact=1),) + _BODY_RULES,
))

_contracts.register(_contracts.Contract(
    id="chunk.fused.fp32",
    where="repro_torch.streaming.driver.fleet_chunk_step",
    claim="with both stages configured the chunk body launches kernel 1 "
          "once (fold and stages in one launch), plus the decision's "
          "kernel-10 products",
    run=lambda dev: _chunk_body(dev),
    rules=(_ol.KernelBudget("fused_stream", exact=1),) + _BODY_RULES,
))

_contracts.register(_contracts.Contract(
    id="chunk.fused.bf16",
    where="repro_torch.streaming.driver.fleet_chunk_step",
    claim="the bf16 fused body launches kernel 1's bf16 tile mode once and "
          "keeps every accumulator fp32 (bf16 is a tile format only)",
    run=lambda dev: _chunk_body(dev, precision="bf16"),
    rules=(_ol.KernelBudget("fused_stream_bf16", exact=1),
           _ol.Fp32Accumulators()) + _BODY_RULES,
))

_contracts.register(_contracts.Contract(
    id="chunk.body.split",
    where="repro_torch.streaming.driver.fleet_chunk_step",
    claim="the split (fused=False) chunk body pays exactly the three "
          "launches kernel 1 collapses: fold, kernel 4, kernel 5",
    run=lambda dev: _chunk_body(dev, ks=(4,), fused=False),
    rules=(_ol.KernelBudget("band_fold", exact=1),
           _ol.KernelBudget("supervised_compress", exact=1),
           _ol.KernelBudget("pca_monitor", exact=1)) + _BODY_RULES,
))

_contracts.register(_contracts.Contract(
    id="driver.hot-loop",
    where="repro_torch.streaming.driver.chunked_stream_run",
    claim="8 rounds in chunks of 4: the body's launches x 2 steps, and no "
          "host read in the loop",
    run=lambda dev: _stream_runs(
        dev, **{"R=8,chunk=4": (4, _contract_cfg(dev, stages=False))}),
    rules=(_ol.KernelBudget("band_fold", exact=2),
           _ol.KernelBudget("banded_matmul", exact=2 * _DECISION),
           _ol.NoHostRead(), _ol.NoF64(), _res.HbmTrafficBudget()),
))

_contracts.register(_contracts.Contract(
    id="dtype.policy",
    where="repro_torch.streaming.driver",
    claim="no f64 anywhere on the streaming paths; bf16 never leaves the "
          "tile operands (every state and metric stays fp32)",
    run=lambda dev: _stream_runs(dev, **{
        "stream_run": (None, _contract_cfg(dev, stages=False)),
        "chunked-fp32": (4, _contract_cfg(dev)),
        "chunked-bf16": (4, _contract_cfg(dev, precision="bf16"))}),
    rules=(_ol.NoF64(), _ol.Fp32Accumulators()),
))


def _bill_runs(dev):
    """``stream_run`` over 16 rounds at link loss 0 and 0.1 (the
    reference's TestSchedulerBillMatchesCostModel configuration)."""
    g = torch.Generator(device=dev).manual_seed(0)
    xs = torch.randn((16, 6, 12), generator=g, device=dev)
    out = {}
    for loss in (0.0, 0.1):
        cfg = StreamConfig(p=12, q=3, halfwidth=2, forgetting=0.95,
                           drift_threshold=0.05, warmup_rounds=4,
                           link_loss=loss)
        st = stream_init(cfg, seed=1, device=dev)
        out[f"link_loss={loss}"] = (
            lambda c=cfg, s=st: (c, stream_run(c, s, xs)[0]))
    return out


def _bill_matches_cost_model(records):
    rows = []
    for label, rec in records.items():
        cfg, fin = rec.result
        sched = cfg.scheduler()
        refreshes = int(fin.sched.refreshes)
        want = 16 * sched.round_cost() + refreshes * sched.refresh_cost(cfg.p)
        got = float(fin.sched.comm_packets)
        ok = refreshes >= 1 and abs(got - want) <= 1e-5 * abs(want)
        rows.append(_contracts.RuleResult(
            "scheduler.bill", f"bill[{label}]", ok,
            f"comm_packets {got} vs rounds x round_cost + refreshes "
            f"({refreshes}) x refresh_cost = {want} (rtol 1e-5; want >= 1 "
            f"refresh)"))
    return rows


_contracts.register(_contracts.Contract(
    id="scheduler.bill",
    where="repro_torch.streaming.driver.stream_run",
    claim="the booked bill equals the cost model: rounds x round_cost + "
          "refreshes x refresh_cost, lossless and at 10% link loss",
    run=_bill_runs,
    runtime=_bill_matches_cost_model,
))
