"""Hierarchical two-level streaming decomposition (counterpart of
``repro.streaming.hierarchy``).

* **Level 1 (within a rank, no cross-rank traffic):** every region streams
  its own online banded covariance and drift-triggered refreshes through
  :func:`repro_torch.streaming.driver.batched_stream_run`.
* **Level 2 (across ranks, one collective of each kind a run):** the fleet
  basis is the block-diagonal embedding of per-region components selected
  globally by subspace energy.  Each rank computes its regions' records
  (:func:`region_energies`: one banded-product launch), ONE ``all_gather``
  assembles the (regions, q) energy table, and ONE ``all_reduce`` carries
  the trace partial and the per-boundary refresh counts in a single tensor
  (the reference's multi-operand ``psum``); every rank then computes the
  same :func:`merge_fleet` selection.

The reference's ``shard_map`` over a ``region`` mesh axis becomes one
process per device with a ``torch.distributed`` process group standing in
for the axis (:mod:`repro_torch.launch.mesh`); the collectives issued are
counted in :data:`COLLECTIVES`, their payloads in
:data:`COLLECTIVE_ELEMS`.  With one region the run is the flat
driver bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import costs
from repro_torch.kernels import ops
from repro_torch.streaming.driver import (RoundMetrics, StreamConfig,
                                          StreamState, batched_stream_init,
                                          batched_stream_run)
from repro_torch.streaming.online_cov import (online_estimate,
                                              online_total_variance)

__all__ = ["COLLECTIVES", "COLLECTIVE_ELEMS", "reset_collectives",
           "FleetBasis", "FleetMerge", "region_energies", "merge_fleet", "fleet_basis_dense",
           "hierarchical_stream_init", "hierarchical_stream_run"]

COLLECTIVES = {"all_gather": 0, "all_reduce": 0}
# the elements this rank put into each kind of collective
COLLECTIVE_ELEMS = {"all_gather": 0, "all_reduce": 0}


def reset_collectives() -> None:
    for d in (COLLECTIVES, COLLECTIVE_ELEMS):
        for k in d:
            d[k] = 0


class FleetBasis(NamedTuple):
    """The fleet-level basis in compact (region, column) form: component
    ``j`` is column ``col[j]`` of region ``region[j]``'s basis, embedded at
    that region's sensor offset (:func:`fleet_basis_dense`)."""

    region: torch.Tensor          # (q_fleet,) int32 owning region
    col: torch.Tensor             # (q_fleet,) int32 column in that region
    lam: torch.Tensor             # (q_fleet,) subspace energies, descending
    rho: torch.Tensor             # () fleet retained fraction
    lam_table: torch.Tensor       # (regions, q_local) gathered records
    total_variance: torch.Tensor  # () sum of the regions' trace partials


class FleetMerge(NamedTuple):
    """Level-2 output of a hierarchical run: basis and merge accounting."""

    basis: FleetBasis
    merge_epochs: torch.Tensor    # () int32 cross-rank merges booked
    merge_packets: torch.Tensor   # () region-head Table-1 bill, lossy-scaled


def region_energies(state, cw: torch.Tensor | None = None,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (..., q) live subspace energies ``diag(W^T C W)`` of a region's
    basis plus its trace partial — what a region head sends up; ``C W``
    is one banded-product launch on the band estimate, or ``cw`` where
    the caller has it already."""
    W = state.sched.W
    if cw is None:
        cw = ops.banded_matmul(online_estimate(state.cov), W)
    return (W * cw).sum(-2), online_total_variance(state.cov)


def merge_fleet(lam_table: torch.Tensor, total_variance: torch.Tensor,
                q_fleet: int) -> FleetBasis:
    """Select the global top-``q_fleet`` components by subspace energy from
    the (regions, q_local) table; ``total_variance`` is the fleet's trace.
    The sort is stable, as ``jnp.argsort``: among equal energies the lower
    (region, column) comes first."""
    n_regions, q_local = lam_table.shape
    if q_fleet > n_regions * q_local:
        raise ValueError(
            f"q_fleet={q_fleet} > regions*q_local={n_regions * q_local}")
    flat = lam_table.reshape(-1)
    order = torch.argsort(-flat, stable=True)[:q_fleet]
    lam = flat[order]
    return FleetBasis(
        region=torch.div(order, q_local, rounding_mode="floor").to(
            torch.int32),
        col=(order % q_local).to(torch.int32),
        lam=lam,
        rho=lam.sum() / total_variance.clamp(min=1e-30),
        lam_table=lam_table,
        total_variance=total_variance)


def fleet_basis_dense(basis: FleetBasis,
                      W_regions: torch.Tensor) -> torch.Tensor:
    """The (regions * p_region, q_fleet) block-embedded fleet basis from the
    (regions, p_region, q_local) stack of local bases."""
    n_regions, p_region, _ = W_regions.shape
    q_fleet = basis.region.shape[0]
    region, col = basis.region.long(), basis.col.long()
    dense = W_regions.new_zeros((q_fleet, n_regions, p_region))
    dense[torch.arange(q_fleet, device=region.device), region] = \
        W_regions[region, :, col]
    return dense.reshape(q_fleet, n_regions * p_region).T


def hierarchical_stream_init(cfg: StreamConfig, n_regions: int, *,
                             W0: torch.Tensor | None = None, seed: int = 0,
                             device="cuda") -> StreamState:
    """Per-region states stacked on a leading regions axis (``cfg.p`` is the
    sensor count of ONE region)."""
    return batched_stream_init(cfg, n_regions, W0=W0, seed=seed,
                               device=device)


def hierarchical_stream_run(cfg: StreamConfig, group, states: StreamState,
                            xs: torch.Tensor,
                            masks: torch.Tensor | None = None, *,
                            q_fleet: int | None = None,
                            c_regions: int | None = None,
                            chunk: int | None = None,
                            probe_every: int | None = None,
                            ) -> tuple[StreamState, RoundMetrics, FleetMerge]:
    """Two-level run over the process group ``group``: ``xs`` (regions,
    rounds, n, p_region) and ``masks`` (regions, rounds, p_region) are the
    whole fleet, the same on every rank; rank r streams its contiguous
    slice of the regions (:func:`repro_torch.distributed.sharding
    .shard_regions`, which raises when the ranks do not divide them)
    through :func:`batched_stream_run`, then the merge makes exactly one
    ``all_gather`` and one ``all_reduce``.

    Returns ``(states, metrics, fleet)``: the rank's regions' final states
    and metrics, and the merge replicated on every rank — one (q_local +
    1)-record region-tree epoch booked per decision boundary at which any
    region refreshed (at least one, the final merge), at fan-out
    ``c_regions`` (default ``cfg.c_max``), ARQ-scaled."""
    from repro_torch.distributed.sharding import shard_regions

    n_regions = xs.shape[0]
    qf = cfg.q if q_fleet is None else q_fleet
    cr = cfg.c_max if c_regions is None else c_regions
    if qf > n_regions * cfg.q:
        raise ValueError(f"q_fleet={qf} > regions*q_local="
                         f"{n_regions * cfg.q}")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    states_l, xs_l = (shard_regions(t, rank, world) for t in (states, xs))
    masks_l = None if masks is None else shard_regions(masks, rank, world)
    merge_price = costs.lossy_merge_cost(
        cfg.q, cr, cfg.link_loss, cfg.max_retries).communication
    fin, metrics = batched_stream_run(cfg, states_l, xs_l, masks_l,
                                      chunk=chunk, probe_every=probe_every)
    lam_l, den_l = region_energies(fin)
    parts = [torch.empty_like(lam_l) for _ in range(world)]
    dist.all_gather(parts, lam_l.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVE_ELEMS["all_gather"] += lam_l.numel()
    lam_table = torch.cat(parts)
    # ONE all_reduce: the trace partial and the per-boundary refresh counts
    summed = torch.cat([den_l.sum().reshape(1),
                        metrics.did_refresh.to(torch.float32).sum(0)])
    dist.all_reduce(summed, group=group)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVE_ELEMS["all_reduce"] += summed.numel()
    total_var, fired = summed[0], summed[1:]
    basis = merge_fleet(lam_table, total_var, qf)
    merges = (fired > 0).sum().clamp(min=1).to(torch.int32)
    fleet = FleetMerge(basis=basis, merge_epochs=merges,
                       merge_packets=merges.to(torch.float32)
                       * float(merge_price))
    return fin, metrics, fleet


# ===========================================================================
# Program contract (checked by ``python -m repro_torch.analysis.check``):
# the run in a one-rank group of its own (gloo on the CPU, NCCL on the
# card), over 4 and 8 rounds, so a collective a round would show.
# ===========================================================================
from repro_torch.analysis import contracts as _contracts  # noqa: E402
from repro_torch.analysis import op_lint as _ol  # noqa: E402

def _one_rank_run(dev, cfg, states, xs):
    import tempfile

    from repro_torch.launch.mesh import init_fleet_process_group

    own = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        if own:
            init_fleet_process_group(0, 1, tmp, device=dev.type,
                                     timeout_s=180)
        try:
            fin, metrics, fleet = hierarchical_stream_run(
                cfg, dist.group.WORLD, states, xs, chunk=2)
        finally:
            if own:
                dist.destroy_process_group()
    return dict(states=fin, metrics=metrics, fleet=fleet,
                regions_local=xs.shape[0], q=cfg.q)


def _hierarchy_runs(dev):
    regions, p, q, h, n = ((8, 1024, 32, 128, 32) if dev.type == "cuda"
                           else (2, 8, 3, 1, 4))
    cfg = StreamConfig(p=p, q=q, halfwidth=h, warmup_rounds=2)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for rounds in (4, 8):
        xs = torch.randn((regions, rounds, n, p), generator=g, device=dev)
        states = hierarchical_stream_init(cfg, regions, device=dev)
        out[f"rounds={rounds}"] = (
            lambda s=states, x=xs: _one_rank_run(dev, cfg, s, x))
    return out


_contracts.register(_contracts.Contract(
    id="hierarchy.refresh",
    where="repro_torch.streaming.hierarchy.hierarchical_stream_run",
    claim="exactly one all_gather and one all_reduce per run, none a round "
          "(4 rounds or 8), with the (q + 1)-element merge record a region "
          "that the merge's Table-1 price bills",
    run=_hierarchy_runs,
    rules=(_ol.CollectiveBudget("hierarchy", (("all_gather", 1),
                                              ("all_reduce", 1))),
           _ol.CollectiveBudget("aggregation", ()),
           _ol.WirePayload(costs.merge_record_elems), _ol.NoF64()),
))
