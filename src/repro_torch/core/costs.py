"""Copy of ``repro.core.costs`` for the PyTorch port (held equal to it by
tests/test_torch_streaming.py).

Cost models (paper Sec. 2.1.3, 3.2.1, 3.3.2, 3.4.5 and Table 1).

Closed-form communication / computation / memory costs for the centralized
and distributed variants, parameterized by

*  p      — network size,
*  T      — number of training epochs used for the covariance,
*  q      — number of principal components,
*  n_max  — |N_{i*}|, largest neighborhood size,
*  c_max  — C_{i*}, largest number of routing-tree children,
*  iters  — PIM iterations per component.

These formulas are validated against *actual packet counts* from the
routing-tree simulator in tests/test_costs.py, and drive the Fig. 9/10/12/14
benchmarks.
"""

from __future__ import annotations

import dataclasses

__all__ = ["CostReport", "centralized_covariance", "distributed_covariance",
           "centralized_eigenvectors", "distributed_eigenvectors",
           "streaming_round_cost", "streaming_refresh_cost",
           "supervised_round_cost", "quantized_supervised_round_cost",
           "detection_round_cost", "merge_record_elems", "merge_round_cost",
           "lossy_merge_cost",
           "lossy_round_cost", "lossy_refresh_cost", "lossy_epoch_load",
           "pcag_epoch_load", "default_epoch_load", "table1"]


@dataclasses.dataclass(frozen=True)
class CostReport:
    communication: float   # highest per-node network load (packets)
    computation: float     # highest per-node flop count (order)
    memory: float          # highest per-node storage (scalars)


def centralized_covariance(p: int, T: int) -> CostReport:
    """Sec. 3.2.1: T default collections; O(T p^2) flops at the base station."""
    return CostReport(communication=T * p, computation=T * p * p, memory=p * p)


def distributed_covariance(n_max: int, T: int) -> CostReport:
    """Sec. 3.3.2: per epoch 1 send + |N_i| receives; O(|N_i|) flops/memory."""
    return CostReport(communication=T * (n_max + 1), computation=T * n_max,
                      memory=2 * n_max + 1)


def centralized_eigenvectors(p: int, q: int) -> CostReport:
    """Sec. 3.2.1: O(p^3) eigendecomposition; qp feedback packets."""
    return CostReport(communication=q * p, computation=p ** 3, memory=p * p)


def distributed_eigenvectors(p: int, q: int, n_max: int, c_max: int,
                             iters: int = 20) -> CostReport:
    """Sec. 3.4.5: per iteration of component k —
    Cv: 1 send + n_max receives;  normalization: 1 A + 1 F;
    orthogonalization: (k-1) A + (k-1) F   (record elements counted).
    Highest load O(q |N*| + q^2 C*); computation O(q(|N*| + C*));
    memory O(q + |N*|)."""
    comm = 0.0
    for k in range(1, q + 1):
        per_iter = (n_max + 1) + k * (c_max + 1 + 2)
        comm += iters * per_iter
    comp = iters * q * (n_max + q * c_max)
    mem = q + n_max
    return CostReport(communication=comm, computation=comp, memory=mem)


def streaming_round_cost(n_max: int, q: int, c_max: int) -> CostReport:
    """One streaming round (DESIGN.md Sec. 8.3): covariance fold + drift probe.

    Per round each node performs the Sec.-3.3 covariance exchange (1 send +
    |N_i| receives) and contributes to ONE aggregation of the drift statistic
    ``(trace(W^T C W), trace(C))`` — a (q+1)-element record up the tree plus
    the scalar verdict flooded back.
    """
    return CostReport(
        communication=(n_max + 1) + (q + 1) * (c_max + 1) + 1,
        computation=n_max + q * n_max,        # band fold + banded C W rows
        memory=2 * n_max + 1 + q,
    )


def streaming_refresh_cost(p: int, q: int, n_max: int, c_max: int,
                           iters: int) -> CostReport:
    """One scheduled basis refresh by blocked orthogonal iteration.

    Per iteration: CV for all q columns (q sends + q n_max receives, the
    neighbor broadcast carries the full q-vector), the Gram matrix as ONE
    aggregation of a q^2-element record (vs. Algorithm 2's k separate A/F
    rounds), and the flood of the q x q factor back down.  After convergence
    the new basis is flooded to the network: q p feedback packets total,
    q (C*+1) at the highest-loaded node (the PCAg feedback path, Eq. 7).
    """
    per_iter = q * (n_max + 1) + q * q * (c_max + 1) + q * q
    feedback = q * (c_max + 1)
    return CostReport(
        communication=iters * per_iter + feedback,
        computation=iters * q * (n_max + q * c_max) + q * q * p,
        memory=2 * q + n_max,
    )


def supervised_round_cost(q: int, c_max: int,
                          flagged: float = 0.0) -> CostReport:
    """One supervised-compression epoch (Sec. 2.4.1), highest-node load.

    The scores travel as one PCAg aggregation up the tree and one feedback
    flood back down — ``q (C* + 1)`` packets each at the highest-loaded
    node (Eq. 7 twice) — plus the flagged raw measurements.  ``flagged`` is
    the number of notifications this epoch: every flagged raw is forwarded
    to the sink, so the root (the highest-loaded node for extras) processes
    all of them.  Computation per node: q multiplies for the init record +
    q for the local reconstruction + the error test; memory: the node's
    basis row, the fed-back scores, its mean and eps.
    """
    return CostReport(
        communication=2 * q * (c_max + 1) + flagged,
        computation=2 * q + 1,
        memory=2 * q + 2,
    )


def quantized_supervised_round_cost(q: int, c_max: int, bits: int,
                                    word_bits: int = 32,
                                    flagged: float = 0.0) -> CostReport:
    """Supervised epoch with ``bits``-wide quantized scores (bit budget).

    The accuracy-vs-bits tradeoff of "Self-adaptive node-based PCA
    encodings" (PAPERS.md): each score on the A and F paths costs
    ``bits / word_bits`` of a full packet, while flagged raw measurements
    stay full-word.  The quantizer re-derives its q per-component scales
    from every round's scores, so the F flood additionally carries q
    full-precision scale words each round — ``q (C* + 1)`` word-packets at
    the highest-loaded node — which caps the useful width: quantization
    beats full precision only below ``word_bits / 2`` bits.  ``bits == 0``
    means unquantized and reproduces :func:`supervised_round_cost` exactly.
    """
    if bits == 0:
        return supervised_round_cost(q, c_max, flagged)
    base = supervised_round_cost(q, c_max, 0.0)
    scale_flood = q * (c_max + 1)
    return CostReport(
        communication=(base.communication * (bits / word_bits)
                       + scale_flood + flagged),
        computation=base.computation + 2 * q,   # encode + decode per node
        memory=base.memory + q,                 # per-component scales
    )


def detection_round_cost(q: int, c_max: int,
                         alarms: float = 0.0) -> CostReport:
    """One Sec.-2.4.3 monitoring epoch, highest-node load.

    The T²/SPE verdict rides the streaming drift probe: the per-round
    (q+1)-element A record of :func:`streaming_round_cost` grows by ONE
    scalar — the node-local residual-energy partial (T² needs only the
    scores already aggregated for the drift statistic) — so the marginal
    flag-free communication is one record element through ``C* + 1``
    packets at the highest-loaded node.  Each alarmed epoch additionally
    floods one F notification (a scalar alarm verdict) back down the tree:
    ``C* + 1`` more packets per alarm at the highest node.  ``alarms`` is
    the number of alarmed epochs this round (the per-event F flood — the
    extras analogue of :func:`supervised_round_cost`'s flagged raws).

    Computation per node: q multiplies against the fed-back inverse
    eigenvalue record plus the local residual square-and-add and the two
    threshold tests; memory: the q inverse eigenvalues plus the two
    thresholds.
    """
    return CostReport(
        communication=(c_max + 1) * (1.0 + alarms),
        computation=2 * q + 3,
        memory=q + 2,
    )


def merge_record_elems(q_local: int) -> int:
    """Elements of ONE region's merge record: its ``q_local`` per-component
    subspace energies ``diag(W^T C W)`` plus the total-variance partial
    ``trace(C)``.  This is the unit :func:`merge_round_cost` bills per
    aggregation packet AND the quantity the static resource certifier
    (:class:`repro.analysis.resources.WireBytesBudget`) reconciles against
    the traced merge collectives' shapes — booked == traced, so the packet
    ledger and the wire cannot drift apart silently."""
    return q_local + 1


def merge_round_cost(q_local: int, c_regions: int) -> CostReport:
    """One fleet-level merge epoch of the two-level hierarchy (DESIGN.md
    Sec. 13), highest-region-head load.

    The region heads aggregate ONE (q_local + 1)-element record up the
    region-level routing tree — the region's per-component subspace energies
    ``diag(W^T C W)`` plus its total-variance partial ``trace(C)``, exactly
    the quantities the intra-network drift probe already aggregates
    (:func:`streaming_round_cost`) one level down — and the sink floods one
    scalar back (the global selection threshold λ_min: a region keeps a
    component in the fleet basis iff its energy clears it).  So the
    highest-loaded region head processes ``(q_local + 1) (C_r* + 1)``
    aggregation packets plus the scalar verdict, the same shape as the
    intra-network round bill.

    Computation per region head: merging ``C_r*`` children records of
    ``q_local + 1`` elements; memory: its own record plus the threshold.
    """
    record = merge_record_elems(q_local)
    return CostReport(
        communication=record * (c_regions + 1) + 1,
        computation=record * c_regions,
        memory=record + 1,
    )


def lossy_merge_cost(q_local: int, c_regions: int, link_loss: float,
                     max_retries: int) -> CostReport:
    """Expected fleet-merge cost over lossy region-head links (the same ARQ
    scaling as :func:`lossy_round_cost`; zero loss books the reliable
    figure exactly)."""
    from repro_torch.core.faults import expected_transmissions
    return _scale(merge_round_cost(q_local, c_regions),
                  expected_transmissions(link_loss, max_retries))


def _scale(report: CostReport, factor: float) -> CostReport:
    """Communication scaled by a retransmission factor; compute/memory keep
    their reliable-path order (ARQ costs radio, not flops)."""
    return CostReport(communication=report.communication * factor,
                      computation=report.computation,
                      memory=report.memory)


def lossy_round_cost(n_max: int, q: int, c_max: int, link_loss: float,
                     max_retries: int) -> CostReport:
    """Expected streaming-round cost over lossy links.

    Every data packet of the reliable round (:func:`streaming_round_cost`)
    is retransmitted per-hop until delivered or the retry budget runs out,
    so the expected bill is the reliable bill times
    ``E[transmissions] = (1 - loss^(r+1)) / (1 - loss)``
    (:func:`repro_torch.core.faults.expected_transmissions`).  At ``loss == 0``
    this is exactly the reliable cost — the differential anchor.
    """
    from repro_torch.core.faults import expected_transmissions
    return _scale(streaming_round_cost(n_max, q, c_max),
                  expected_transmissions(link_loss, max_retries))


def lossy_refresh_cost(p: int, q: int, n_max: int, c_max: int, iters: int,
                       link_loss: float, max_retries: int) -> CostReport:
    """Expected basis-refresh cost over lossy links (see lossy_round_cost)."""
    from repro_torch.core.faults import expected_transmissions
    return _scale(streaming_refresh_cost(p, q, n_max, c_max, iters),
                  expected_transmissions(link_loss, max_retries))


def lossy_epoch_load(tree, record_sizes, attempts, delivered,
                     active) -> "np.ndarray":
    """Exact per-node packets of one lossy A epoch from its transcript.

    Books, per node: ``size_i * attempts_i`` transmissions on the parent hop
    plus ``size_c`` received packets for each *delivered* child ``c`` (failed
    attempts never reach the parent's radio), plus the root's wired uplink.
    By construction this equals the packet counts the simulator
    (:func:`repro.core.aggregation.lossy_aggregate_tree`) reports — the
    booked-equals-counted property in tests/test_properties.py; at zero loss
    with scalar records it collapses to ``q (C_i + 1)`` (Sec. 2.1.3).
    """
    import numpy as np
    record_sizes = np.asarray(record_sizes, dtype=np.int64)
    attempts = np.asarray(attempts, dtype=np.int64)
    delivered = np.asarray(delivered, dtype=bool)
    active = np.asarray(active, dtype=bool)
    load = record_sizes * attempts                       # tx on the parent hop
    for i in range(tree.p):
        par = int(tree.parent[i])
        if par >= 0 and active[i] and delivered[i]:
            load[par] += record_sizes[i]                 # rx at the parent
    load[tree.root] += record_sizes[tree.root]           # wired sink uplink
    return load


def default_epoch_load(p: int) -> int:
    """Highest per-node load of the D scheme: the root processes 2p-1."""
    return 2 * p - 1


def pcag_epoch_load(q: int, c_max: int) -> int:
    """Highest per-node load of the PCAg scheme: q (C* + 1)  (Eq. 7)."""
    return q * (c_max + 1)


def pcag_beats_default(q: int, c_max: int, p: int) -> bool:
    """Eq. (7): q (C* + 1) <= 2p - 1."""
    return pcag_epoch_load(q, c_max) <= default_epoch_load(p)


def table1(p: int, T: int, q: int, n_max: int, c_max: int,
           iters: int = 20) -> dict[str, CostReport]:
    """The four rows of Table 1."""
    return {
        "covariance/centralized": centralized_covariance(p, T),
        "covariance/distributed": distributed_covariance(n_max, T),
        "eigenvectors/centralized": centralized_eigenvectors(p, q),
        "eigenvectors/distributed": distributed_eigenvectors(p, q, n_max,
                                                             c_max, iters),
    }
