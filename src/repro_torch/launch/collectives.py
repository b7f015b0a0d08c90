"""Collective traffic and roofline terms of a dry run (counterpart of
``repro.launch.hlo_analysis``).

The reference parses the optimized HLO of a compiled step for its
collectives and multiplies each loop body's by its parsed trip count.  The
port has no HLO and no compiled loops: a dry run executes the step op by
op, and every collective it issues is seen as it is issued (a DTensor
redistribute's functional collective, a ``torch.distributed`` call), with
its tensor bytes and its group's size.  So there is no
``parse_collectives`` and no ``fallback_trip``: no trip count is ever
unknown, and ``CollectiveStats.unknown_trips`` is always empty.

Wire-byte model (per device, ring algorithms), the reference's:
    all-reduce          2 * N * (g-1)/g      (reduce-scatter + all-gather)
    all-gather          N * (g-1)/g          (N = full result bytes)
    reduce-scatter      N * (g-1)/g          (N = full input bytes)
    all-to-all          N * (g-1)/g
    collective-permute  N                    (a halo exchange's sends)

Machine model: the H100 SXM5 80GB as its datasheet gives it.  The LM
cells run on the bf16 dense tensor-core peak; the WSN cells on the fp32
peak, since the port's WSN kernels are fp32 FMA on CUDA cores; HBM and the
fp32 peak are ``analysis.resources.H100``'s; NVLink 4 moves 450 GB/s each
way per GPU.
"""

from __future__ import annotations

import dataclasses

from repro_torch.analysis.resources import H100

__all__ = ["CollectiveStats", "RooflineTerms", "roofline_terms",
           "ring_wire_bytes", "KINDS", "PEAK_BF16", "PEAK_FP32", "HBM_BW",
           "LINK_BW", "HBM_BYTES"]

PEAK_BF16 = 989.4e12          # dense bf16 tensor-core FLOP/s (no sparsity)
PEAK_FP32 = H100.peak_fp32    # FP32 FMA on the CUDA cores
HBM_BW = H100.peak_bytes      # HBM3, bytes/s
LINK_BW = 450e9               # NVLink 4, bytes/s each way per GPU
HBM_BYTES = 80e9              # device memory

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def ring_wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Per-device wire bytes of one collective under the ring model in the
    module docstring.  ``nbytes`` is the full result (all-gather) / full
    input (everything else) size."""
    g = max(int(group), 1)
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind == "collective-permute":
        return float(nbytes)
    return float(nbytes) * (g - 1) / g


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict        # sum of the full sizes per kind
    wire_bytes: dict          # modeled per-device wire traffic per kind
    unknown_trips: tuple = ()  # always empty: every issue is seen

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    @classmethod
    def from_issues(cls, issues) -> "CollectiveStats":
        """From what a run issued: ``(kind, full bytes, group size)`` for
        each collective, in any order."""
        counts = dict.fromkeys(KINDS, 0)
        rbytes = dict.fromkeys(KINDS, 0.0)
        wbytes = dict.fromkeys(KINDS, 0.0)
        for kind, nbytes, group in issues:
            counts[kind] += 1
            rbytes[kind] += nbytes
            wbytes[kind] += ring_wire_bytes(kind, nbytes, group)
        return cls(counts, rbytes, wbytes)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float          # per-device FLOPs / peak
    memory_s: float           # per-device bytes accessed / HBM rate
    collective_s: float       # per-device wire bytes / NVLink rate
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower-bound step time if the three terms fully overlapped."""
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(cost: dict, coll: CollectiveStats, *,
                   peak_flops: float = PEAK_BF16) -> RooflineTerms:
    """Roofline terms from a dry run's per-device ``cost`` (``flops``,
    ``bytes accessed``) and its collectives, at ``peak_flops`` (the bf16
    tensor-core peak for the LM cells, :data:`PEAK_FP32` for the WSN
    cells)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    wire = float(coll.total_wire_bytes)
    return RooflineTerms(
        compute_s=flops / peak_flops,
        memory_s=byts / HBM_BW,
        collective_s=wire / LINK_BW,
        flops_per_device=flops,
        bytes_per_device=byts,
        wire_bytes_per_device=wire,
    )
