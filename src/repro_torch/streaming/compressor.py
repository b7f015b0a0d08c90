"""Streaming compression stage: ε-supervised PCAg scores (counterpart of
``repro.streaming.compressor``).

Each round of readings is projected on the slot's current basis, the
scores are fed back, and every node whose reconstruction error strictly
exceeds ε ships its raw reading, so the sink is within ``|x - x̂| <= ε``.
On the port's slice the stage runs inside the fused chunk kernel
(:func:`repro_torch.kernels.ops.fused_stream_update`); this module holds
the policy and the packet books.  Quantized scores (``score_bits > 0``)
need the split path's kernels, which are not ported yet:
:func:`repro_torch.streaming.driver.fleet_chunk_step` raises for them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import costs

__all__ = ["CompressionConfig", "RoundCompression", "compression_books",
           "compression_round_cost", "epoch_packet_split"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Static per-deployment compression policy (hashable: rides the jitted
    StreamConfig as a compile-time constant).

    Parameters
    ----------
    epsilon: the Sec.-2.4.1 accuracy bound; the sink is guaranteed within
        ``<= epsilon`` of the truth for every live sensor.
    score_bits: uniform-quantizer width for the score records; 0 disables
        quantization (full-precision scores).  Must be 0 or >= 2 (one sign
        bit plus at least one magnitude bit).
    word_bits: radio word size — what one Table-1 "packet" carries; the
        bit-budget booking expresses quantized scores as packet fractions.
    emit_reconstruction: carry the (n, p) sink view and flag mask in the
        per-round output.  Costs rounds x n x p floats through a scan —
        right for examples/tests and modest fleets; disable at scale to
        keep only the scores and the scalar books.
    """

    epsilon: float
    score_bits: int = 0
    word_bits: int = 32
    emit_reconstruction: bool = True

    def __post_init__(self):
        if self.epsilon < 0.0:
            raise ValueError(f"epsilon must be >= 0, got {self.epsilon}")
        if self.score_bits == 1 or self.score_bits < 0:
            raise ValueError(
                f"score_bits must be 0 (off) or >= 2, got {self.score_bits}")
        if self.word_bits <= 0:
            raise ValueError(f"word_bits must be > 0, got {self.word_bits}")
        if self.score_bits > self.word_bits:
            raise ValueError(
                f"score_bits ({self.score_bits}) cannot exceed word_bits "
                f"({self.word_bits}) — a score never outgrows a packet word")


class RoundCompression(NamedTuple):
    """Per-chunk compression output; leading axes are the fleet's slots.
    ``x_sink``/``flagged`` are None when the config disables emission."""

    z: torch.Tensor                  # (..., rows, q) scores the sink decodes
    x_sink: torch.Tensor | None      # (..., rows, p) ε-true sink view
    flagged: torch.Tensor | None     # (..., rows, p) 0/1 notification mask
    max_err: torch.Tensor            # (...) max |x - x_sink| over live sensors
    extra_packets: torch.Tensor      # (...) flagged raw measurements
    score_packets: torch.Tensor      # (...) booked A packets (highest node)
    feedback_packets: torch.Tensor   # (...) booked F packets (highest node)
    bits_on_air: torch.Tensor        # (...) score+extra bits, highest node


def epoch_packet_split(q: int, c_max: int, cfg: CompressionConfig,
                       ) -> tuple[float, float]:
    """(A packets up, F packets down) of one flag-free compressed epoch at
    the highest-loaded node.

    A carries the q score records at the quantized width; F carries the
    scores back down PLUS — when quantizing — the q full-precision
    per-component scales the nodes need to dequantize (re-derived from
    every round's scores, so they travel every round).  The two halves sum
    exactly to :func:`repro_torch.core.costs.quantized_supervised_round_cost`'s
    flag-free communication — the cost model owns the total
    (:func:`compression_round_cost` delegates to it); this split exists
    only for the metrics' A/F fields.
    """
    unit = q * (c_max + 1)                      # Eq. 7: one q-record A or F
    if cfg.score_bits == 0:
        return float(unit), float(unit)
    frac = cfg.score_bits / cfg.word_bits
    return float(unit * frac), float(unit * frac + unit)


def compression_round_cost(q: int, c_max: int, cfg: CompressionConfig,
                           ) -> float:
    """Flag-free packet bill of one compressed epoch at the highest node
    (the cost model is the source of truth; see epoch_packet_split)."""
    return costs.quantized_supervised_round_cost(
        q, c_max, cfg.score_bits, cfg.word_bits).communication


def compression_books(x: torch.Tensor, z: torch.Tensor,
                      x_hat: torch.Tensor, flagged: torch.Tensor,
                      mask2d: torch.Tensor, cfg: CompressionConfig, q: int,
                      c_max: int) -> RoundCompression:
    """Turn the stage outputs (scores, reconstruction, bool flag mask, each
    (..., rows, ...)) into the :class:`RoundCompression` record — sink
    view, max error over live sensors (``mask2d`` broadcast against x),
    and the Sec.-2.4.1 packet books."""
    fl = flagged.to(torch.float32)
    x_sink = torch.where(flagged, x, x_hat)
    err = (x - x_sink).abs() * mask2d          # dead sensors owe no bound
    n_flagged = fl.sum((-2, -1))
    a_pk, f_pk = epoch_packet_split(q, c_max, cfg)
    full = lambda v: torch.full_like(n_flagged, v)
    return RoundCompression(
        z=z,
        x_sink=x_sink if cfg.emit_reconstruction else None,
        flagged=fl if cfg.emit_reconstruction else None,
        max_err=err.amax((-2, -1)),
        extra_packets=n_flagged,
        score_packets=full(a_pk),
        feedback_packets=full(f_pk),
        bits_on_air=(a_pk + f_pk) * cfg.word_bits
        + n_flagged * cfg.word_bits,
    )
