"""Streaming compression stage: ε-supervised PCAg scores (counterpart of
``repro.streaming.compressor``).

Each round of readings is projected on the slot's current basis, the
scores are fed back, and every node whose reconstruction error strictly
exceeds ε ships its raw reading, so the sink is within ``|x - x̂| <= ε``.
On the fused chunk path the stage runs inside the fused chunk kernel
(:func:`repro_torch.kernels.ops.fused_stream_update`) and this module only
books it; on the split path :func:`compress_round` runs it through the
supervised-compression kernel, or — for quantized scores — through the
projection and reconstruction kernels around :func:`quantize_scores`.

The ε guarantee does not depend on the quantizer: nodes flag against the
same dequantized reconstruction the sink computes, so coarser scores only
raise the notification rate.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import costs
from repro_torch.kernels import ops

__all__ = ["CompressionConfig", "RoundCompression", "quantize_scores",
           "row_mask", "compress_round", "compression_books",
           "compression_round_cost", "epoch_packet_split"]

# the functions of every compression stage (checked by repolint's
# host-pull rule)
HOT_PATHS = ("quantize_scores", "row_mask", "compress_round",
             "compression_books")


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


def quantize_scores(z: torch.Tensor, bits: int,
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Uniform symmetric per-component quantizer over the rows of each
    slot: ``z`` (..., rows, q).

    ``scale[..., c] = max_rows |z[..., :, c]| / (2^(bits-1) - 1)``, floored
    at the smallest normal float; codes are ``round(z / scale)`` (half to
    even, as ``jnp.round``) clipped to the signed range.  Returns the
    *dequantized* scores ``codes * scale`` (what both the node and the
    sink reconstruct from) and the (..., q) scales.  ``bits == 0`` is the
    identity (scale None)."""
    if bits == 0:
        return z, None
    if bits == 1 or bits < 0:
        raise ValueError(f"bits must be 0 or >= 2, got {bits}")
    levels = (1 << (bits - 1)) - 1
    scale = z.abs().amax(-2) / levels
    scale = scale.clamp(min=torch.finfo(z.dtype).tiny)
    codes = torch.clamp(torch.round(z / scale[..., None, :]), -levels,
                        levels)
    return codes * scale[..., None, :], scale


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


def row_mask(mask: torch.Tensor, n: int | None) -> torch.Tensor:
    """A stage mask as (..., rows, p): a per-round (..., K, p) mask with
    ``n`` epochs per round is repeated row by row; ``n`` None means the
    mask already has one row per reading row."""
    return mask if n is None else mask.repeat_interleave(n, dim=-2)


def compress_round(W: torch.Tensor, mean: torch.Tensor | None,
                   x: torch.Tensor, cfg: CompressionConfig, c_max: int,
                   mask: torch.Tensor | None = None,
                   n: int | None = None) -> RoundCompression:
    """Compress every slot's (R, p) rows against its basis: ``W``
    (S, p, q), ``mean`` (S, p) or None, ``x`` (S, R, p); ``mask`` (S, R, p)
    per row, (S, R / n, p) per round with ``n`` given, or None.

    Unquantized (``score_bits == 0``): one supervised-compression launch
    emits scores, reconstruction and flags.  Quantized: the projection
    kernel, the quantizer, the reconstruction kernel, then the mean and
    the flag test in plain torch (the quantizer needs every row's scores
    to set the per-component scales, so one pass cannot do it).  Dead
    sensors contribute no score record, raise no notification and are
    excluded from ``max_err``.  The packet books as
    :func:`compression_books`."""
    S, R, p = x.shape
    q = W.shape[-1]
    x = x.to(torch.float32)
    mask2d = 1.0 if mask is None else row_mask(mask.to(torch.float32), n)
    if cfg.score_bits == 0:
        z, x_hat, flagged = ops.supervised_compress(
            x, W, mean, epsilon=cfg.epsilon, mask=mask, n=n)
    else:
        mean_row = (x.new_zeros((S, 1, p)) if mean is None
                    else mean.to(torch.float32)[:, None, :])
        z, _ = quantize_scores(ops.pca_project((x - mean_row) * mask2d, W),
                               cfg.score_bits)
        x_hat = ops.pca_reconstruct(z, W) + mean_row
        flagged = (x - x_hat).abs() > cfg.epsilon
        if mask is not None:
            flagged = flagged & (mask2d > 0.0)
    return compression_books(x, z, x_hat, flagged, mask2d, cfg, q, c_max)


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
