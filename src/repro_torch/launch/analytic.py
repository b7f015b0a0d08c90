"""Analytic roofline terms (per device) for every dry-run cell (counterpart
of ``repro.launch.analytic``).

The dry run counts what one device executes, op by op, so its FLOPs and
bytes need no loop correction; this module keeps the reference's analytic
model beside them, formula for formula, as the plan the counts are held
against:

* **compute term**: analytic FLOPs (standard MFU accounting: 6·N_active·D
  for training, 2·N_active·D plus the attention quadratic terms for
  inference, the SSD's intra-chunk and state terms),
* **memory term**: the reference's per-step HBM traffic model,
* **collective term**: the dry run's wire bytes per device.

The machine is the H100 SXM5 80GB (``launch.collectives``): the LM cells
on the bf16 tensor-core peak, the WSN cells on the fp32 peak (the port's
WSN kernels are fp32 FMA on CUDA cores).
"""

from __future__ import annotations

import dataclasses

from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.configs.wsn_1m import CONFIG as WSN
from repro_torch.launch.collectives import (HBM_BW, LINK_BW, PEAK_BF16,
                                            PEAK_FP32)

__all__ = ["CellModel", "lm_cell_model", "wsn_cell_model", "cell_model"]

BF16 = 2
F32 = 4


@dataclasses.dataclass(frozen=True)
class CellModel:
    flops_global: float          # whole-job FLOPs per step
    hbm_bytes_global: float      # whole-job HBM traffic per step
    collective_scale: float      # multiply the dry run's wire bytes by this
    peak_flops: float = PEAK_BF16

    def terms(self, chips: int, parsed_wire_bytes_per_dev: float) -> dict:
        compute_s = self.flops_global / chips / self.peak_flops
        memory_s = self.hbm_bytes_global / chips / HBM_BW
        collective_s = (parsed_wire_bytes_per_dev * self.collective_scale
                        / LINK_BW)
        dom = max(("compute", compute_s), ("memory", memory_s),
                  ("collective", collective_s), key=lambda kv: kv[1])
        return {"compute_s": compute_s, "memory_s": memory_s,
                "collective_s": collective_s, "dominant": dom[0],
                "bound_s": dom[1]}


def _windows(cfg):
    from repro_torch.models.transformer import layer_windows
    return layer_windows(cfg).tolist()


def _attn_fwd_flops(cfg, B, S_q, S_kv_avg) -> float:
    """scores + PV for all layers: 4 * B * S_q * S_kv * H * hd."""
    if cfg.family == "ssm":
        return 0.0
    win = [w if w > 0 else None for w in _windows(cfg)]
    total = 0.0
    for w in win:
        kv = S_kv_avg if w is None else min(w, S_kv_avg)
        total += 4.0 * B * S_q * kv * cfg.n_heads * cfg.head_dim
    if cfg.family == "encdec":
        # encoder self (bidir, full) + decoder cross
        total += cfg.enc_layers * 4.0 * B * S_q * 2 * S_q \
            * cfg.n_heads * cfg.head_dim
    return total


def _ssd_core_flops(cfg, B, S, chunk=128) -> float:
    """Intra-chunk quadratic + state terms per token, all layers."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    nh = cfg.n_ssm_heads
    hd = cfg.ssm_headdim
    n = cfg.d_state
    q = min(chunk, S)
    per_token = nh * (2.0 * q * (n + hd) + 4.0 * hd * n)
    return cfg.n_layers * B * S * per_token


def _param_bytes(cfg, dtype_bytes=BF16) -> float:
    return float(cfg.param_count()) * dtype_bytes


def lm_cell_model(arch: str, shape: str, chips: int,
                  microbatches: int = 1) -> CellModel:
    cfg = configs.get(arch)
    shp = SHAPES[shape]
    B, S = shp.global_batch, shp.seq_len
    n_act = float(cfg.active_param_count())
    P = _param_bytes(cfg)

    if shp.kind == "train":
        D = B * S
        flops = 6.0 * n_act * D + 3.0 * _attn_fwd_flops(cfg, B, S, S / 2) \
            + 3.0 * _ssd_core_flops(cfg, B, S)
        # HBM model: params fwd+bwd reads (2P), grad write+read (2P),
        # opt: param rw + 2 moments rw ~ (2+2+2+4)*P; activations: remat
        # stash w+r + recompute w ~ 3 passes of (B,S,d) per layer per
        # microbatch; logits w+r fp32.
        act = 3.0 * microbatches * cfg.n_layers \
            * (B / microbatches) * S * cfg.d_model * BF16
        logits = 2.0 * B * S * cfg.vocab_size * F32
        hbm = 10.0 * P + act + logits
        return CellModel(flops, hbm, 1.0)

    if shp.kind == "prefill":
        D = B * S
        flops = 2.0 * n_act * D + _attn_fwd_flops(cfg, B, S, S / 2) \
            + _ssd_core_flops(cfg, B, S)
        # params once; activations ~2 passes/layer; KV cache write;
        # chunked attention re-reads K,V per query chunk (nq times)
        act = 2.0 * cfg.n_layers * B * S * cfg.d_model * BF16
        kv_bytes = (2.0 * cfg.n_layers * B * S
                    * cfg.n_kv_heads * cfg.head_dim * BF16)
        nq = max(S // 1024, 1)
        hbm = P + act + kv_bytes * (1.0 + 0.5 * nq)
        return CellModel(flops, hbm, 1.0)

    # decode: one token per sequence
    cache_len = S
    flops = 2.0 * n_act * B + _attn_fwd_flops(cfg, B, 1, cache_len)
    win = [w if w > 0 else cache_len for w in _windows(cfg)] or [cache_len]
    kv_read = sum(2.0 * B * min(w, cache_len) * cfg.n_kv_heads
                  * cfg.head_dim * BF16 for w in win)
    if cfg.family in ("ssm", "hybrid"):
        nh = cfg.n_ssm_heads
        kv_read += 2.0 * cfg.n_layers * B * nh * cfg.ssm_headdim \
            * cfg.d_state * F32            # state read+write
    hbm = P + kv_read + 2.0 * B * cfg.vocab_size * F32
    return CellModel(flops, hbm, 1.0)


def wsn_cell_model(shape: str, chips: int) -> CellModel:
    p, h, q, n = WSN.p, WSN.halfwidth, WSN.q, WSN.batch_epochs
    nb = 2 * h + 1
    if shape == "cov_update":
        flops = 2.0 * n * nb * p
        hbm = (2.0 * nb * p + n * p * (nb / 64.0 + 1)) * F32
        # band r+w; x read (re-read per diagonal block, ~nb/64 effective)
        return CellModel(flops, hbm, 1.0, PEAK_FP32)
    if shape == "pim_block":
        flops = 2.0 * nb * p * q + 4.0 * p * q * q
        hbm = (nb * p + 3.0 * p * q) * F32
        return CellModel(flops, hbm, 1.0, PEAK_FP32)
    if shape == "pim_deflated":
        flops = 2.0 * nb * p + 4.0 * p * (q - 1)
        hbm = (nb * p + p * q + 2.0 * p) * F32
        return CellModel(flops, hbm, 1.0, PEAK_FP32)
    if shape == "transform":
        flops = 2.0 * n * p * q
        hbm = (n * p + p * q + n * q) * F32
        return CellModel(flops, hbm, 1.0, PEAK_FP32)
    raise KeyError(shape)


def cell_model(arch: str, shape: str, chips: int,
               microbatches: int = 1) -> CellModel:
    if arch == "wsn-1m":
        return wsn_cell_model(shape, chips)
    return lm_cell_model(arch, shape, chips, microbatches)
