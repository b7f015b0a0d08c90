"""Architecture + run configuration.

One :class:`ArchConfig` per assigned architecture lives in
``repro_torch/configs/<id>.py``; reduced smoke variants are derived with
:meth:`ArchConfig.smoke`.  Shape sets (train_4k / prefill_32k / decode_32k /
long_500k) are defined here and gated per-family (``long_500k`` requires
sub-quadratic attention — DESIGN.md Sec. 4).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    swa_window: int = 0              # 0 = full attention
    n_global_layers: int = 0         # hybrid: layers with full attn
    n_meta_tokens: int = 0           # hybrid: learned prefix tokens
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm
    d_state: int = 0
    expand: int = 2
    d_conv: int = 4
    ssm_headdim: int = 64
    # enc-dec
    enc_layers: int = 0              # encoder layers (dec = n_layers)
    # numerics
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # provenance
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k eligibility: sub-quadratic sequence mixing."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d
        if self.family == "ssm":
            di, ns, hd = self.d_inner, self.d_state, self.ssm_headdim
            nh = di // hd
            per = (d * (2 * di + 2 * ns + nh)        # in_proj (z,x,B,C,dt)
                   + self.d_conv * (di + 2 * ns)     # conv
                   + di * d                          # out_proj
                   + 2 * nh + di)                    # A, D, norm
            return emb * 2 + L * per
        attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * self.head_dim * d
        if self.family == "moe":
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        per = attn + ffn + 2 * d
        layers = L + self.enc_layers
        if self.family == "encdec":
            per = per + attn                         # cross attention
        if self.family == "hybrid":
            di, ns, hd = self.d_inner, self.d_state, self.ssm_headdim
            nh = di // hd
            per = per + (d * (2 * di + 2 * ns + nh) + di * d
                         + self.d_conv * (di + 2 * ns) + 2 * nh + di)
        return emb * 2 + layers * per

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d
        attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * self.head_dim * d
        ffn = self.top_k * 3 * d * self.d_ff + d * self.n_experts
        return emb * 2 + L * (attn + ffn + 2 * d)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            d_state=min(self.d_state, 16) if self.d_state else 0,
            ssm_headdim=16,
            enc_layers=2 if self.enc_layers else 0,
            n_meta_tokens=min(self.n_meta_tokens, 8),
            swa_window=min(self.swa_window, 16) if self.swa_window else 0,
            n_global_layers=min(self.n_global_layers, 1),
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """The shape cells this architecture runs (DESIGN.md Sec. 4)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return out
