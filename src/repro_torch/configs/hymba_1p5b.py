"""hymba-1.5b — parallel attn+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
128 meta tokens; SWA(1024) everywhere except 3 global full-attention layers
(first/middle/last), per the Hymba recipe.  SSM branch: expand=1 so the
mamba heads mirror the 25x64 attention geometry (DESIGN.md Sec. 4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32_001, d_state=16, expand=1, d_conv=4, ssm_headdim=64,
    swa_window=1024, n_global_layers=3, n_meta_tokens=128,
    rope_theta=10_000.0,
    source="arXiv:2411.13676",
)
