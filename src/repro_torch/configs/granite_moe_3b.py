"""granite-moe-3b-a800m — 40 experts top-8 [hf:ibm-granite family; hf].

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 40e top-8.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49_155, n_experts=40, top_k=8, rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
