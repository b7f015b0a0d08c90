"""moonshot-v1-16b-a3b — kimi/moonlight MoE 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (kv=16 => MHA) d_ff=1408/expert vocab=163840.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=163_840, n_experts=64, top_k=6, rope_theta=50_000.0,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
