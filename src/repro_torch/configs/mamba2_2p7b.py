"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060; unverified].

64L d_model=2560, attention-free, vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50_280,
    d_state=128, expand=2, d_conv=4, ssm_headdim=64,
    source="arXiv:2405.21060",
)
