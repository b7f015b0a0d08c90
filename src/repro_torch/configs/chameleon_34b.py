"""chameleon-34b — early-fusion VLM, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  Backbone only: the
VQ-VAE image tokenizer is a stub; image tokens share the 65536 vocab.
QK-norm enabled (Chameleon's logit-divergence fix).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22_016,
    vocab_size=65_536, qk_norm=True, rope_theta=10_000.0,
    source="arXiv:2405.09818",
)
