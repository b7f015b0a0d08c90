"""seamless-m4t-medium — enc-dec, multimodal [arXiv:2308.11596; hf].

12L enc + 12L dec, d_model=1024 16H (kv=16 => MHA) d_ff=4096 vocab=256206.
Modality frontend is a STUB: input_specs() provides precomputed speech frame
embeddings for the encoder (DESIGN.md Sec. 4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256_206, rope_theta=10_000.0,
    source="arXiv:2308.11596",
)
