"""lm100m — ~100M-parameter llama-style model for the end-to-end training
example (examples/train_lm.py).  Not part of the assigned pool.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="lm100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
    vocab_size=32_000, rope_theta=10_000.0,
    source="examples",
)
