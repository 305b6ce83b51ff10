"""llama3.2-3b — small llama3, pure full attention.

[hf:meta-llama/Llama-3.2-1B; unverified]  28L d_model=3072 24H (GQA kv=8)
d_ff=8192 vocab=128256.  long_500k is skipped (pure full attention).
"""
from repro_torch.configs.base import GLOBAL, ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    attn_pattern=(GLOBAL,),
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)
