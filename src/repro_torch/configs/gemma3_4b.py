"""gemma3-4b — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]  34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144, head_dim=256, qk-norm, local window 1024.
"""
from repro_torch.configs.base import GLOBAL, ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    attn_pattern=(1024, 1024, 1024, 1024, 1024, GLOBAL),  # 5 local : 1 global
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
