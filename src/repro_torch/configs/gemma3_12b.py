"""gemma3-12b — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]  48L d_model=3840 16H (GQA kv=8)
d_ff=15360 vocab=262144, head_dim=256, qk-norm, local window 1024.
"""
from repro_torch.configs.base import GLOBAL, ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    attn_pattern=(1024, 1024, 1024, 1024, 1024, GLOBAL),
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
