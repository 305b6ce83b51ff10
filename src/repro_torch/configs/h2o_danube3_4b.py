"""h2o-danube-3-4b — dense llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]  24L d_model=3840 32H (GQA kv=8)
d_ff=10240 vocab=32000.  Mistral-style SWA on every layer (window 4096)
makes the KV cache bounded, so long_500k applies.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    attn_pattern=(4096,),   # SWA everywhere (mistral mix)
    rope_theta=500_000.0,
    tie_embeddings=False,
    source="arXiv:2401.16818; unverified",
)
