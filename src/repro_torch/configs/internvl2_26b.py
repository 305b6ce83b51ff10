"""internvl2-26b — VLM: InternViT frontend (STUB) + InternLM2-20B backbone.

[arXiv:2404.16821; hf]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553.  The ViT frontend is a stub per the assignment:
``input_specs()`` provides precomputed patch embeddings
(B, 256, d_model) that are prepended to the text sequence.
long_500k is skipped (pure full attention).
"""
from repro_torch.configs.base import GLOBAL, ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    attn_pattern=(GLOBAL,),
    frontend="vision",
    frontend_tokens=256,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="arXiv:2404.16821; hf",
)
