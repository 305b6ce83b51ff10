"""hymba-1.5b — hybrid-head: parallel attention + mamba heads per layer.

[arXiv:2411.13676; hf]  32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16.  Each layer runs attention and an SSM branch
in parallel on the same input and fuses (mean of normed branch outputs),
per the Hymba hybrid-head module.  Most layers use local (SWA) attention
with a few global layers (first / middle / last), so long_500k applies.
Hymba's learnable meta-tokens are omitted (not architecture-critical;
noted in DESIGN.md).
"""
from repro_torch.configs.base import GLOBAL, ArchConfig, SSMConfig

_WINDOW = 1024
# 32-layer pattern with global attention at layers 0, 15, 31.
_PATTERN = tuple(
    GLOBAL if i in (0, 15, 31) else _WINDOW for i in range(32)
)

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_pattern=_PATTERN,
    hybrid_parallel_ssm=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=True,
    source="arXiv:2411.13676; hf",
)
