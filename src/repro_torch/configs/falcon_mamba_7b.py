"""falcon-mamba-7b — attention-free Mamba-1 SSM.

[arXiv:2410.05355; unverified]  64L d_model=4096 (attn-free) d_ff=0
vocab=65024, ssm_state=16, expand=2 (d_inner=8192), conv=4.
The flagship sub-quadratic arch: decode state is O(1), long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,      # unused (attention-free)
    num_kv_heads=1,   # unused
    head_dim=1,
    d_ff=0,
    vocab_size=65024,
    attention_free=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=False,
    source="arXiv:2410.05355; unverified",
)
