"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table entry).

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8, per the
assignment sheet) d_ff=2048 (per-expert) vocab=163840, MoE 384 experts
top-8 + 1 shared expert, first layer dense (d_ff 18432).
Total params ≈ 1.03e12, active ≈ 32e9.  long_500k skipped (full attn).
"""
from repro_torch.configs.base import GLOBAL, ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,  # per-expert FFN width
    vocab_size=163840,
    attn_pattern=(GLOBAL,),
    moe=MoEConfig(
        num_experts=384,
        top_k=8,
        expert_d_ff=2048,
        num_shared_experts=1,
        shared_d_ff=2048,
        first_moe_layer=1,
        dense_d_ff=18432,
    ),
    rope_theta=50_000.0,
    tie_embeddings=False,
    source="arXiv:2501.kimi2; unverified",
)
