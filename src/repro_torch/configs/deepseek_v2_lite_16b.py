"""deepseek-v2-lite-16b — MoE with multi-head latent attention (MLA).

[arXiv:2405.04434; hf]  27L d_model=2048 16H d_ff=1408 (per-expert)
vocab=102400, MLA kv_lora=512, MoE 64 routed experts top-6 + 2 shared,
first layer dense (d_ff 10944).  long_500k skipped (full attention).
"""
from repro_torch.configs.base import GLOBAL, ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MLA: all heads share one latent; kept for bookkeeping
    head_dim=128,
    d_ff=1408,  # per-expert FFN width
    vocab_size=102400,
    attn_pattern=(GLOBAL,),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,  # V2-Lite uses full-rank q
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        expert_d_ff=1408,
        num_shared_experts=2,
        shared_d_ff=1408,
        first_moe_layer=1,
        dense_d_ff=10944,
    ),
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2405.04434; hf",
)
