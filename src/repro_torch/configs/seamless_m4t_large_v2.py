"""seamless-m4t-large-v2 — encoder-decoder multimodal (audio) backbone.

[arXiv:2308.11596; hf]  24L d_model=1024 16H (GQA kv=16, i.e. MHA)
d_ff=8192 vocab=256206.  The speech frontend (w2v-BERT conformer stack)
is a STUB per the assignment: ``input_specs()`` supplies precomputed
audio frame embeddings of shape (B, frames, d_model); we model the
24-layer text encoder + 24-layer text decoder transformer backbone.
"""
from repro_torch.configs.base import GLOBAL, ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,           # decoder layers
    encoder_layers=24,       # encoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    attn_pattern=(GLOBAL,),
    frontend="audio",
    frontend_tokens=512,     # precomputed speech frames fed to the encoder
    tie_embeddings=True,
    source="arXiv:2308.11596; hf",
)
