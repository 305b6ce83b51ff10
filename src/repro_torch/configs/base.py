"""Architecture / shape configuration system.

Every assigned architecture is expressed as an :class:`ArchConfig`; the
four assigned input shapes as :class:`ShapeConfig`.  Configs are frozen
dataclasses so they can be hashed into jit static args and used as keys
of the warm-executable cache (LIFL aggregator reuse, DESIGN.md C8).

Nothing in this module touches jax device state: configs must be
importable before ``XLA_FLAGS`` is set by the dry-run launcher.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    # index of the first MoE layer; layers [0, first_moe_layer) use a dense
    # FFN of width ``dense_d_ff`` (DeepSeek/Kimi "first_k_dense_replace").
    first_moe_layer: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 style selective-SSM configuration."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank > 0 else -(-d_model // 16)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention configuration."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 -> full-rank q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


# ---------------------------------------------------------------------------
# Main architecture config
# ---------------------------------------------------------------------------

# Attention pattern entries: window size per layer; GLOBAL means full causal.
GLOBAL = -1


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention structure ---------------------------------------------
    # Repeating per-layer window pattern, tiled over layers.  (GLOBAL,) is
    # full attention everywhere; (1024,)*5 + (GLOBAL,) is gemma3's 5:1.
    attn_pattern: Tuple[int, ...] = (GLOBAL,)
    rope_theta: float = 10_000.0
    qk_norm: bool = False

    # --- optional blocks ---------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    attention_free: bool = False  # falcon-mamba: no attention at all
    hybrid_parallel_ssm: bool = False  # hymba: attn + SSM in parallel per layer

    # --- encoder-decoder ----------------------------------------------------
    encoder_layers: int = 0  # >0 -> enc-dec (seamless)

    # --- modality frontend stub ---------------------------------------------
    # 'audio' | 'vision' | None.  Stub frontends mean input_specs() provides
    # precomputed frame/patch embeddings of shape (B, frontend_tokens, d_model).
    frontend: Optional[str] = None
    frontend_tokens: int = 0

    # --- numerics ------------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # --- provenance ------------------------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_layers >= 1
        if not self.attention_free and self.mla is None:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
                f"{self.name}: q heads {self.num_heads} not divisible by "
                f"kv heads {self.num_kv_heads}"
            )

    # ------------------------------------------------------------------
    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer attention window sizes (GLOBAL = full causal)."""
        pat = self.attn_pattern
        n = self.num_layers
        return tuple(pat[i % len(pat)] for i in range(n))

    def is_sub_quadratic(self) -> bool:
        """True if long-context decode is feasible (SSM / hybrid / SWA)."""
        if self.attention_free or self.ssm is not None:
            return True
        # Any sliding-window layer caps its cache; arch qualifies if not
        # *pure* full attention.
        return any(w != GLOBAL for w in self.layer_windows())

    def moe_layer_flags(self) -> Tuple[bool, ...]:
        if self.moe is None:
            return tuple(False for _ in range(self.num_layers))
        return tuple(i >= self.moe.first_moe_layer for i in range(self.num_layers))

    # ------------------------------------------------------------------
    # Parameter counting (analytical; used for MODEL_FLOPS and capacity
    # planning).  Mirrors models/* init exactly — tested against real
    # pytrees in tests/test_params.py.
    # ------------------------------------------------------------------
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        return _param_count(self, active_only=True)

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family variant for CPU smoke tests."""
        small: dict = dict(
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
        )
        if self.encoder_layers:
            small["encoder_layers"] = 2
        if self.frontend_tokens:
            small["frontend_tokens"] = 4
        if self.moe is not None:
            small["moe"] = MoEConfig(
                num_experts=8,
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=64,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                shared_d_ff=64 if self.moe.num_shared_experts else 0,
                first_moe_layer=min(self.moe.first_moe_layer, 1),
                dense_d_ff=128 if self.moe.first_moe_layer else 0,
            )
        if self.ssm is not None:
            small["ssm"] = MoEConfig if False else SSMConfig(
                d_state=8, d_conv=4, expand=2, dt_rank=8
            )
        if self.mla is not None:
            small["mla"] = MLAConfig(
                kv_lora_rank=32,
                qk_nope_head_dim=16,
                qk_rope_head_dim=8,
                v_head_dim=16,
            )
        # keep the attention pattern shape but shrink windows so locality
        # still exercises masking on tiny sequences
        small["attn_pattern"] = tuple(
            (8 if w != GLOBAL else GLOBAL) for w in self.attn_pattern
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell is runnable; else reason for skip.

    Rules (per assignment + DESIGN.md §Arch-applicability):
      * long_500k needs sub-quadratic attention — skipped for pure
        full-attention archs.
      * all assigned archs have a decoder, so decode shapes always apply.
    """
    if shape.name == "long_500k" and not arch.is_sub_quadratic():
        return False, "pure full-attention arch; long_500k skipped per DESIGN.md"
    return True, ""


# ---------------------------------------------------------------------------
# Analytical parameter count
# ---------------------------------------------------------------------------


def _attn_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        n = 0
        if m.q_lora_rank:
            n += d * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * qk_head
        else:
            n += d * cfg.num_heads * qk_head
        # compressed kv + rope key
        n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
        # decompression
        n += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
        # output
        n += cfg.num_heads * m.v_head_dim * d
        return n
    hd = cfg.head_dim
    q = d * cfg.num_heads * hd
    kv = 2 * d * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * d
    return q + kv + o


def _ssm_params(cfg: ArchConfig, d_model: int) -> int:
    s = cfg.ssm
    d_in = s.expand * d_model
    dt_rank = s.resolved_dt_rank(d_model)
    n = d_model * 2 * d_in  # in_proj (x and z)
    n += d_in * s.d_conv  # depthwise conv
    n += d_in * (dt_rank + 2 * s.d_state)  # x_proj -> (dt, B, C)
    n += dt_rank * d_in + d_in  # dt_proj (+bias)
    n += d_in * s.d_state + d_in  # A_log, D
    n += d_in * d_model  # out_proj
    return n


def _ffn_params(d_model: int, d_ff: int) -> int:
    # gated SwiGLU: gate, up, down
    return 3 * d_model * d_ff


def _layer_params(cfg: ArchConfig, layer: int, active_only: bool) -> int:
    d = cfg.d_model
    n = 2 * d  # two RMSNorms
    if cfg.attention_free:
        n = d  # single norm per mamba block
        n += _ssm_params(cfg, d)
        return n
    n += _attn_params(cfg)
    if cfg.qk_norm:
        n += 2 * cfg.head_dim
    if cfg.hybrid_parallel_ssm:
        n += _ssm_params(cfg, d)
    moe = cfg.moe
    if moe is not None and layer >= moe.first_moe_layer:
        n += d * moe.num_experts  # router
        experts = moe.top_k if active_only else moe.num_experts
        n += experts * _ffn_params(d, moe.expert_d_ff)
        n += moe.num_shared_experts * _ffn_params(d, moe.shared_d_ff)
    elif moe is not None:
        n += _ffn_params(d, moe.dense_d_ff)
    else:
        n += _ffn_params(d, cfg.d_ff)
    return n


def _param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    vp = -(-cfg.vocab_size // 256) * 256  # tables padded for vocab sharding
    n = vp * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        n += vp * cfg.d_model
    n += cfg.d_model  # final norm
    for layer in range(cfg.num_layers):
        n += _layer_params(cfg, layer, active_only)
    for layer in range(cfg.encoder_layers):
        # encoder layer = self-attn + ffn (non-causal); decoder layers above
        # additionally carry cross-attention.
        n += 2 * cfg.d_model + _attn_params(cfg) + _ffn_params(cfg.d_model, cfg.d_ff)
    if cfg.encoder_layers:
        # cross-attention in each decoder layer
        n += cfg.num_layers * (_attn_params(cfg) + cfg.d_model)
    if cfg.frontend:
        n += cfg.d_model * cfg.d_model  # frontend adapter stub projection
    return n
