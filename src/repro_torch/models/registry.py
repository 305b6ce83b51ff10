"""Model facade: the JAX package's ``LM`` interface for training and
serving.

``LM`` exposes what the fused round and the serving path need:

  init(seed, device=None) -> params                 (on the card by default)
  loss(params, batch) -> (scalar, {"ce", "moe_aux"})
  prefill(params, batch) -> (last-token logits, caches)
  init_decode(batch, capacity, device=None) -> caches
  decode_step(params, tokens, caches, pos) -> (logits, caches)

Batches are dicts: train ``{"tokens", "labels"}`` (B,S) int (label -1
is ignored), prefill ``{"tokens": (B,S) int, "frontend": (B,F,D)?}``;
decode takes tokens (B,1), the caches and the absolute position
``pos``.  Caches are written in place by ``decode_step`` (see
``models/attention.py``).

A config with a modality frontend takes the stub's precomputed
embeddings as ``"frontend"``, projected by ``frontend_proj``: a
decoder-only one (internvl2-26b) puts the patches in front of the
text, so its decode positions start after them (``pos = F + S + i``);
an encoder–decoder (seamless-m4t-large-v2) encodes the frames
(``_encode``) into the memory its decoder's cross-attention reads, and
its decode caches hold that memory's K/V.  A batch's ``"frontend"`` is
ignored for a config without a frontend, as in the JAX package.  The
loss of a decoder-only frontend config drops the patch positions before
the cross-entropy (the labels cover the text only); an encoder–decoder's
encoder and ``frontend_proj`` take their gradient through every decoder
layer's cross-attention.  SSM and hybrid configs train with either scan
(``ssm_impl="sharded"`` is the fused round's, ``models/ssm.py``).

On a model axis across ranks (``ModelOptions(mesh=...)``) every family
runs as in the JAX package's step: ``chunked_sp`` splits the rows of
each self-attention layer (a decoder-only frontend's F + S rows, an
encoder's frames, non-causal), the decoder's cross-attention runs
replicated over the whole memory, the SSM scan shards d_inner, and the
vocab and the experts are sharded as for the dense and MoE families.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (dense_init, init_embedding,
                                       init_rmsnorm, rmsnorm)
from repro_torch.models.sharded_vocab import (chunked_lm_loss_sharded,
                                              decode_logits, embed_lookup,
                                              padded_vocab)
from repro_torch.models.transformer import ModelOptions
from repro_torch.sharding.rules import gather_tree, layer_specs

MOE_AUX_WEIGHT = 0.01


class LM:
    def __init__(self, cfg: ArchConfig, opts: Optional[ModelOptions] = None):
        self.cfg = cfg
        self.opts = opts or ModelOptions()
        self.specs = tfm.layer_specs(cfg)
        self.enc_specs = tfm.encoder_specs(cfg)
        self.dtype = getattr(torch, cfg.dtype)

    # ------------------------------------------------------------------
    def init(self, seed: int, device: Any = None) -> Dict[str, Any]:
        """Random params from ``seed``, drawn on ``device`` (None: the card)."""
        cfg = self.cfg
        dev = resolve_device(device)
        # on the meta device nothing is drawn (``fl/round.py::
        # abstract_params``): a meta tensor holds no values
        gen = _MetaDraws() if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(seed)
        vp = padded_vocab(cfg.vocab_size)
        params: Dict[str, Any] = {
            "embed": init_embedding(gen, vp, cfg.d_model, self.dtype),
            "segments": tfm.init_stack(gen, cfg, self.specs, self.dtype),
            "final_norm": init_rmsnorm(cfg.d_model, self.dtype, gen.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model, vp), self.dtype)
        if self.enc_specs:
            params["encoder"] = {
                "segments": tfm.init_stack(gen, cfg, self.enc_specs,
                                           self.dtype),
                "final_norm": init_rmsnorm(cfg.d_model, self.dtype,
                                           gen.device),
            }
        if cfg.frontend:
            params["frontend_proj"] = dense_init(
                gen, (cfg.d_model, cfg.d_model), self.dtype)
        return params

    # ------------------------------------------------------------------
    def _whole(self, params):
        """With ``param_specs``, the leaves used outside the layer loops
        (embedding, head, final norms, frontend projection) gathered
        whole; the layers' leaves are gathered a layer at a time inside
        the loops (``_layer_gathers``)."""
        specs, mesh = self.opts.param_specs, self.opts.mesh
        if specs is None:
            return params
        out = {}
        for k, v in params.items():
            if k == "segments":
                out[k] = v
            elif k == "encoder":
                out[k] = {"segments": v["segments"],
                          "final_norm": gather_tree(
                              v["final_norm"], specs[k]["final_norm"], mesh)}
            else:
                out[k] = gather_tree(v, specs[k], mesh)
        return out

    def _layer_gathers(self, *path):
        """One function a segment of the stack at ``path`` that gathers a
        layer's blocks whole (None without ``param_specs``)."""
        specs = self.opts.param_specs
        if specs is None:
            return None
        for k in path:
            specs = specs[k]
        mesh = self.opts.mesh
        return [functools.partial(gather_tree, specs=layer_specs(s),
                                  mesh=mesh) for s in specs]

    def _unembed_w(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"], True
        return params["lm_head"], False

    def _embed(self, params, tokens) -> torch.Tensor:
        table = params["embed"]
        tokens = torch.as_tensor(tokens, device=table.device)
        x = embed_lookup(table, tokens, self.opts.vocab_axis, self.opts.mesh)
        # the JAX package multiplies by a weakly typed scalar, which takes
        # the table's dtype before the product
        mult = torch.full((), math.sqrt(self.cfg.d_model), dtype=x.dtype,
                          device=x.device)
        return (x * mult).to(self.dtype)

    def _project_frontend(self, params, frontend) -> torch.Tensor:
        """The stub's embeddings (B, F, D), in the model's dtype, through
        ``frontend_proj`` (not scaled by sqrt(d))."""
        if frontend is None:
            raise ValueError(f"{self.cfg.name} takes the stub's "
                             f"{self.cfg.frontend} embeddings as the "
                             "batch's 'frontend' (B, F, d_model)")
        w = params["frontend_proj"]
        return torch.as_tensor(frontend, device=w.device).to(self.dtype) @ w

    def _encode(self, params, frontend) -> torch.Tensor:
        """The encoder over the stub's frame embeddings -> memory (B,F,D)."""
        x = self._project_frontend(params, frontend)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, _ = tfm.apply_stack(
            self.cfg, params["encoder"]["segments"], self.enc_specs,
            self.opts, x, positions,
            gather=self._layer_gathers("encoder", "segments"))
        return rmsnorm(params["encoder"]["final_norm"], x, self.cfg.norm_eps)

    def _embed_inputs(self, params, tokens, frontend):
        """-> (the token embeddings with a decoder-only model's patch
        embeddings in front, the number of patches)."""
        x = self._embed(params, tokens)
        if not self.cfg.frontend or self.enc_specs:
            return x, 0
        fx = self._project_frontend(params, frontend)
        return torch.cat([fx, x], dim=1), fx.shape[1]

    def _check_split(self, tokens, frontend) -> None:
        """Refuse, by name, rows that ``chunked_sp`` cannot split over a
        model axis above 1: an encoder's frames, or a decoder-only
        frontend's F patches and S tokens together (checked before the
        forward's first collective; a plain sequence is refused by
        ``flash_self_attention_sp``)."""
        cfg, opts = self.cfg, self.opts
        if (opts.attn_impl != "chunked_sp" or opts.mesh is None
                or not cfg.frontend or frontend is None):
            return
        m = opts.mesh.shape.get(opts.model_axis, 1)
        F, S = frontend.shape[1], tokens.shape[1]
        if self.enc_specs and F % m:
            raise ValueError(f"{cfg.name}: {F} frames do not split over "
                             f"{m} {opts.model_axis!r} ranks")
        if not self.enc_specs and (F + S) % m:
            raise ValueError(f"{cfg.name}: F + S = {F} patches + {S} "
                             f"tokens do not split over {m} "
                             f"{opts.model_axis!r} ranks")

    def _forward(self, params, tokens, frontend=None, collect_cache=False):
        """-> (hidden, aux, caches, the number of patches in front)."""
        self._check_split(tokens, frontend)
        memory = self._encode(params, frontend) if self.enc_specs else None
        x, n_front = self._embed_inputs(params, tokens, frontend)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux, caches = tfm.apply_stack(
            self.cfg, params["segments"], self.specs, self.opts,
            x, positions, memory=memory, collect_cache=collect_cache,
            gather=self._layer_gathers("segments"),
        )
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return x, aux, caches, n_front

    # ------------------------------------------------------------------
    def loss(self, params, batch) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
        params = self._whole(params)
        hidden, aux, _, n_front = self._forward(
            params, batch["tokens"], batch.get("frontend"))
        if n_front:
            # the CE is over the text: the patches in front have no labels
            hidden = hidden[:, n_front:]
        w, tied = self._unembed_w(params)
        labels = torch.as_tensor(batch["labels"], device=hidden.device)
        ce = chunked_lm_loss_sharded(
            hidden, w, labels, vocab=self.cfg.vocab_size, tied=tied,
            model_axis=self.opts.vocab_axis, chunk=self.opts.loss_chunk,
            mesh=self.opts.mesh)
        total = ce + MOE_AUX_WEIGHT * aux
        return total, {"ce": ce, "moe_aux": aux}

    # ------------------------------------------------------------------
    def prefill(self, params, batch):
        """-> (logits (B,1,V) fp32 of the last position, caches).  A
        decoder-only frontend's patches take positions 0 .. F - 1, so the
        first decode step is at ``pos = F + S``."""
        params = self._whole(params)
        hidden, _, caches, _ = self._forward(
            params, batch["tokens"], batch.get("frontend"),
            collect_cache=True)
        w, tied = self._unembed_w(params)
        logits = decode_logits(
            hidden[:, -1:], w, vocab=self.cfg.vocab_size, tied=tied,
            model_axis=self.opts.vocab_axis, mesh=self.opts.mesh,
        )
        return logits, caches

    # ------------------------------------------------------------------
    def init_decode(self, batch: int, capacity: int, device: Any = None):
        """Empty ring caches on ``device`` (None: the card); an
        encoder–decoder's cross caches hold ``frontend_tokens`` rows."""
        mem_len = self.cfg.frontend_tokens if self.enc_specs else 0
        return tfm.init_stack_cache(self.cfg, self.specs, batch, capacity,
                                    self.dtype, resolve_device(device),
                                    mem_len)

    def decode_step(self, params, tokens, caches, pos):
        """tokens (B,1) -> (logits (B,1,V) fp32, caches written in place)."""
        params = self._whole(params)
        x = self._embed(params, tokens)
        x, new_caches = tfm.decode_stack(
            self.cfg, params["segments"], self.specs, self.opts, x, caches,
            pos, gather=self._layer_gathers("segments"))
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        w, tied = self._unembed_w(params)
        logits = decode_logits(
            x, w, vocab=self.cfg.vocab_size, tied=tied,
            model_axis=self.opts.vocab_axis, mesh=self.opts.mesh,
        )
        return logits, new_caches


class _MetaDraws:
    """``LM.init``'s generator on the meta device, where nothing is
    drawn (``layers.dense_init``)."""

    device = torch.device("meta")


def build_model(cfg: ArchConfig, opts: Optional[ModelOptions] = None) -> LM:
    return LM(cfg, opts)
