"""Mamba-1 selective SSM block: the JAX package's ``models/ssm.py`` on
torch tensors, for serving (prefill and O(1) decode).

The prefill scan is the JAX package's chunked form: the sequence is cut
into chunks of ``chunk`` steps (the largest divisor of S not above the
requested chunk, as there: a prime S gives chunk 1), each chunk is an
associative scan over the affine maps (a_t, b_t) with
(a2, b2)∘(a1, b1) = (a1·a2, a2·b1 + b2), and a Python loop carries the
(B, d_inner, N) fp32 state across chunks.  torch has no
``associative_scan``: ``associative_scan`` below is
``jax.lax.associative_scan``'s odd/even recursion, so the fp32 products
come in the reference's order (a ``cumprod`` / divide shortcut would
lose the state: over a 250-step chunk the running product of ``a``
falls to about 1e-18).  No Pallas kernel exists for this scan in the
JAX package, so none is owed here.

Dtypes are the reference's: ``B_t``, ``C_t`` and ``dt`` are fp32;
``dt_low @ dt_proj`` runs in the model dtype and is widened before the
fp32 ``dt_bias``; ``y + u·D`` is fp32; ``y`` is rounded to the model
dtype before the gate.  ``softplus`` is ``jax.nn.softplus``'s
``logaddexp(x, 0)`` = ``max(x, 0) + log1p(exp(-|x|))``, not
``F.softplus``, which switches to the identity above 20.

``ssm_scan_sharded`` is the ``shard_map`` form that ``ModelOptions(
ssm_impl="sharded")`` selects, the fused round's scan and a model-axis
prefill's.  Across ranks it shards d_inner over the model axis, as the
JAX region does: rank i takes d_inner's slice ``[i·d/m, (i+1)·d/m)`` of
``u``, ``h0`` and the five scan params, the ``x_proj`` contraction is
summed over the model group (the region's one psum), and ``y`` and the
final state are gathered back whole.  At size 1 the psum is the
identity and the inputs are ``_ssm_inputs``'s; without a mesh the named
axis is refused (ROADMAP A.8).  Each chunk body runs under
``torch.utils.checkpoint`` (non-reentrant, so it nests inside a layer's
remat), as under ``jax.checkpoint``: the backward recomputes the chunk
from its carry.
Its default in-chunk form (``intra_chunk="seq"``) steps ``h = a_t·h +
b_t`` one position at a time, ``ssm_decode``'s arithmetic, and never
holds a (B, chunk, d_inner, N) tensor; ``"assoc"`` is the associative
scan of ``ssm_scan_chunked``.  In eager torch the seq form launches a
few kernels a position in each of the forward, the two recomputes and
the backward, so a training round is host-bound; serving keeps the
chunked scan.  ``ssm_decode`` writes the layer's cache in place, as the
port's attention decode does.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import dist
from repro_torch.launch.mesh import model_shards
from repro_torch.models.layers import dense_init


def init_ssm(gen: torch.Generator, cfg: ArchConfig, d_model: int,
             dtype: torch.dtype) -> dict:
    """``dt_bias``, ``A_log`` and ``D`` stay fp32 in a 16-bit model."""
    s = cfg.ssm
    d_in = s.expand * d_model
    dt_rank = s.resolved_dt_rank(d_model)
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (d_model, 2 * d_in), dtype),
        "conv_w": dense_init(gen, (s.d_conv, d_in), dtype, scale=0.5),
        "x_proj": dense_init(gen, (d_in, dt_rank + 2 * s.d_state), dtype),
        "dt_proj": dense_init(gen, (dt_rank, d_in), dtype),
        # softplus(-4.6) ≈ 0.01
        "dt_bias": torch.full((d_in,), -4.6, dtype=torch.float32,
                              device=dev),
        "A_log": torch.log(torch.arange(
            1, s.d_state + 1, dtype=torch.float32, device=dev).repeat(
                d_in, 1)),
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (d_in, d_model), dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor = None) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C), w: (K,C).  With ``state``
    (B,K-1,C) the left context comes from the decode buffer.  The sum
    ``Σ_k w[k]·x[t-(K-1)+k]`` accumulates in x's dtype, k = 0…K-1, as
    the reference does (``F.conv1d`` would add in fp32)."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + S, :] * w[k]
    return out


def _ssm_inputs(cfg: ArchConfig, params: dict, u: torch.Tensor,
                contract=None):
    """u: (B,S,d_in) post-conv activations -> (dt, B_t, C_t, A).
    ``contract``: applied to the ``x_proj`` product (the model group's
    sum when d_in is a rank's slice)."""
    N = cfg.ssm.d_state
    dt_rank = params["dt_proj"].shape[0]
    proj = u @ params["x_proj"]                     # (B,S,dt_rank+2N)
    if contract is not None:
        proj = contract(proj)
    dt_low = proj[..., :dt_rank]
    B_t = proj[..., dt_rank:dt_rank + N].float()
    C_t = proj[..., dt_rank + N:].float()
    dt = softplus((dt_low @ params["dt_proj"]).float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                 # (d_in, N)
    return dt, B_t, C_t, A


def _affine_combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _sl(t: torch.Tensor, dim: int, start, stop=None, step: int = 1):
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a at the even positions of ``dim``, b at the odd ones."""
    shape = list(a.shape)
    shape[dim] += b.shape[dim]
    out = a.new_empty(shape)
    _sl(out, dim, 0, None, 2).copy_(a)
    _sl(out, dim, 1, None, 2).copy_(b)
    return out


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                     dim: int = 0) -> List[torch.Tensor]:
    """Inclusive scan of ``fn`` (``fn(earlier, later)`` on tuples of
    tensors) along ``dim``: ``jax.lax.associative_scan``'s recursion, so
    every combine takes the same operands as there."""
    n = elems[0].shape[dim]
    if n < 2:
        return list(elems)
    # combine adjacent pairs, then scan the pairs
    reduced = fn([_sl(e, dim, 0, -1, 2) for e in elems],
                 [_sl(e, dim, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn([_sl(e, dim, 0, -1) for e in odd],
                  [_sl(e, dim, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [_sl(e, dim, 2, None, 2) for e in elems])
    even = [torch.cat([_sl(e, dim, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def scan_chunk(S: int, chunk: int) -> int:
    """The largest divisor of S not exceeding ``chunk``."""
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    return chunk


def ssm_scan_chunked(cfg: ArchConfig, params: dict, u: torch.Tensor,
                     h0: torch.Tensor, chunk: int = 256
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (B,S,d_in) conv+silu output, h0 (B,d_in,N) fp32 -> (y (B,S,d_in)
    fp32, h_final)."""
    S = u.shape[1]
    chunk = scan_chunk(S, chunk)
    dt, B_t, C_t, A = _ssm_inputs(cfg, params, u)
    uf = u.float()
    h, ys = h0, []
    for lo in range(0, S, chunk):
        dt_c, B_c, C_c, u_c = (t[:, lo:lo + chunk] for t in (dt, B_t, C_t,
                                                              uf))
        a = torch.exp(dt_c[..., None] * A)                  # (B,c,d_in,N)
        b = (dt_c * u_c)[..., None] * B_c[:, :, None, :]    # (B,c,d_in,N)
        a_cum, h_intra = associative_scan(_affine_combine, (a, b), dim=1)
        del a, b
        h_t = a_cum * h[:, None] + h_intra                  # (B,c,d_in,N)
        del a_cum, h_intra
        ys.append(torch.einsum("bcdn,bcn->bcd", h_t, C_c))
        h = h_t[:, -1].clone()
        del h_t
    y = torch.cat(ys, dim=1)
    y = y + uf * params["D"]
    return y, h


def _chunk_seq(h, A, dt_c, dtu_c, B_c, C_c):
    """One chunk, one position at a time: -> (h after the chunk, y_c
    (B,c,d_in) fp32).  Each step is ``ssm_decode``'s update; the chunk's
    inputs are unbound once (their backward stacks the steps' gradients
    once, where a slice a step would allocate the chunk in every one)."""
    ys = []
    # each step's operands already broadcast: (B,d_in,1), (B,1,N), (B,N,1)
    for dt_t, dtu_t, B_s, C_s in zip(
            dt_c[..., None].unbind(1), dtu_c[..., None].unbind(1),
            B_c[:, :, None, :].unbind(1), C_c[..., None].unbind(1)):
        a_t = torch.exp(dt_t * A)                           # (B,d_in,N)
        h = a_t * h + dtu_t * B_s
        ys.append(torch.bmm(h, C_s).squeeze(-1))            # (B,d_in)
    return h, torch.stack(ys, dim=1)


def _chunk_assoc(h, A, dt_c, dtu_c, B_c, C_c):
    """One chunk as ``ssm_scan_chunked``'s associative scan."""
    a = torch.exp(dt_c[..., None] * A)                      # (B,c,d_in,N)
    b = dtu_c[..., None] * B_c[:, :, None, :]
    a_cum, h_intra = associative_scan(_affine_combine, (a, b), dim=1)
    h_t = a_cum * h[:, None] + h_intra
    return h_t[:, -1], torch.einsum("bcdn,bcn->bcd", h_t, C_c)


#: the scan's params and the dim of each that d_inner runs along (the
#: JAX region's ``pspecs``)
SCAN_PARAM_DIMS = {"x_proj": 0, "dt_proj": 1, "dt_bias": 0, "A_log": 0,
                   "D": 0}


def _model_slice(params: dict, u, h0, mesh, model_axis: str, m: int):
    """This model rank's d_inner slice of the scan's params, ``u`` (dim
    2) and ``h0`` (dim 1)."""
    d_in = u.shape[2]
    if d_in % m:
        raise ValueError(f"ssm_scan_sharded: a d_inner of {d_in} does not "
                         f"split over {m} {model_axis!r} ranks")
    n = d_in // m
    lo = mesh.coord(model_axis) * n
    local = {k: params[k].narrow(dim, lo, n)
             for k, dim in SCAN_PARAM_DIMS.items()}
    return local, u.narrow(2, lo, n), h0.narrow(1, lo, n)


def ssm_scan_sharded(cfg: ArchConfig, params: dict, u: torch.Tensor,
                     h0: torch.Tensor, *, chunk: int, dp_axes,
                     model_axis: str, intra_chunk: str = "seq", mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``ssm_scan_sharded``: u (B,S,d_in), h0
    (B,d_in,N) fp32 -> (y (B,S,d_in) fp32, rounded once to u's dtype,
    h_final (B,d_in,N)).  ``dp_axes`` shard the batch, whose rows a rank
    is handed already.  Above size 1 the model axis shards d_inner
    (module docstring): u, h0 and the params are whole on every rank,
    as the computation around the region is replicated, and each rank
    takes its slice; a d_inner that does not split over the axis is
    refused."""
    m = model_shards(mesh, model_axis, "ssm_scan_sharded")
    if intra_chunk not in ("seq", "assoc"):
        raise ValueError(f"unknown intra_chunk {intra_chunk!r}")
    from torch.utils.checkpoint import checkpoint

    contract = None
    if m > 1:
        params, u, h0 = _model_slice(params, u, h0, mesh, model_axis, m)

        # the JAX region's psum over the sharded contraction; a bf16
        # partial product is summed in fp32 (gloo has no bf16 sum, where
        # XLA's psum adds bf16) and rounded once to u's dtype
        def contract(proj):
            return dist.psum(proj.float(), mesh, model_axis).to(proj.dtype)

    S = u.shape[1]
    c = scan_chunk(S, chunk)
    dt, B_t, C_t, A = _ssm_inputs(cfg, params, u, contract)
    uf = u.float()
    dtu = dt * uf
    # looked up at each call, so a planted fault can replace the body
    body = _chunk_seq if intra_chunk == "seq" else _chunk_assoc
    h, ys = h0, []
    for lo in range(0, S, c):
        h, y_c = checkpoint(body, h, A, *(t[:, lo:lo + c] for t in (
            dt, dtu, B_t, C_t)), use_reentrant=False)
        ys.append(y_c)
    y = (torch.cat(ys, dim=1) + uf * params["D"]).to(u.dtype)
    if m > 1:
        y = dist.all_gather(y, mesh, model_axis, dim=2)
        h = dist.all_gather(h, mesh, model_axis, dim=1)
    return y.float(), h


def ssm_block(cfg: ArchConfig, params: dict, x: torch.Tensor,
              chunk: int = 256, return_state: bool = False, *,
              sharded: bool = False, dp_axes=(), model_axis: str = "model",
              mesh=None):
    """Full mamba block: in_proj -> conv -> SSM -> gate -> out_proj, the
    scan ``ssm_scan_sharded``'s when ``sharded``, else the chunked one.
    ``return_state``: -> (out, {"h", "conv"}), the scan's final state
    and the last ``d_conv - 1`` pre-conv inputs, the decode cache that
    the JAX package takes from a second scan of the same inputs; across
    model ranks the state is the sharded scan's, gathered whole."""
    B = x.shape[0]
    d_in = params["dt_proj"].shape[1]
    xz = x @ params["in_proj"]
    raw, z = xz[..., :d_in], xz[..., d_in:]
    u = F.silu(_causal_conv(raw, params["conv_w"]))
    h0 = torch.zeros((B, d_in, cfg.ssm.d_state), dtype=torch.float32,
                     device=x.device)
    if sharded:
        y, h_final = ssm_scan_sharded(cfg, params, u, h0, chunk=chunk,
                                      dp_axes=dp_axes, model_axis=model_axis,
                                      mesh=mesh)
    else:
        y, h_final = ssm_scan_chunked(cfg, params, u, h0, chunk=chunk)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    if not return_state:
        return out
    # a copy: a view would keep the whole (B, S, 2·d_in) projection alive
    conv = raw[:, -(cfg.ssm.d_conv - 1):, :].clone()
    return out, {"h": h_final, "conv": conv}


# ---------------------------------------------------------------------------
# decode: O(1) state update
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg: ArchConfig, d_model: int, batch: int,
                   dtype: torch.dtype, device) -> dict:
    s = cfg.ssm
    d_in = s.expand * d_model
    return {
        "h": torch.zeros((batch, d_in, s.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, d_in), dtype=dtype,
                            device=device),
    }


def ssm_decode(cfg: ArchConfig, params: dict, x: torch.Tensor,
               cache: dict):
    """x: (B, 1, d_model) -> (y (B,1,d_model), cache written in place)."""
    d_in = params["dt_proj"].shape[1]
    xz = x @ params["in_proj"]
    raw, z = xz[..., :d_in], xz[..., d_in:]
    u = F.silu(_causal_conv(raw, params["conv_w"], state=cache["conv"]))
    # the next step's conv window, built before the buffer is overwritten
    window = torch.cat([cache["conv"][:, 1:], raw], dim=1)

    dt, B_t, C_t, A = _ssm_inputs(cfg, params, u)
    uf = u.float()[:, 0]
    a = torch.exp(dt[:, 0, :, None] * A)                    # (B,d_in,N)
    b = (dt[:, 0] * uf)[..., None] * B_t[:, 0, None, :]
    h = a * cache["h"] + b
    y = torch.einsum("bdn,bn->bd", h, C_t[:, 0])
    y = y + uf * params["D"]
    y = y[:, None].to(x.dtype) * F.silu(z)
    cache["h"].copy_(h)
    cache["conv"].copy_(window)
    return y @ params["out_proj"], cache
