"""What each rank runs in ``tests/test_torch_model_axis_ssm_front.py``:
the SSM scan's model axis, the SSM, hybrid, frontend and encoder configs
on a model axis, and the serving steps across ranks.

Like ``tests/_torch_model_ranks.py``, whose step and trainer bodies it
reuses, a module that imports neither JAX nor the JAX package.  A rank's
gradient of a region is its *part* (``launch/dist.py``): the module-level
cases seed the cotangent on the model group's first rank and sum the
parts over the group.
"""
import torch

from _torch_model_ranks import (DM, _np, _parts_summed, _rows, _seed,
                                cfg_of, step_cases, trainer_rounds)
from repro_torch.fl.round import build_decode_step, build_prefill_step
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import ssm as tssm
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

SCAN_KEYS = tuple(sorted(tssm.SCAN_PARAM_DIMS))


def scan_cases(rank, device, cases, inputs):
    """``ssm_scan_sharded`` of reduced falcon-mamba-7b on a ``(data,
    model)`` mesh for each case ``(name, shape, intra_chunk)`` on
    ``inputs`` = (the five params by ``SCAN_KEYS``, u, h0, y's and
    h_final's cotangents): this rank's rows of y, h_final and the
    gradients of ``Σ y·cy + Σ h·ch`` for u and h0, and the params'
    gradients summed over the mesh -> {name: [y, h, du, dh0, *dparams]}."""
    cfg = cfg_of("falcon-mamba-7b")
    out = {}
    for name, shape, intra in cases:
        mesh = make_debug_mesh(shape, DM)
        params, u, h0, cy, ch = inputs
        live = {k: torch.from_numpy(params[k]).to(device).requires_grad_()
                for k in SCAN_KEYS}
        u, h0, cy, ch = (_rows(torch.from_numpy(a).to(device), mesh)
                         for a in (u, h0, cy, ch))
        u, h0 = u.requires_grad_(), h0.requires_grad_()
        y, h = tssm.ssm_scan_sharded(cfg, live, u, h0, chunk=4,
                                     dp_axes=("data",), model_axis="model",
                                     intra_chunk=intra, mesh=mesh)
        grads = torch.autograd.grad(
            (y * cy).sum() + (h * ch).sum(),
            [u, h0, *(live[k] for k in SCAN_KEYS)],
            grad_outputs=_seed(mesh))
        mine = _parts_summed(mesh, list(grads[:2]))
        shared = _parts_summed(mesh, list(grads[2:]), DM)
        out[name] = [_np(y), _np(h)] + [_np(g) for g in mine + shared]
    return out


def serve_cases(rank, device, cases, inits, inputs):
    """The serving steps of reduced fp32 ``arch`` on a ``(data,
    model)`` mesh for each case ``(name, arch, shape)``, from the JAX
    package's init leaves ``inits[arch]``: prefill of ``inputs[arch]``'s
    ``"tokens"`` (and ``"frontend"``), then a decode step a column of its
    ``"decode"`` tokens (this rank's rows) -> {name: {"logits": [the
    prefill's, each step's], "caches": the prefill's cache leaves}}."""
    out = {}
    for name, arch, shape in cases:
        cfg = cfg_of(arch)
        mesh = make_debug_mesh(shape, DM)
        prefill, model = build_prefill_step(cfg, mesh)
        decode, _ = build_decode_step(cfg, mesh)
        _, treedef = tree_flatten(model.init(0, device=device))
        params = tree_unflatten(treedef, [torch.from_numpy(a).to(device)
                                          for a in inits[arch]])
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in inputs[arch].items() if k != "decode"}
        logits, caches = prefill(params, batch)
        # copies: the decode steps write the caches in place
        got = {"logits": [_np(logits)],
               "caches": [_np(t).copy() for t in tree_leaves(caches)]}
        toks = _rows(torch.from_numpy(inputs[arch]["decode"]).to(device),
                     mesh)
        pos = batch["tokens"].shape[1] + (
            cfg.frontend_tokens if cfg.frontend and not cfg.encoder_layers
            else 0)
        for i in range(toks.shape[1]):
            logits, caches = decode(params, toks[:, i:i + 1], caches,
                                    pos + i)
            got["logits"].append(_np(logits))
        out[name] = got
    return out


def run_plan(rank, device, plan):
    """Each part of ``plan`` in turn, in one process group; -> {part:
    result}."""
    torch.set_num_threads(1)
    parts = {"steps": step_cases, "scans": scan_cases,
             "serve": serve_cases}
    out = {k: fn(rank, device, *plan[k]) for k, fn in parts.items()
           if k in plan}
    if "trainer" in plan:
        out["trainer"] = trainer_rounds(rank, device, *plan["trainer"])
    return out
