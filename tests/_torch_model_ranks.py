"""What each rank runs in the port's model-axis tests
(``tests/test_torch_model_axis.py``, ``tests/test_torch_gpu.py``).

Like ``tests/_torch_dist_ranks.py``, a module that imports neither JAX
nor the JAX package: ``spawn_ranks`` pickles these functions by their
import path and every rank imports it.  Each returns host data.

A rank's gradient of a model-axis region is its *part*
(``launch/dist.py``): the module-level cases seed the cotangent on the
model group's first rank only and sum the parts over the group, so
every rank returns the one-device gradient of its data rows.
"""
import dataclasses

import torch

from repro_torch.configs import ARCHS
from repro_torch.fl.round import AggregationConfig, build_train_step
from repro_torch.fl.server import init_server_state
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import sharded_vocab as tvocab
from repro_torch.models.flash import flash_self_attention_sp
from repro_torch.runtime import FusedFLTrainer
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

AXES = ("pod", "data", "model")
DM = ("data", "model")


def cfg_of(arch):
    return ARCHS[arch].reduced(dtype="float32")


def _np(t):
    return t.detach().cpu().numpy()


def _parts_summed(mesh, grads, axes=("model",)):
    """Each gradient part summed over the ranks that differ on ``axes``
    (in place)."""
    group = mesh.group(*axes)
    if group is not None:
        for g in grads:
            torch.distributed.all_reduce(g, group=group)
    return grads


def _seed(mesh):
    return torch.tensor(float(mesh.coord("model") == 0))


def _rows(x, mesh):
    """This rank's block of the leading (batch) axis over ``data``."""
    n, d = mesh.shape["data"], mesh.coord("data")
    b = x.shape[0] // n
    return x[d * b:(d + 1) * b]


def step_cases(rank, device, cases, inits, batches):
    """One step of each case ``(name, arch, shape, hierarchy, compress)``
    from the JAX package's init leaves ``inits[arch]`` on
    ``batches[arch]``; -> {name: {"params", "metrics", "wire"}}."""
    out = {}
    for name, arch, shape, hier, comp in cases:
        cfg = cfg_of(arch)
        mesh = make_debug_mesh(shape, AXES)
        agg = AggregationConfig(hierarchy=hier, compress=comp,
                                num_microbatches=2)
        step, model = build_train_step(cfg, mesh, agg)
        _, treedef = tree_flatten(model.init(0, device=device))
        params = tree_unflatten(treedef, [torch.from_numpy(a).to(device)
                                          for a in inits[arch]])
        tb = {k: torch.from_numpy(v).to(device)
              for k, v in batches[arch].items()}
        new, state, m = step(params, init_server_state("fedavg", params),
                             tb)
        out[name] = {"params": [_np(t) for t in tree_leaves(new)],
                     "metrics": {k: float(v) for k, v in m.items()},
                     "step": int(state["step"]),
                     "wire": {k: dict(v) for k, v in mesh.wire.stats.items()}}
    return out


def flash_cases(rank, device, cases, inputs):
    """``flash_self_attention_sp`` on a ``(data, model)`` mesh for each
    case ``(name, shape, window)`` on ``inputs[name]`` = (q, k, v, the
    output's cotangent): this rank's rows of the output and of the
    gradients of ``Σ out·g`` -> {name: [out, dq, dk, dv]}."""
    out = {}
    for name, shape, window in cases:
        mesh = make_debug_mesh(shape, DM)
        q, k, v, g = (_rows(torch.from_numpy(a).to(device), mesh)
                      for a in inputs[name])
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        o = flash_self_attention_sp(q, k, v, window, True,
                                    q.shape[-1] ** -0.5, 8, "model", mesh)
        grads = torch.autograd.grad((o * g).sum(), (q, k, v),
                                    grad_outputs=_seed(mesh))
        out[name] = [_np(o)] + [_np(t) for t in
                                _parts_summed(mesh, list(grads))]
    return out


def vocab_cases(rank, device, cases, inputs):
    """The three ``sharded_vocab`` functions over a ``(1, m)`` mesh for
    each case ``(name, m, tied)`` on ``inputs[name]`` = (the table, the
    unembedding (the table itself when tied, else a (D, Vp) head),
    tokens, hidden, labels, the embedding's cotangent, the vocab): ->
    {name: [embedding, its table gradient, CE, its w and hidden
    gradients, decode logits]}."""
    out = {}
    for name, m, tied in cases:
        mesh = make_debug_mesh((1, m), DM)
        table, w, toks, hid, labels, g = (torch.from_numpy(a).to(device)
                                          for a in inputs[name][:6])
        vocab = int(inputs[name][6])
        table.requires_grad_()
        e = tvocab.embed_lookup(table, toks, "model", mesh)
        (ge,) = _parts_summed(mesh, list(torch.autograd.grad(
            (e * g).sum(), table, grad_outputs=_seed(mesh))))
        w, hid = w.requires_grad_(), hid.requires_grad_()
        ce = tvocab.chunked_lm_loss_sharded(hid, w, labels, vocab=vocab,
                                            tied=tied, model_axis="model",
                                            chunk=8, mesh=mesh)
        gw, gh = _parts_summed(mesh, list(torch.autograd.grad(
            ce, (w, hid), grad_outputs=_seed(mesh))))
        logits = tvocab.decode_logits(hid[:, :1].detach(), w.detach(),
                                      vocab=vocab, tied=tied,
                                      model_axis="model", mesh=mesh)
        out[name] = [_np(e), _np(ge), _np(ce), _np(gw), _np(gh),
                     _np(logits)]
    return out


def ep_cases(rank, device, cases, inputs):
    """``moe_block(impl="ep")`` of reduced deepseek-v2-lite-16b on a
    ``(data, model)`` mesh for each case ``(name, shape, capacity
    factor)`` on ``inputs[name]`` = (the block's params in the JAX
    package's leaf order, x, the output's cotangent): this rank's output
    rows, the load-balance loss, and the gradients of ``Σ y·g + aux``
    (each data rank's aux term taken at 1/D, its share of the one loss)
    summed over the mesh -> {name: [y, aux, x's gradient rows, the
    params' gradients]}."""
    out = {}
    for name, shape, cf in cases:
        mesh = make_debug_mesh(shape, DM)
        cfg = cfg_of("deepseek-v2-lite-16b")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        leaves, x, g = inputs[name]
        _, treedef = tree_flatten(tmoe.init_moe(
            torch.Generator().manual_seed(0), cfg, torch.float32))
        live = [torch.from_numpy(a).to(device).requires_grad_()
                for a in leaves]
        x = _rows(torch.from_numpy(x).to(device), mesh).requires_grad_()
        g = _rows(torch.from_numpy(g).to(device), mesh)
        y, aux = tmoe.moe_block(cfg, tree_unflatten(treedef, live), x,
                                impl="ep", mesh=mesh, dp_axes=("data",))
        loss = (y * g).sum() + aux / mesh.shape["data"]
        grads = list(torch.autograd.grad(loss, [x, *live],
                                         grad_outputs=_seed(mesh)))
        gx = _parts_summed(mesh, grads[:1])[0]
        gp = _parts_summed(mesh, grads[1:], DM)
        out[name] = [_np(y), float(aux), _np(gx), [_np(t) for t in gp]]
    return out


def trainer_rounds(rank, device, arch, shape, init, batches):
    """Two int8 rounds of ``FusedFLTrainer`` on ``shape`` from the JAX
    package's init leaves -> (params, numpy, and the history)."""
    cfg = cfg_of(arch)
    t = FusedFLTrainer(cfg, make_debug_mesh(shape, AXES),
                       AggregationConfig(compress="int8",
                                         num_microbatches=2), device=device)
    t.init(seed=0)
    leaves, treedef = tree_flatten(t.params)
    t.params = tree_unflatten(treedef, [torch.from_numpy(a).to(device)
                                        for a in init])
    for b in batches:
        t.train_round(b)
    return [_np(p) for p in tree_leaves(t.params)], t.history


def ragged_ssm_cfg(arch, d_model=63):
    """``arch`` reduced with a d_inner (``expand`` 1, d_model 63) that no
    even number of ranks splits."""
    cfg = cfg_of(arch)
    return dataclasses.replace(cfg, d_model=d_model, ssm=dataclasses.replace(
        cfg.ssm, expand=1))


def step_on(cfg, mesh, tokens=16, frames=None):
    """One round of ``cfg`` on ``mesh`` from seed-0 params on a batch of 4
    sequences of ``tokens`` (with ``frames`` stub rows for a frontend
    config)."""
    step, model = build_train_step(cfg, mesh,
                                   AggregationConfig(num_microbatches=2))
    params = model.init(0, device="cpu")
    toks = torch.zeros(4, tokens, dtype=torch.long)
    batch = {"tokens": toks, "labels": toks}
    if cfg.frontend:
        batch["frontend"] = torch.zeros(
            4, frames or cfg.frontend_tokens, cfg.d_model)
    step(params, init_server_state("fedavg", params), batch)


def refusals(rank, device):
    """What a model axis of 2 over ranks refuses, by name; -> {case: the
    error's text}: a d_inner that does not split (an SSM and a hybrid
    config), a decoder-only frontend's F + S rows, an encoder's frames,
    a ragged sequence and experts that do not split."""
    mesh = make_debug_mesh((1, 1, 2), AXES)
    x = torch.zeros(1, 5, 1, 1, 8)

    def ragged():
        flash_self_attention_sp(x, x[:, :, :, 0], x[:, :, :, 0], -1, True,
                                1.0, 8, "model", mesh)

    def experts():
        cfg = cfg_of("deepseek-v2-lite-16b")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=7))
        p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg,
                          torch.float32)
        tmoe.moe_block(cfg, p, torch.zeros(1, 4, cfg.d_model), impl="ep",
                       mesh=mesh)

    out = {}
    for case, make in {
            "ssm": lambda: step_on(ragged_ssm_cfg("falcon-mamba-7b"), mesh),
            "hybrid": lambda: step_on(ragged_ssm_cfg("hymba-1.5b"), mesh),
            "frontend": lambda: step_on(cfg_of("internvl2-26b"), mesh,
                                        tokens=15),
            "encoder": lambda: step_on(cfg_of("seamless-m4t-large-v2"), mesh,
                                       frames=5),
            "ragged": ragged, "experts": experts}.items():
        try:
            make()
        except (ValueError, NotImplementedError) as e:
            out[case] = f"{type(e).__name__}: {e}"
    return out


def run_plan(rank, device, plan):
    """Each part of ``plan`` in turn, in one process group; -> {part:
    result}."""
    torch.set_num_threads(1)
    parts = {"steps": step_cases, "flash": flash_cases,
             "vocab": vocab_cases, "ep": ep_cases}
    out = {k: fn(rank, device, *plan[k]) for k, fn in parts.items()
           if k in plan}
    if "trainer" in plan:
        out["trainer"] = trainer_rounds(rank, device, *plan["trainer"])
    if plan.get("refusals"):
        out["refusals"] = refusals(rank, device)
    return out


def two_rank_round_on_card(rank, device, arch, init, batch):
    """A (1,1,2) round of reduced fp32 ``arch`` on the card from ``init``,
    uncompressed and int8 -> {comp: {"params", "metrics", ...}}, the
    int8 round's with the quantize kernels' launches."""
    from repro_torch.kernels.quantize.quantize import DEQUANTIZE, QUANTIZE

    out = {}
    for comp in ("none", "int8"):
        n0 = (QUANTIZE.launches, DEQUANTIZE.launches)
        out[comp] = step_cases(rank, device, [
            ("card", arch, (1, 1, 2), "hierarchical", comp)],
            {arch: init}, {arch: batch})["card"]
        out[comp]["launches"] = (QUANTIZE.launches - n0[0],
                                 DEQUANTIZE.launches - n0[1])
    return out
