"""One process per mesh coordinate: the ranks of the fused round.

The JAX package is single-controller: one program sees every device of
the mesh, and its collectives (``psum``, ``pmean``, ``ppermute``) are
compiled into the step.  The port runs one process a coordinate of a
``(pod, data, model)`` mesh, joined in a ``torch.distributed`` process
group, and its collectives are calls in the step
(``fl/compression.py``, ``fl/round.py``).

:func:`spawn_ranks` starts the ranks (the ``spawn`` start method,
rendezvous through a file in a temporary directory, so no port is
picked) and returns what each rank's function returned.  The backend is
gloo, bound to the loopback interface: the ranks share one host, and on
one card NCCL refuses two ranks on the same GPU.  gloo moves host
tensors only (its point-to-point takes nothing else), so every tensor
that crosses between ranks goes through :class:`Wire`, which stages a
tensor on the card through pinned host buffers, as a pod hop over the
data-centre network would.

The model axis's collectives run inside the model's forward and
backward: :func:`all_gather`, :func:`psum`, :func:`pmax` and
:func:`ppermute` over one axis of a mesh over ranks, each a
``torch.autograd.Function`` whose backward is its JAX transpose.  The
rank's computation outside these regions is replicated over the model
axis (every rank of a model group computes the same values), and its
gradient is a *part*: the model group's parts sum to the one-device
gradient.  The fused round seeds the loss's cotangent on the group's
first rank only and sums the parts with the data tier's all-reduce
(``fl/round.py``).  With parts flowing backward, a replicated input
entering a region needs no collective (its cotangent stays this rank's
part), and the adjoints are:

* ``all_gather`` -> the sum of the cotangent over the group, this
  rank's slice of it (a reduce-scatter);
* ``psum`` -> the sum of the cotangent over the group;
* ``ppermute`` by +s -> the cotangent sent back by -s;
* ``pmax`` takes no gradient (it is only a softmax's shift).

Sums run in fp32, as the JAX package's regions cast before their
collectives (gloo has no bf16 sum); a 16-bit tensor that is only moved
crosses as its bytes.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

BACKEND = "gloo"
#: the largest piece of a tensor staged and sent at once: it bounds the
#: pinned host buffers of a rank on the card
STAGE_BYTES = 1 << 27


def _rank_device(device: Any, rank: int, world: int) -> torch.device:
    """A rank's device: the card unless ``device`` names another (on one
    card every rank is ``cuda:0``; on several, rank r takes card r mod
    the count).  A rank without a card and without ``device="cpu"``
    raises, as every entry point of the port does.  The ranks share the
    host's cores: a rank on the CPU takes one thread, a rank on the card
    its share of the cores."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        torch.set_num_threads(1)
    return dev


def _rank_main(fn: Callable, rank: int, world: int, init_method: str,
               device: Any, args: Tuple, out_dir: str,
               timeout_s: float) -> None:
    out = Path(out_dir)
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dev = _rank_device(device, rank, world)
        dist.init_process_group(BACKEND, init_method=init_method,
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        try:
            result = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        with open(out / f"result-{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (out / f"error-{rank}.txt").write_text(traceback.format_exc())
        raise


def spawn_ranks(fn: Callable, world: int, *args: Any, device: Any = None,
                timeout_s: float = 900.0) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in ``world`` new processes joined
    in one gloo process group; -> each rank's return value, by rank.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and the
    return values come back pickled, so a rank returns host data.  A
    rank that raises, dies, or outlives ``timeout_s`` fails the call:
    the other ranks are ended and the failing rank's traceback is in the
    ``RuntimeError``.  Every process started here is ended before it
    returns."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="lifl-ranks-") as tmp:
        init_method = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init_method, device, args,
                                   tmp, timeout_s),
                             name=f"lifl-rank-{r}")
                 for r in range(world)]
        for p in procs:
            p.start()
        failed: Optional[int] = None
        deadline = time.monotonic() + timeout_s
        try:
            while failed is None and any(p.is_alive() for p in procs):
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0):
                        failed = r
                        break
                else:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world} ranks still running after "
                            f"{timeout_s} s")
                    time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode != 0), None)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        if failed is not None:
            # a rank's failure breaks its peers' collectives: report each
            # rank that left a traceback, the first to fail among them
            why = [f"--- rank {r} ---\n{err.read_text()}"
                   for r in range(world)
                   if (err := Path(tmp) / f"error-{r}.txt").exists()]
            raise RuntimeError(
                f"rank {failed} of {world} failed (exit code "
                f"{procs[failed].exitcode}):\n" + "\n".join(why))
        results = []
        for r in range(world):
            with open(Path(tmp) / f"result-{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results


def _words(t: torch.Tensor) -> torch.Tensor:
    """A flat 16-bit float tensor as its bytes (gloo moves no bf16 and
    no int16); any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype in (torch.bfloat16,
                                              torch.float16) else t


def _pieces(flat: torch.Tensor) -> List[torch.Tensor]:
    step = max(1, STAGE_BYTES // flat.element_size())
    return [flat[i:i + step] for i in range(0, flat.numel(), step)]


class Wire:
    """Every tensor that crosses between ranks goes through here.

    A CPU tensor goes to gloo as it is.  A tensor on the card is staged
    piece by piece (``STAGE_BYTES``) through pinned host buffers, which
    are kept and reused from call to call.  ``IN_FLIGHT`` pieces are on
    the wire at once, so one piece's copies overlap another's transfer.
    ``stats`` holds, by kind of traffic, the calls, the bytes this rank
    sent and the seconds spent, staging included."""

    IN_FLIGHT = 2

    def __init__(self):
        self.stats: Dict[str, Dict[str, float]] = {}
        self._host: Dict[Tuple[int, torch.dtype], torch.Tensor] = {}

    def _staging(self, slot: int, like: torch.Tensor,
                 numel: Optional[int] = None) -> torch.Tensor:
        """Pinned host slot ``slot`` of ``like``'s dtype, ``numel`` long
        (default ``like``'s)."""
        numel = like.numel() if numel is None else numel
        buf = self._host.get((slot, like.dtype))
        if buf is None or buf.numel() < numel:
            buf = torch.empty(numel, dtype=like.dtype, pin_memory=True)
            self._host[(slot, like.dtype)] = buf
        return buf[:numel]

    def _count(self, kind: str, nbytes: int, t0: float) -> None:
        s = self.stats.setdefault(kind, {"calls": 0, "bytes": 0,
                                         "seconds": 0.0})
        s["calls"] += 1
        s["bytes"] += nbytes
        s["seconds"] += time.perf_counter() - t0

    @staticmethod
    def _land(works, host: torch.Tensor, piece: torch.Tensor) -> None:
        for work in works:
            work.wait()
        if host is not piece:
            piece.copy_(host)

    def all_reduce(self, tensors: Sequence[torch.Tensor], group,
                   kind: str, op=dist.ReduceOp.SUM) -> None:
        """Reduce each (contiguous) tensor in place over ``group``'s
        ranks, by sum unless ``op`` says otherwise; ``group`` None is an
        axis of one rank, where the result is the tensor itself."""
        if group is None:
            return
        t0, nbytes, flying = time.perf_counter(), 0, []
        pieces = [p for t in tensors for p in _pieces(t.view(-1))]
        for i, piece in enumerate(pieces):
            nbytes += piece.numel() * piece.element_size()
            if len(flying) == self.IN_FLIGHT:
                self._land(*flying.pop(0))
            host = piece
            if piece.is_cuda:
                host = self._staging(i % self.IN_FLIGHT, piece)
                host.copy_(piece)
            flying.append(([dist.all_reduce(host, op=op, group=group,
                                            async_op=True)], host, piece))
        for f in flying:
            self._land(*f)
        self._count(kind, nbytes, t0)

    def all_gather(self, tensor: torch.Tensor, group,
                   kind: str) -> torch.Tensor:
        """-> (n, *tensor.shape): every rank's ``tensor`` of ``group``,
        by the rank's place in the group; a 16-bit float crosses as its
        bytes."""
        t0 = time.perf_counter()
        n = dist.get_world_size(group)
        flat = _words(tensor.contiguous().view(-1))
        host, out = flat, torch.empty((n, flat.numel()), dtype=flat.dtype)
        if flat.is_cuda:
            host = self._staging(0, flat)
            host.copy_(flat)
            out = self._staging(1, flat, n * flat.numel()).view(n, -1)
        dist.all_gather(list(out.unbind(0)), host, group=group)
        if flat.is_cuda:        # off the reused slot
            out = out.to(tensor.device)
        self._count(kind, flat.numel() * flat.element_size(), t0)
        return out.view(tensor.dtype).reshape(n, *tensor.shape)

    def exchange(self, send: Sequence[torch.Tensor],
                 recv: Sequence[torch.Tensor], dst: int, src: int, group,
                 kind: str) -> None:
        """Send each tensor of ``send`` to global rank ``dst`` while
        receiving into the same-shaped tensor of ``recv`` from ``src``:
        each send is paired with its receive, so a ring of these calls
        cannot deadlock, as one where every rank sends first would.  Each
        piece has its own tag."""
        t0, nbytes, flying = time.perf_counter(), 0, []
        pairs = [(ps, pr) for s, r in zip(send, recv)
                 for ps, pr in zip(_pieces(_words(s.reshape(-1))),
                                   _pieces(_words(r.view(-1))))]
        for tag, (ps, pr) in enumerate(pairs):
            nbytes += ps.numel() * ps.element_size()
            if len(flying) == self.IN_FLIGHT:
                self._land(*flying.pop(0))
            hs, hr = ps, pr
            if ps.is_cuda:
                slot = 2 * (tag % self.IN_FLIGHT)
                hs, hr = self._staging(slot, ps), self._staging(slot + 1, pr)
                hs.copy_(ps)
            flying.append((dist.batch_isend_irecv([
                dist.P2POp(dist.isend, hs, dst, group, tag),
                dist.P2POp(dist.irecv, hr, src, group, tag)]), hr, pr))
        for f in flying:
            self._land(*f)
        self._count(kind, nbytes, t0)


# ---------------------------------------------------------------------------
# collectives over one mesh axis, differentiable (module docstring)
# ---------------------------------------------------------------------------


def _axes(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _sum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The fp32 sum of ``x`` over the group of ``axis`` (a name or a
    tuple of names), a new tensor."""
    y = x.float().contiguous().clone()
    mesh.wire.all_reduce([y], mesh.group(*_axes(axis)),
                         "_".join(_axes(axis)) + "_psum")
    return y


def group_place(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """-> (the ranks of the group of ``axes``, this rank's place among
    them): row-major over the axes in the mesh's order, the order of
    the group's ranks."""
    n, at = 1, 0
    for a in mesh.axis_names:
        if a in axes:
            n, at = n * mesh.shape[a], at * mesh.shape[a] + mesh.coord(a)
    return n, at


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.meta = (mesh, axis, dim)
        axes = _axes(axis)
        parts = mesh.wire.all_gather(x, mesh.group(*axes),
                                     "_".join(axes) + "_all_gather")
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.meta
        n, at = group_place(mesh, _axes(axis))
        k = g.shape[dim] // n
        mine = _sum(g, mesh, axis).narrow(dim, at * k, k)
        return mine.to(g.dtype), None, None, None


class _Psum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.meta = (mesh, axis)
        return _sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.meta
        return _sum(g, mesh, axis), None, None


class _PPermute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.meta = (mesh, axis, shift)
        return _shifted(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.meta
        return _shifted(g, mesh, axis, -shift), None, None, None


def _shifted(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    me = mesh.coord(axis)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    mesh.wire.exchange([x.contiguous()], [out],
                       mesh.rank_at(**{axis: me + shift}),
                       mesh.rank_at(**{axis: me - shift}),
                       mesh.group(axis), f"{axis}_ppermute")
    return out


def all_gather(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of the group of ``axis`` (a name, or a tuple of
    names in the mesh's order), concatenated along ``dim`` in the
    group's order, row-major over the axes
    (``jax.lax.all_gather(tiled=True)``).  The adjoint casts the fp32
    sum of the cotangent back to its dtype, so a 16-bit leaf gathered
    over the batch axes takes its gradient summed over them, rounded
    once (``sharding/rules.py``)."""
    return _AllGather.apply(x, mesh, axis, dim)


def psum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The sum of ``x`` over the group of ``axis`` (a name, or a tuple of
    names for the ranks that differ on those axes), in fp32."""
    return _Psum.apply(x, mesh, axis)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The max of ``x`` over ``axis``'s group, without a gradient
    (``stop_gradient(pmax(...))``)."""
    y = x.detach().float().contiguous().clone()
    mesh.wire.all_reduce([y], mesh.group(axis), f"{axis}_pmax",
                         op=dist.ReduceOp.MAX)
    return y


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    """``x`` sent to the rank ``shift`` places on along ``axis`` (taken
    modulo its size), the ring's ``jax.lax.ppermute``: -> what the rank
    ``shift`` places back sent."""
    return _PPermute.apply(x, mesh, axis, shift)
