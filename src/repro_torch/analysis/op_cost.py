"""FLOPs, bytes and live memory of one rank's step, counted op by op:
the counterpart of the JAX package's ``analysis/hlo_cost.py``.

The JAX package rebuilds a compiled step's cost from its HLO text,
scaling each ``while`` body by its trip count.  The port's step is
eager: its layer loop is Python, so each layer's ops run (and are
counted) once a layer, a microbatch and, under remat, again in the
backward — the loop stands in for XLA's trip counts.  :func:`step_cost`
runs a step under one dispatch mode, :class:`OpCounter`, which counts

* FLOPs by ``torch.utils.flop_counter``'s per-op formulas (matmuls,
  convolutions, attention), as ``FlopCounterMode`` applies them;
* the bytes each aten op reads and writes (each tensor input once,
  each output once; views, aliases and empty allocations free).  An eager step does not fuse, so this is the
  traffic it makes.  It also tracks the bytes of every storage created
  in the step while it lives: their peak, and what is still alive when
  the step returns (its outputs).

Under ``FakeTensorMode`` (``launch/dryrun.py``) no op computes and no
storage is allocated, and the counts are those of the real step.
"""
from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
#: ops that touch no memory (``is_view`` ops are free too)
_FREE = {aten._unsafe_view.default, aten.empty.memory_format,
         aten.empty_strided.default, aten.empty_like.default,
         aten.new_empty.default, aten.new_empty_strided.default,
         aten.lift_fresh.default, aten.lift_fresh_copy.default}


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _op_tensors(args, kwargs) -> Iterable[torch.Tensor]:
    """The tensors of an aten op's arguments (a list argument one level
    deep, as aten schemas nest them)."""
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    yield b


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """FLOPs, bytes and counts of aten ops, and the live bytes of the
    storages they create (module docstring).  ``known``: tensors that exist
    before the step (its arguments), whose storages are not counted."""

    def __init__(self, known: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.flops = 0
        self.bytes_ = 0
        self.ops: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._live: Dict[int, int] = {}
        self._known = {_key(t) for t in known}
        self._funcs: Dict[Any, Any] = {}     # op -> (moves bytes, formula)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops[func] += 1
        info = self._funcs.get(func)
        if info is None:
            info = self._funcs[func] = (
                not (func.is_view or func in _FREE),
                flop_registry.get(func._overloadpacket))
        moves, formula = info
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = list(_op_tensors(out if isinstance(out, (list, tuple))
                                else (out,), {}))
        if moves:
            self.bytes_ += sum(_nbytes(t) for t in _op_tensors(args, kwargs))
            self.bytes_ += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._live or key in self._known:
            return
        n = storage.nbytes()
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def created_bytes(self, tree) -> int:
        """The bytes of the distinct storages of ``tree`` made in the
        step (an output that is an argument's view counts nothing)."""
        keys = {_key(t) for t in _tensors(tree)}
        return sum(self._live.get(k, 0) for k in keys)


@dataclass
class OpCost:
    """A rank's step, counted: FLOPs, bytes read and written, the peak of
    the bytes the step allocated, those its outputs hold, and the calls
    of each aten op."""

    flops: float
    bytes_: float
    peak_bytes: int
    output_bytes: int
    ops: Dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes_,
                "peak_bytes": self.peak_bytes,
                "output_bytes": self.output_bytes,
                "aten_ops": sum(self.ops.values())}


def step_cost(fn, *args):
    """-> (``fn(*args)``, its :class:`OpCost`)."""
    with OpCounter(known=_tensors(args)) as counter:
        out = fn(*args)
    ops: Dict[str, int] = Counter()
    for func, n in counter.ops.items():
        ops[str(func.overloadpacket)] += n
    return out, OpCost(float(counter.flops), float(counter.bytes_),
                       counter.peak, counter.created_bytes(out), dict(ops))


def op_count(cost: OpCost, opname: str) -> int:
    """Calls of one aten op (``"aten.mm"``) in a counted step."""
    return cost.ops.get(opname, 0)
