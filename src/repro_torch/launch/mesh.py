"""A logical mesh of named axes: the JAX package's ``launch/mesh.py``
(``make_production_mesh``, ``make_debug_mesh``, ``make_host_mesh``,
``mesh_axes``, ``dp_axes``, ``pod_axis``) without the devices.
``make_production_mesh`` and :func:`stand_in_mesh` give one rank's view
of a mesh whose ranks are not started (the dry run's,
``launch/dryrun.py``).

Mesh axes, as in the JAX package:
  pod   — LIFL's inter-node tier (the top aggregator level)
  data  — client cohorts / FSDP, the intra-node tier
  model — tensor / sequence parallelism

A mesh lives in one process or across ranks.  In one process a ``pod``
axis of any size is run there pod after pod by the fused round
(``fl/round.py``), and a ``data`` axis above 1 is refused.  Under an
initialised process group whose world size is the mesh's size
(``launch/dist.py``), :func:`make_debug_mesh` gives each rank one
coordinate, row-major over the axes, and one process group for each
set of axes: the ranks that differ only on those axes.  The pod tier's
collectives run over the pod group, the data tier's over the data
group (with the model group folded in, ``fl/round.py``), and the
model's own regions over the model group (``launch/dist.py``'s
differentiable collectives): context-parallel flash (an encoder's
non-causal layers and a frontend's patches in front of the text too),
the vocab-sharded embedding and loss, expert-parallel MoE and the SSM
scan's d_inner.  In one process a ``model`` axis above 1 is refused;
across ranks a shape that does not split over the model axis is
refused by its region, by name.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from math import prod
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

from repro_torch.launch.dist import Wire


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes (``mesh.shape[name]``, as a JAX mesh).  A
    mesh over ranks also holds this rank's coordinate on each axis
    (``coords``), a process group for each axis and for the batch axes
    together (``groups``; None for an axis of one rank) and the
    :class:`~repro_torch.launch.dist.Wire` its collectives go through."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...] = ()
    groups: Dict[Tuple[str, ...], Any] = field(default_factory=dict,
                                               compare=False, repr=False)
    wire: Any = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        for name, size in zip(self.axis_names, self.sizes):
            if size < 1:
                raise ValueError(f"axis {name!r} of size {size}")
        size = self.shape.get("model", 1)
        if size > 1 and not self.coords:
            raise ValueError(
                f"a 'model' axis of size {size} shards the model across "
                "ranks, one process a mesh coordinate: build the mesh with "
                "make_debug_mesh in ranks started by "
                "launch.dist.spawn_ranks")
        size = self.shape.get("data", 1)
        if size > 1 and not self.coords:
            raise NotImplementedError(
                f"a 'data' axis of size {size} runs one process a mesh "
                "coordinate: build the mesh with make_debug_mesh in ranks "
                "started by launch.dist.spawn_ranks (ROADMAP A.8)")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def distributed(self) -> bool:
        """Whether this mesh spans ranks (one process a coordinate)."""
        return bool(self.coords)

    @property
    def rank(self) -> int:
        """This process's rank (0 in one process)."""
        return rank_of(self.sizes, self.coords) if self.coords else 0

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 in one process or on an
        axis the mesh lacks)."""
        if not self.coords or axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, *axes: str):
        """The process group of the ranks that differ only on ``axes``
        (None when that is this rank alone)."""
        return self.groups.get(tuple(a for a in self.axis_names
                                     if a in axes))

    def rank_at(self, **coords: int) -> int:
        """The global rank at this rank's coordinate with ``coords``
        changed (each taken modulo its axis)."""
        at = [coords.get(a, c) % s for a, c, s in
              zip(self.axis_names, self.coords, self.sizes)]
        return rank_of(self.sizes, at)


def rank_of(sizes, coords) -> int:
    """Row-major rank of ``coords`` in a mesh of ``sizes``."""
    r = 0
    for s, c in zip(sizes, coords):
        r = r * s + c
    return r


def _coords(sizes: Tuple[int, ...], rank: int) -> Tuple[int, ...]:
    """Row-major coordinates of ``rank`` in a mesh of ``sizes``."""
    coords = []
    for s in reversed(sizes):
        coords.append(rank % s)
        rank //= s
    return tuple(reversed(coords))


def _groups(axes: Tuple[str, ...], sizes: Tuple[int, ...]):
    """Every process group of a mesh, in one order: ``(span, members)``
    for each set of axes (an axis alone, the batch axes together, the
    data and model axes together, ...) of more than one rank and each
    coordinate off it; members by global rank."""
    spans = [span for n in range(1, len(axes) + 1)
             for span in itertools.combinations(axes, n)]
    for span in spans:
        along = [i for i, a in enumerate(axes) if a in span]
        if prod(sizes[i] for i in along) == 1:
            continue
        rest = [range(s) if i not in along else [None]
                for i, s in enumerate(sizes)]
        for fixed in itertools.product(*rest):
            members = []
            for moving in itertools.product(*(range(sizes[i])
                                              for i in along)):
                c = list(fixed)
                for i, v in zip(along, moving):
                    c[i] = v
                members.append(rank_of(sizes, c))
            yield span, members


def _rank_mesh(axes: Tuple[str, ...], sizes: Tuple[int, ...],
               rank: int) -> Mesh:
    """This rank's coordinate and one process group for each set of axes.
    Every rank creates every group, in the same order, as
    ``torch.distributed.new_group`` requires."""
    groups = {}
    for span, members in _groups(axes, sizes):
        g = dist.new_group(members)
        if rank in members:
            groups[span] = g
    return Mesh(axes, sizes, _coords(sizes, rank), groups, Wire())


def stand_in_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                  rank: int = 0) -> Mesh:
    """``rank``'s place in a mesh of ``shape`` whose ranks are not started:
    its coordinates, a stand-in for each of its process groups
    (``analysis/collectives.py::StandInGroup``, the members a real
    group would hold, None where a real mesh's group is None) and a
    recording wire that counts each collective and moves nothing.  A
    step built on it runs one rank's work (under fake tensors: the dry
    run, ``launch/dryrun.py``)."""
    from repro_torch.analysis.collectives import RecordingWire, StandInGroup

    axes, sizes = tuple(axes), tuple(int(s) for s in shape)
    if not 0 <= rank < prod(sizes):
        raise ValueError(f"rank {rank} of a mesh of {prod(sizes)} ranks")
    groups = {span: StandInGroup(span, tuple(members))
              for span, members in _groups(axes, sizes)
              if rank in members}
    return Mesh(axes, sizes, _coords(sizes, rank), groups, RecordingWire())


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """The JAX package's production meshes, (16, 16) over (data, model) or
    (2, 16, 16) over (pod, data, model), as ``rank`` of them sees them
    (:func:`stand_in_mesh`): what the dry run traces."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return stand_in_mesh(shape, axes, rank)


def make_debug_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over ``axes``: across ranks under an
    initialised process group of more than one rank, whose world size
    must then be the mesh's size; in one process otherwise."""
    axes, sizes = tuple(axes), tuple(int(s) for s in shape)
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return Mesh(axes, sizes)
    Mesh(axes, sizes, coords=(0,) * len(sizes))     # the axes' own checks
    world = dist.get_world_size()
    if world != prod(sizes):
        raise ValueError(f"a mesh {dict(zip(axes, sizes))} of {prod(sizes)} "
                         f"coordinates under a process group of {world} "
                         "ranks: one rank a coordinate")
    return _rank_mesh(axes, sizes, dist.get_rank())


def make_host_mesh() -> Mesh:
    """1x1 (data, model) mesh on the one device."""
    return Mesh(("data", "model"), (1, 1))


def mesh_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes client cohorts / batch are sharded over."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def pod_axis(mesh: Mesh) -> Optional[str]:
    return "pod" if "pod" in mesh.axis_names else None


def model_shards(mesh: Optional[Mesh], axis: str, what: str) -> int:
    """The size of the named ``axis`` that ``what`` is sharded over.  A
    named axis without a mesh cannot be resolved (in the JAX package it
    names an axis of the ambient mesh) and is refused; above size 1 the
    mesh must span ranks (one process refuses it when it is built)."""
    if mesh is None:
        raise NotImplementedError(
            f"{what}: a computation over the {axis!r} mesh axis needs the "
            f"mesh that names it (ROADMAP A.8); pass ModelOptions(mesh=...)")
    return mesh.shape.get(axis, 1)
