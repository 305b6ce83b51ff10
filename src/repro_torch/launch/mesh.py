"""A logical mesh of named axes on one device: the JAX package's
``launch/mesh.py`` (``make_debug_mesh``, ``make_host_mesh``, ``dp_axes``,
``pod_axis``) without the devices.

Mesh axes, as in the JAX package:
  pod   — LIFL's inter-node tier (the top aggregator level)
  data  — client cohorts / FSDP, the intra-node tier
  model — tensor / sequence parallelism

The port runs on one card.  A ``pod`` axis of any size is run there pod
after pod by the fused round (``fl/round.py``); a ``data`` or ``model``
axis above 1 would shard the model across cards and is refused
(ROADMAP A.8).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

#: axes whose size above 1 would need more than one card
_SHARDED_AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes (``mesh.shape[name]``, as a JAX mesh)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        for name, size in zip(self.axis_names, self.sizes):
            if size < 1:
                raise ValueError(f"axis {name!r} of size {size}")
            if name in _SHARDED_AXES and size > 1:
                raise NotImplementedError(
                    f"a {name!r} axis of size {size} shards the model "
                    "across cards, which is not ported yet (ROADMAP A.8)")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_debug_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def make_host_mesh() -> Mesh:
    """1x1 (data, model) mesh on the one device."""
    return Mesh(("data", "model"), (1, 1))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes client cohorts / batch are sharded over."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def pod_axis(mesh: Mesh) -> Optional[str]:
    return "pod" if "pod" in mesh.axis_names else None


def require_one_device(mesh: Optional[Mesh], axis: str, what: str) -> None:
    """Refuse, naming ``what``, a model computation over a named axis
    that the one card cannot run: without a mesh the axis cannot be
    resolved (in the JAX package it names an axis of the ambient mesh),
    and above size 1 it shards across cards (ROADMAP A.8).  A size-1
    axis is the unsharded computation."""
    if mesh is None or mesh.shape.get(axis, 1) > 1:
        raise NotImplementedError(
            f"{what}: a computation sharded over the {axis!r} mesh axis "
            "is not ported yet (ROADMAP A.8); pass ModelOptions(mesh=...) "
            f"with a {axis!r} axis of size 1")
