"""Collective traffic of one rank's step, recorded where it is sent: the
counterpart of the JAX package's ``analysis/hlo.py``.

The JAX package parses the collectives out of the compiled HLO.  The
port's collectives are calls through its mesh's wire
(``launch/dist.py::Wire``), so a mesh of ranks that are not started
(``launch/mesh.py::stand_in_mesh``) carries a :class:`RecordingWire`:
it has ``Wire``'s three calls, counts each as ``Wire._count`` does
(the same kinds, the bytes this rank sends), returns tensors of the
right shapes and moves nothing.  Its groups are :class:`StandInGroup`
s: the ranks a real mesh's process group would hold.

:func:`recorded_stats` sums the records into :class:`CollectiveStats`:
calls and bytes by kind and by the axes a group spans, the total, the
part whose group crosses pods (the JAX package's DCN bytes), and the
part whose group leaves one node of ``NODE_RANKS`` consecutive ranks
(``analysis/roofline.py`` charges it at the NIC rate, the rest at the
NVLink rate).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch

#: ranks of one node: an HGX H100 board holds 8 cards joined by NVLink
NODE_RANKS = 8


@dataclass(frozen=True)
class StandInGroup:
    """The ranks of one process group of a mesh that is not started:
    the axes it spans and its members' global ranks, in order."""

    axes: Tuple[str, ...]
    members: Tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def crosses_pods(self) -> bool:
        return "pod" in self.axes

    @property
    def leaves_node(self) -> bool:
        return len({r // NODE_RANKS for r in self.members}) > 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RecordingWire:
    """``Wire``'s calls, counted and not sent: ``stats`` as ``Wire.stats``
    (calls and bytes a kind; no seconds pass), ``records`` one
    ``(kind, group, bytes)`` a call."""

    def __init__(self):
        self.stats: Dict[str, Dict[str, float]] = {}
        self.records: List[Tuple[str, StandInGroup, int]] = []

    def _count(self, kind: str, nbytes: int, group) -> None:
        s = self.stats.setdefault(kind, {"calls": 0, "bytes": 0,
                                         "seconds": 0.0})
        s["calls"] += 1
        s["bytes"] += nbytes
        self.records.append((kind, group, nbytes))

    def all_reduce(self, tensors: Sequence[torch.Tensor], group,
                   kind: str, op=None) -> None:
        """Counted as ``Wire.all_reduce``; the tensors keep their values
        (under fake tensors they have none)."""
        if group is None:
            return
        self._count(kind, sum(_nbytes(t) for t in tensors), group)

    def all_gather(self, tensor: torch.Tensor, group,
                   kind: str) -> torch.Tensor:
        """-> an empty (n, *tensor.shape) like ``Wire.all_gather``'s."""
        self._count(kind, _nbytes(tensor), group)
        return tensor.new_empty((group.size, *tensor.shape))

    def exchange(self, send: Sequence[torch.Tensor],
                 recv: Sequence[torch.Tensor], dst: int, src: int, group,
                 kind: str) -> None:
        """Counted as ``Wire.exchange``; ``recv`` is left as it is."""
        self._count(kind, sum(_nbytes(t) for t in send), group)


@dataclass
class CollectiveStats:
    by_kind: Dict[str, int] = field(default_factory=dict)
    by_kind_count: Dict[str, int] = field(default_factory=dict)
    by_axes: Dict[str, int] = field(default_factory=dict)
    nvlink_bytes: int = 0
    nic_bytes: int = 0
    dcn_bytes: int = 0
    total_bytes: int = 0

    def to_dict(self):
        return {
            "by_kind": self.by_kind,
            "by_kind_count": self.by_kind_count,
            "by_axes": self.by_axes,
            "nvlink_bytes": self.nvlink_bytes,
            "nic_bytes": self.nic_bytes,
            "dcn_bytes": self.dcn_bytes,
            "total_bytes": self.total_bytes,
        }


def recorded_stats(wire: RecordingWire) -> CollectiveStats:
    """The records of ``wire`` summed by kind, by axes and by tier."""
    stats = CollectiveStats()
    for kind, group, nbytes in wire.records:
        axes = ",".join(group.axes)
        stats.by_kind[kind] = stats.by_kind.get(kind, 0) + nbytes
        stats.by_kind_count[kind] = stats.by_kind_count.get(kind, 0) + 1
        stats.by_axes[axes] = stats.by_axes.get(axes, 0) + nbytes
        stats.total_bytes += nbytes
        if group.crosses_pods:
            stats.dcn_bytes += nbytes
        if group.crosses_pods or group.leaves_node:
            stats.nic_bytes += nbytes
        else:
            stats.nvlink_bytes += nbytes
    return stats
