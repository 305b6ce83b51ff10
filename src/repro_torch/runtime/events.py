"""Typed round events — the one protocol every runtime speaks.

LIFL's control plane is *event-driven*: aggregation progress, scaling,
routing and failure handling are all reactions to events, not calls
into each other.  This module is that protocol, reified: every
state transition that crosses a component boundary (runtime → driver,
driver → handlers, operator → driver) is one of the frozen dataclasses
below, and nothing else.

Design rules:

  * **Immutable** — events are facts about the past; handlers never
    mutate them (``frozen=True``).
  * **Round-scoped or not** — ``round_id`` is ``None`` for events that
    exist outside a round (node churn); the driver's ordering guards
    only apply to round-scoped events (stale-round drops, deadline
    after goal).
  * **Wire-serializable** — ``to_wire``/``from_wire`` round-trip every
    event type through JSON, so the same protocol can later ride the
    multi-node gateway TX path unchanged.

Catalog (see runtime/README.md for the full state machine):

  ``UpdateArrived``   a client/gateway update was delivered to a mid
  ``PartialReady``    a subtree published its partial sum (key in store)
  ``PartialShipped``  a sealed partial moved daemon→daemon to the root
  ``TopFolded``       the round's root fold completed (plan's root site)
  ``GoalReached``     the round's aggregation goal n was met
  ``WorkerCrashed``   an aggregator worker died mid-task (shmproc)
  ``NodeJoined``      a worker node joined the cluster
  ``NodeLost``        a worker node left / was lost
  ``NodeRejoined``    a restarted daemon was re-adopted (epoch bump)
  ``RoundDeadline``   the round's wall-clock budget expired
  ``ScaleDecision``   the elastic controller re-sized the hierarchy
  ``RoundOpened``     a (possibly rolling) round started accepting work
  ``UpdateShed``      the ingress gateway refused an update (backpressure)
  ``SLOBreached``     a job's SLO was violated on sustained live scrapes
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Dict, Optional, Type


@dataclass(frozen=True)
class RoundEvent:
    """Base class: every event may carry the round it belongs to.

    ``round_id=None`` marks an event that is not scoped to a round
    (node churn, scale decisions between rounds); the driver's
    stale-round guard ignores those."""

    round_id: Optional[int] = None


@dataclass(frozen=True)
class UpdateArrived(RoundEvent):
    """One model update landed at its middle aggregator (Recv step)."""

    client_id: str = ""
    node: str = ""
    agg_id: str = ""
    key: str = ""          # 16-byte object-store key (payload stays put)
    weight: float = 0.0    # c_i^k — the FedAvg weight


@dataclass(frozen=True)
class PartialReady(RoundEvent):
    """A subtree published its raw partial sum Σ c·u into the store."""

    agg_id: str = ""
    key: str = ""
    weight: float = 0.0    # Σ c over the subtree
    count: int = 0         # updates folded into this partial
    exec_s: float = 0.0    # aggregation execution time E_{i,t}
    worker: int = -1       # worker index (-1: in-process)


@dataclass(frozen=True)
class PartialShipped(RoundEvent):
    """A sealed partial Σ c·u was shipped daemon→daemon to the round's
    root node (node-top topology) instead of returning to the
    controller — the wire cost this event carries is exactly what the
    locality root choice minimizes."""

    agg_id: str = ""       # the root fold the partial feeds
    key: str = ""
    src: str = ""          # shipping node
    dst: str = ""          # root node
    nbytes: int = 0
    wire_s: float = 0.0    # measured serialize+send wall on the src daemon


@dataclass(frozen=True)
class TopFolded(RoundEvent):
    """The round's root fold completed at the plan's root site."""

    agg_id: str = ""
    node: str = ""         # where the root fold ran
    tier: str = ""         # 'controller' | 'worker' | 'node'
    count: int = 0         # updates folded end-to-end
    weight: float = 0.0    # Σ c over the round
    exec_s: float = 0.0    # measured root fold exec — feeds the RC model


@dataclass(frozen=True)
class GoalReached(RoundEvent):
    """The aggregation goal n (Eq. 1) was met; stragglers are ignored."""

    goal: int = 0
    accepted: int = 0


@dataclass(frozen=True)
class WorkerCrashed(RoundEvent):
    """An aggregator worker process died mid-task; its unpublished
    folds are lost but the dispatched update objects survive in the
    store (the driver re-dispatches them — see RoundDriver)."""

    agg_id: str = ""
    worker: int = -1
    exitcode: Optional[int] = None


@dataclass(frozen=True)
class NodeJoined(RoundEvent):
    node: str = ""
    capacity: float = 0.0


@dataclass(frozen=True)
class NodeLost(RoundEvent):
    node: str = ""


@dataclass(frozen=True)
class NodeRejoined(RoundEvent):
    """A daemon restarted under its old node name was re-adopted: the
    welcome handshake's epoch counter bumped, the dead epoch's
    residency/partial bookkeeping is gone, and the node is placeable
    again (the coordinator re-enters it into the RC capacity model)."""

    node: str = ""
    epoch: int = 0         # the NEW epoch (the daemon's start stamp)
    old_epoch: int = 0     # what the controller had recorded
    capacity: float = 0.0


@dataclass(frozen=True)
class RoundDeadline(RoundEvent):
    """The round's wall-clock budget expired.  Fired at most once per
    round, and ignored if the goal was already reached."""

    deadline_s: float = 0.0


@dataclass(frozen=True)
class RoundOpened(RoundEvent):
    """A round began accepting dispatches.  Under the rolling-round
    scheduler this fires while the previous round's fold is still in
    flight — the overlap window between consecutive ``RoundOpened`` /
    ``TopFolded`` pairs is the pipeline gain the serve layer measures."""

    job: str = ""          # '' = the single-job (library) path
    goal: int = 0


@dataclass(frozen=True)
class UpdateShed(RoundEvent):
    """The ingress gateway refused a submission: the job's quota (or
    the global ingress budget) was full.  Never a silent drop — the
    pusher got a ``busy`` reply carrying ``retry_after_s`` and is
    expected to come back."""

    job: str = ""
    client_id: str = ""
    retry_after_s: float = 0.0
    queued: int = 0        # queue depth at refusal (the pressure signal)


@dataclass(frozen=True)
class ScaleDecision(RoundEvent):
    """The elastic controller re-planned the hierarchy for the load."""

    aggregators_planned: int = 0
    nodes: int = 0
    levels: int = 0
    direction: str = "hold"   # 'up' | 'down' | 'hold'


@dataclass(frozen=True)
class SLOBreached(RoundEvent):
    """A job's service-level objective was violated on *sustained*
    live scrapes (FleetMonitor → SLOTracker): the measured p99 TTA or
    shed fraction exceeded its target for ``window`` consecutive
    scrapes.  Not round-scoped (``round_id=None``): the breach is a
    property of the service, and fires at most once per sustained
    episode."""

    job: str = ""
    metric: str = ""       # 'p99_tta_s' | 'shed_frac'
    measured: float = 0.0
    target: float = 0.0
    window: int = 0        # consecutive violating scrapes


#: name → class registry; the wire codec and tests iterate this.
EVENT_TYPES: Dict[str, Type[RoundEvent]] = {
    cls.__name__: cls
    for cls in (
        UpdateArrived, PartialReady, PartialShipped, TopFolded,
        GoalReached, WorkerCrashed, NodeJoined, NodeLost, NodeRejoined,
        RoundDeadline, RoundOpened, UpdateShed, ScaleDecision,
        SLOBreached,
    )
}


def to_wire(event: RoundEvent) -> bytes:
    """Serialize an event for a process/network boundary (JSON)."""
    name = type(event).__name__
    if name not in EVENT_TYPES:
        raise TypeError(f"not a wire-registered event type: {name}")
    return json.dumps({"event": name, **asdict(event)},
                      separators=(",", ":")).encode("utf-8")


def from_wire(raw) -> RoundEvent:
    """Inverse of :func:`to_wire`; accepts bytes or str."""
    if isinstance(raw, (bytes, bytearray)):
        raw = raw.decode("utf-8")
    d = json.loads(raw)
    name = d.pop("event", None)
    cls = EVENT_TYPES.get(name)
    if cls is None:
        raise ValueError(f"unknown event type on the wire: {name!r}")
    return cls(**d)
