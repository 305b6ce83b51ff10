"""Deterministic fault injection for the frame transport.

A :class:`FaultPlan` is a *seeded schedule* of transport failures —
frame drops, connection resets, delayed sends, and a daemon self-kill —
hooked into the send path of :class:`~.transport.FrameConn` (every
conn a :class:`~.transport.FrameServer` accepts inherits its server's
plan, and ``netd --fault-spec`` arms a daemon-side plan at spawn).
One soak test with three seeds then exercises every failure mode the
survivability layer handles — lost updates, dead peers, mid-round
daemon restarts — instead of bespoke SIGKILL choreography per mode.

Determinism: all randomness comes from one ``random.Random(seed)``
stream consumed exactly once per *eligible* outbound frame, so the
same seed over the same frame sequence always injects the same
faults.  Rates are per-action probabilities over one uniform draw
(``drop`` wins below ``drop``, ``reset`` below ``drop+reset``, …).

Safety rails for tests that must terminate:

  * ``drop_kinds``/``reset_kinds`` scope each action to frame kinds
    whose loss the protocol absorbs (dropping a ``quiesce`` or
    ``fetch`` would stall its sender on a reply timeout, not exercise
    recovery);
  * ``max_faults`` caps the total injections, after which the plan
    passes everything — a soak provably converges once the fault
    budget is spent;
  * ``kill_after`` is consumed by :class:`~.netd.NodeDaemon` itself
    (SIGKILL after N handled frames), giving the restart mode a
    deterministic trigger point.

Usage::

    plan = FaultPlan(seed=1, drop=0.05, reset=0.02, max_faults=6)
    rt = RemoteRuntime(addrs, fault_plan=plan)        # controller side
    spawn_local_daemon("nodeB", fault_spec=FaultPlan(  # daemon side
        seed=2, delay=0.1, kill_after=40))
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

#: actions FrameConn.send understands (the plan is duck-typed there)
PASS, DROP, RESET, DELAY = "pass", "drop", "reset", "delay"

#: default drop scope: frame kinds with no reply to time out on —
#: their loss is absorbed by drain/teardown, never by a blocked recv
SAFE_DROP_KINDS: Tuple[str, ...] = ("deliver", "event", "partial")


@dataclass
class FaultPlan:
    """One seeded fault schedule (see module docstring)."""

    seed: int = 0
    drop: float = 0.0          # P(drop) per eligible frame
    reset: float = 0.0         # P(inject connection reset)
    delay: float = 0.0         # P(delay the send)
    delay_s: float = 0.002     # how long a delayed send sleeps
    #: frame kinds eligible for drops (None → SAFE_DROP_KINDS)
    drop_kinds: Optional[Tuple[str, ...]] = None
    #: frame kinds eligible for resets (None → every kind)
    reset_kinds: Optional[Tuple[str, ...]] = None
    #: total injection budget (None = unbounded)
    max_faults: Optional[int] = None
    #: netd only: SIGKILL self after handling this many frames
    kill_after: Optional[int] = None
    #: injections so far, by action (shared across every hooked conn)
    injected: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.drop_kinds is None:
            self.drop_kinds = SAFE_DROP_KINDS
        else:
            self.drop_kinds = tuple(self.drop_kinds)
        if self.reset_kinds is not None:
            self.reset_kinds = tuple(self.reset_kinds)
        self._rng = random.Random(self.seed)

    # ------------------------------------------------------------------
    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def _exhausted(self) -> bool:
        return (self.max_faults is not None
                and self.total_injected >= self.max_faults)

    def on_send(self, kind: str, nbytes: int = 0) -> Tuple[str, float]:
        """Decide one outbound frame's fate: ``(action, delay_s)``.
        Called by ``FrameConn.send``; one RNG draw per eligible frame
        keeps the schedule reproducible."""
        can_drop = kind in self.drop_kinds and self.drop > 0
        can_reset = (self.reset_kinds is None
                     or kind in self.reset_kinds) and self.reset > 0
        can_delay = self.delay > 0
        if self._exhausted() or not (can_drop or can_reset or can_delay):
            return PASS, 0.0
        r = self._rng.random()
        edge = self.drop if can_drop else 0.0
        if can_drop and r < edge:
            self.injected[DROP] = self.injected.get(DROP, 0) + 1
            return DROP, 0.0
        if can_reset:
            edge += self.reset
            if r < edge:
                self.injected[RESET] = self.injected.get(RESET, 0) + 1
                return RESET, 0.0
        if can_delay and r < edge + self.delay:
            self.injected[DELAY] = self.injected.get(DELAY, 0) + 1
            return DELAY, self.delay_s
        return PASS, 0.0

    # ------------------------------------------------------------------
    # CLI boundary (netd --fault-spec '<json>')
    # ------------------------------------------------------------------
    def to_json(self) -> str:
        d = {"seed": self.seed, "drop": self.drop, "reset": self.reset,
             "delay": self.delay, "delay_s": self.delay_s,
             "drop_kinds": list(self.drop_kinds),
             "max_faults": self.max_faults, "kill_after": self.kill_after}
        if self.reset_kinds is not None:
            d["reset_kinds"] = list(self.reset_kinds)
        return json.dumps(d, separators=(",", ":"))

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        d = json.loads(raw)
        for k in ("drop_kinds", "reset_kinds"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})
