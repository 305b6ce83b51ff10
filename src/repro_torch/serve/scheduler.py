"""Rolling-round scheduling: close-out policies + the two-slot stepper.

A *continuous* aggregation service never has a natural caller-side
round boundary — the platform decides when a round's cohort is closed
(the close-out policy) and when the next round opens (the scheduler).
LIFL's event-driven design makes the overlap free: round N's root fold
is runtime work the driver only *waits* on, so round N+1's
SPAWN/DISPATCH can run in that window.  The scheduler below interleaves
up to ``max_open`` resumable :class:`~repro_torch.runtime.driver.RoundHandle`
generators on one driver; it opens round N+1 the first time round N
pauses in its ``fold`` phase.

Close-out policies fire inside the round's *feed* (the driver pulls;
the policy decides whether the answer is "another update", "not yet",
or "cohort closed"):

  ``GoalPolicy``        never closes early — the aggregation goal does
  ``DeadlinePolicy``    wall-clock budget per round
  ``MinCohortIdleGap``  the just-in-time trigger: once ``min_cohort``
                        updates are in AND the ingress has been idle
                        for ``idle_gap_s``, stop waiting for stragglers
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional


# ---------------------------------------------------------------------------
# close-out policies (duck-typed: anything with should_close works)
# ---------------------------------------------------------------------------


@dataclass
class GoalPolicy:
    """Close on the aggregation goal only (the driver enforces it)."""

    def should_close(self, *, n: int, opened_s: float,
                     idle_s: float) -> bool:
        return False


@dataclass
class DeadlinePolicy:
    """Close when the round has been open ``deadline_s`` seconds
    (even empty — an idle service still turns rounds over)."""

    deadline_s: float

    def should_close(self, *, n: int, opened_s: float,
                     idle_s: float) -> bool:
        return opened_s >= self.deadline_s


@dataclass
class MinCohortIdleGap:
    """The just-in-time close: a round closes once it holds at least
    ``min_cohort`` updates and no new one has arrived for
    ``idle_gap_s`` — late stragglers roll into the next round instead
    of stalling this one."""

    min_cohort: int
    idle_gap_s: float = 0.05

    def should_close(self, *, n: int, opened_s: float,
                     idle_s: float) -> bool:
        return n >= self.min_cohort and idle_s >= self.idle_gap_s


# ---------------------------------------------------------------------------
# the stepper
# ---------------------------------------------------------------------------


class RoundScheduler:
    """Interleave rolling rounds on one driver.

    ``open_next()`` supplies the next opened round (a
    ``_TrainerRound`` from ``FederatedTrainer.open_round``, or anything
    exposing ``.handle``/``.finalize()``) or ``None`` when no more
    rounds are wanted.  The scheduler steps the open rounds
    round-robin; it opens the next one as soon as the *oldest* open
    round first pauses in its ``fold`` phase (and a slot is free), so
    round N+1's spawn/dispatch overlaps round N's root fold — the
    paper's pipelining argument, measured by the caller via
    ``on_open``/``on_close`` stamps."""

    def __init__(self, open_next: Callable[[], Optional[object]], *,
                 max_open: int = 2,
                 idle_sleep_s: float = 0.001,
                 on_open: Optional[Callable[[object], None]] = None,
                 on_close: Optional[Callable[[object], None]] = None):
        self._open_next = open_next
        self.max_open = int(max_open)
        self.idle_sleep_s = idle_sleep_s
        self._on_open = on_open
        self._on_close = on_close
        self._exhausted = False

    def _try_open(self, active: List[object]) -> None:
        if self._exhausted or len(active) >= self.max_open:
            return
        nxt = self._open_next()
        if nxt is None:
            self._exhausted = True
            return
        if self._on_open is not None:
            self._on_open(nxt)
        active.append(nxt)

    def run(self) -> List[object]:
        """Drive rounds until ``open_next`` runs dry and every open
        round closed.  Returns the closed rounds in close order."""
        active: List[object] = []
        closed: List[object] = []
        self._try_open(active)
        while active:
            # the rolling seam: the oldest round waiting on its fold
            # frees the dispatch path for the next one
            if active[0].handle.phase == "fold":
                self._try_open(active)
            progressed = False
            for rnd in list(active):
                st = rnd.handle.st
                before = (sum(len(v) for v in st.sent.values())
                          + len(st.out.skipped))
                phase = rnd.handle.step()
                moved = (sum(len(v) for v in st.sent.values())
                         + len(st.out.skipped)) > before
                # an empty-feed dispatch pause is the one non-progress
                # step; anything that moved an update or changed phase
                # counts
                if phase != "dispatch" or rnd.handle.done or moved:
                    progressed = True
                if rnd.handle.done:
                    active.remove(rnd)
                    rnd.finalize()
                    if self._on_close is not None:
                        self._on_close(rnd)
                    closed.append(rnd)
            if not active:
                self._try_open(active)
            if not progressed and active:
                # every open round is idling on an empty feed: yield
                # the thread so pushers can actually enqueue
                time.sleep(self.idle_sleep_s)
        return closed
