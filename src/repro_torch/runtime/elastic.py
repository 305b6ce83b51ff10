"""Elastic scaling + failure handling for the FL service.

LIFL's elasticity story at pod scale:
  * load changes (clients arriving/leaving) → the EWMA planner resizes
    the hierarchy; warm aggregators are reused, idle ones terminated
    (load-proportional resources, Fig 10);
  * node/pod loss → drop the pod from the dp axes, re-plan, restore
    params from the last async checkpoint if the top aggregator's pod
    died; over-provisioned cohorts mean the aggregation goal still
    closes the round;
  * stragglers → rounds close at the aggregation goal n < n_selected;
    late updates are discarded (synchronous FL, §6.2).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.hierarchy import HierarchyPlanner
from repro_torch.core.placement import NodeState
from repro_torch.core.reuse import AggregatorPool


@dataclass
class ArrivalTrace:
    """Synthetic arrival-rate trace like Fig 10(a): hibernating mobile
    clients produce a varying load."""

    base_rate: float
    variability: float = 0.5
    period_rounds: int = 20
    seed: int = 0

    def rate(self, round_id: int) -> float:
        rng = np.random.default_rng((self.seed, round_id))
        wave = 1 + self.variability * np.sin(2 * np.pi * round_id / self.period_rounds)
        noise = rng.uniform(1 - self.variability / 2, 1 + self.variability / 2)
        return max(0.0, self.base_rate * wave * noise)


@dataclass
class ElasticEvent:
    round_id: int
    kind: str           # 'scale_up' | 'scale_down' | 'node_lost' | 'node_joined'
    detail: Dict


class ElasticController:
    """Drives plan→scale→reuse across rounds; tolerates node churn."""

    def __init__(self, nodes: Dict[str, NodeState],
                 planner: Optional[HierarchyPlanner] = None,
                 pool: Optional[AggregatorPool] = None):
        self.nodes = dict(nodes)
        self.planner = planner or HierarchyPlanner()
        self.pool = pool or AggregatorPool()
        self.events: List[ElasticEvent] = []
        self._last_total = 0

    # ------------------------------------------------------------------
    def lose_node(self, node: str, round_id: int) -> None:
        self.nodes.pop(node, None)
        # its aggregators are gone; stateless design means no state sync
        victims = [a for a, i in self.pool.instances.items() if i.node == node]
        for a in victims:
            self.pool.terminate(a)
        self.events.append(ElasticEvent(round_id, "node_lost",
                                        {"node": node, "killed": len(victims)}))

    def join_node(self, node: str, capacity: float, round_id: int) -> None:
        self.nodes[node] = NodeState(node=node, max_capacity=capacity)
        self.events.append(ElasticEvent(round_id, "node_joined", {"node": node}))

    # ------------------------------------------------------------------
    def step(self, round_id: int, expected_updates: float) -> Dict:
        """Re-plan for the expected load; create/terminate instances."""
        if not self.nodes:
            raise RuntimeError("no nodes available")
        per_node = expected_updates / len(self.nodes)
        plan = self.planner.plan({n: per_node for n in self.nodes})
        total = plan.total_aggregators
        if total > self._last_total:
            self.events.append(ElasticEvent(round_id, "scale_up",
                                            {"from": self._last_total, "to": total}))
        elif total < self._last_total:
            self.pool.terminate_idle()
            self.events.append(ElasticEvent(round_id, "scale_down",
                                            {"from": self._last_total, "to": total}))
        self._last_total = total
        return {
            "aggregators_planned": total,
            "nodes": len(self.nodes),
            "levels": plan.levels(),
        }

    # ------------------------------------------------------------------
    # event-protocol face: the controller is an ordinary handler on the
    # round driver (subscribe ``handle`` to NodeJoined/NodeLost) and a
    # ScaleDecision producer (``decide`` wraps ``step``)
    # ------------------------------------------------------------------
    def handle(self, event) -> None:
        """React to a typed runtime event (repro_torch.runtime.events)."""
        from repro_torch.runtime.events import NodeJoined, NodeLost

        rid = event.round_id if event.round_id is not None else 0
        if isinstance(event, NodeLost):
            self.lose_node(event.node, rid)
        elif isinstance(event, NodeJoined):
            self.join_node(event.node, event.capacity or 20.0, rid)

    def decide(self, round_id: int, expected_updates: float):
        """Re-plan and return the result as a :class:`ScaleDecision`
        event, ready for ``driver.dispatch``/``Session.emit``."""
        from repro_torch.runtime.events import ScaleDecision

        before = self._last_total
        st = self.step(round_id, expected_updates)
        after = st["aggregators_planned"]
        direction = ("up" if after > before
                     else "down" if after < before else "hold")
        return ScaleDecision(
            round_id=round_id, aggregators_planned=after,
            nodes=st["nodes"], levels=st["levels"], direction=direction)
