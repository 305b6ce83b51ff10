"""Hierarchy-aware autoscaling (paper §5.2).

Plans, per worker node, a two-level k-ary aggregation tree sized to the
EWMA-smoothed pending-update estimate Q̂:

    Q̂_{i,t} = α·Q̂_{i,t−1} + (1−α)·Q_{i,t},   α = 0.7 (paper)

    leaves_i = ceil(Q̂_i / I)   with small fan-in I (default 2): a leaf
    starts aggregating after its first update arrives — minimal waiting,
    maximal parallelism (§5.2).

Every planned node produces one intermediate update routed to the top
aggregator's node, so exactly (nodes_used − 1) updates cross the
network per round.  The planner re-runs on a period (paper: 2 min);
LIFL's executable-reuse (reuse.py) makes re-planning cheap.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

DEFAULT_ALPHA = 0.7
DEFAULT_FANIN = 2


class EWMA:
    """Q̂ estimator; ~0.2 ms per estimate in the paper (§6.1)."""

    def __init__(self, alpha: float = DEFAULT_ALPHA):
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, observation: float) -> float:
        if self.value is None:
            self.value = float(observation)
        else:
            self.value = self.alpha * self.value + (1 - self.alpha) * observation
        return self.value


@dataclass
class NodePlan:
    node: str
    num_leaves: int
    fan_in: int
    has_middle: bool

    @property
    def num_aggregators(self) -> int:
        return self.num_leaves + (1 if self.has_middle else 0)


@dataclass
class HierarchyPlan:
    per_node: Dict[str, NodePlan]
    top_node: Optional[str]

    @property
    def total_aggregators(self) -> int:
        n = sum(p.num_aggregators for p in self.per_node.values())
        return n + (1 if self.top_node else 0)

    @property
    def nodes_used(self) -> List[str]:
        return [n for n, p in self.per_node.items() if p.num_leaves > 0]

    def levels(self) -> int:
        if not self.per_node:
            return 0
        multi = any(p.has_middle for p in self.per_node.values())
        return 3 if multi else 2


class HierarchyPlanner:
    """Periodic re-planner: smooths Q per node, sizes each node's tree."""

    def __init__(self, alpha: float = DEFAULT_ALPHA, fan_in: int = DEFAULT_FANIN,
                 replan_period_s: float = 120.0):
        self.alpha = alpha
        self.fan_in = max(1, fan_in)
        self.replan_period_s = replan_period_s
        self._estimators: Dict[str, EWMA] = {}
        self._last_plan: Optional[HierarchyPlan] = None

    def smoothed_queue(self, node: str, observed_q: float) -> float:
        est = self._estimators.setdefault(node, EWMA(self.alpha))
        return est.update(observed_q)

    def plan(self, queue_by_node: Dict[str, float],
             top_node: Optional[str] = None,
             smooth: bool = True) -> HierarchyPlan:
        per_node: Dict[str, NodePlan] = {}
        for node, q in queue_by_node.items():
            q_hat = self.smoothed_queue(node, q) if smooth else q
            n_leaves = max(0, math.ceil(q_hat / self.fan_in))
            # a middle aggregator is needed once >1 leaf exists on a node
            per_node[node] = NodePlan(
                node=node,
                num_leaves=n_leaves,
                fan_in=self.fan_in,
                has_middle=n_leaves > 1,
            )
        if top_node is None:
            used = [n for n, p in per_node.items() if p.num_leaves > 0]
            top_node = max(
                used, key=lambda n: per_node[n].num_leaves, default=None
            )
        self._last_plan = HierarchyPlan(per_node=per_node, top_node=top_node)
        return self._last_plan

    def diff(self, new: HierarchyPlan) -> Dict[str, int]:
        """Aggregators to create (+) / terminate (−) per node vs the last
        plan — what the LIFL agent actually executes on re-plan."""
        out: Dict[str, int] = {}
        old = self._last_plan.per_node if self._last_plan else {}
        for node in set(new.per_node) | set(old):
            before = old[node].num_aggregators if node in old else 0
            after = new.per_node[node].num_aggregators if node in new.per_node else 0
            if after != before:
                out[node] = after - before
        return out


def aggregation_completion_time(
    num_updates: int,
    plan: HierarchyPlan,
    *,
    t_agg: float,
    t_intra: float,
    t_inter: float,
    cold_starts: int = 0,
    t_cold: float = 0.0,
    eager: bool = True,
) -> float:
    """Analytic ACT model used by the planner to compare candidate plans
    (and by the orchestration benchmark to reproduce Fig 8(a) trends).

    Levels execute in sequence; each level's span is its per-aggregator
    sequential work.  Eager aggregation overlaps Recv with Agg so a level
    costs max(arrival span, agg of the final update) instead of
    queue-then-aggregate (≈20% ACT cut in the paper).
    """
    used = plan.nodes_used
    if not used or num_updates == 0:
        return 0.0
    per_node_updates = max(1, math.ceil(num_updates / len(used)))
    fan = plan.per_node[used[0]].fan_in if used else 1

    def level_time(n_inputs: int, n_aggs: int, t_in: float) -> float:
        per_agg = max(1, math.ceil(n_inputs / max(1, n_aggs)))
        if eager:
            # recv of all but the last overlaps aggregation
            return t_in + per_agg * t_agg
        return per_agg * t_in + per_agg * t_agg

    # level 1: leaves consume client updates (intra-node via shm)
    leaves = max(1, plan.per_node[used[0]].num_leaves)
    t = level_time(per_node_updates, leaves, t_intra)
    # level 2: middle consumes leaf outputs
    t += level_time(leaves, 1, t_intra)
    # level 3: top consumes one intermediate per node; all but the top
    # node's cross the network
    n_remote = max(0, len(used) - 1)
    t += level_time(max(1, len(used)), 1, t_inter if n_remote else t_intra)
    t += cold_starts * t_cold
    return t
