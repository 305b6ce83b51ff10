"""Topology Abstraction Graph (paper App-D, after Flame).

Describes aggregator↔aggregator and aggregator↔client connectivity.
Each node carries a *role* (aggregator | client) and each edge a
*channel* whose ``groupBy`` label expresses placement affinity — keeping
the same label clusters roles into a locality group that the placement
engine maps onto one worker node (→ shared-memory channel); edges across
groups use inter-node channels.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

ROLE_CLIENT = "client"
ROLE_AGGREGATOR = "aggregator"

CHANNEL_SHM = "intra-node-shared-memory"
CHANNEL_NET = "inter-node-kernel-networking"


@dataclass
class TagNode:
    node_id: str
    role: str
    level: int = 0  # 0 = client, 1 = leaf, 2 = middle, 3 = top


@dataclass
class TagChannel:
    src: str
    dst: str
    group_by: str = ""       # placement-affinity label (App-D)
    channel: str = CHANNEL_NET


@dataclass
class TAG:
    nodes: Dict[str, TagNode] = field(default_factory=dict)
    channels: List[TagChannel] = field(default_factory=list)

    def add_node(self, node_id: str, role: str, level: int = 0) -> TagNode:
        n = TagNode(node_id, role, level)
        self.nodes[node_id] = n
        return n

    def add_channel(self, src: str, dst: str, group_by: str = "",
                    channel: str = CHANNEL_NET) -> TagChannel:
        c = TagChannel(src, dst, group_by, channel)
        self.channels.append(c)
        return c

    # ------------------------------------------------------------------
    def children(self, node_id: str) -> List[str]:
        return [c.src for c in self.channels if c.dst == node_id]

    def parent(self, node_id: str) -> Optional[str]:
        for c in self.channels:
            if c.src == node_id:
                return c.dst
        return None

    def groups(self) -> Dict[str, Set[str]]:
        """groupBy label -> role ids clustered under it."""
        out: Dict[str, Set[str]] = {}
        for c in self.channels:
            if c.group_by:
                out.setdefault(c.group_by, set()).update((c.src, c.dst))
        return out

    def roots(self) -> List[str]:
        has_parent = {c.src for c in self.channels}
        return [
            n for n, meta in self.nodes.items()
            if meta.role == ROLE_AGGREGATOR and n not in has_parent
        ]

    def validate_single_rooted(self) -> bool:
        """Hierarchical aggregation is a single-rooted tree (§2.2)."""
        return len(self.roots()) == 1

    def aggregators(self) -> List[str]:
        return [n for n, m in self.nodes.items() if m.role == ROLE_AGGREGATOR]

    def leaves(self) -> List[str]:
        aggs = set(self.aggregators())
        client_parents = {
            self.parent(n) for n, m in self.nodes.items() if m.role == ROLE_CLIENT
        }
        return [a for a in aggs if a in client_parents]


def build_two_level_tag(
    node_plans: Dict[str, int],
    clients_per_leaf: int,
    top_node: str,
) -> TAG:
    """Paper §5.2: per worker node a two-level k-ary tree — leaf
    aggregators (fan-in = clients_per_leaf) under one middle aggregator;
    each node's middle dispatches its intermediate update to the single
    top aggregator on ``top_node``.

    node_plans: worker node -> number of leaf aggregators planned there.
    """
    tag = TAG()
    top_id = f"top@{top_node}"
    tag.add_node(top_id, ROLE_AGGREGATOR, level=3)
    for node, n_leaves in node_plans.items():
        if n_leaves <= 0:
            continue
        mid_id = f"mid@{node}"
        tag.add_node(mid_id, ROLE_AGGREGATOR, level=2)
        tag.add_channel(
            mid_id, top_id,
            group_by=node if node == top_node else "",
            channel=CHANNEL_SHM if node == top_node else CHANNEL_NET,
        )
        for i in range(n_leaves):
            leaf_id = f"leaf{i}@{node}"
            tag.add_node(leaf_id, ROLE_AGGREGATOR, level=1)
            tag.add_channel(leaf_id, mid_id, group_by=node, channel=CHANNEL_SHM)
            for c in range(clients_per_leaf):
                cid = f"client{i}.{c}@{node}"
                tag.add_node(cid, ROLE_CLIENT, level=0)
                tag.add_channel(cid, leaf_id, group_by=node, channel=CHANNEL_SHM)
    return tag
