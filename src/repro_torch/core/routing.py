"""Direct routing for hierarchical aggregation (paper §4.4, App-A).

The paper offloads route state to eBPF: a *sockmap* keyed by aggregator
ID delivers object keys intra-node; an inter-node routing table in the
gateway forwards via the destination node's gateway.  Here the sockmap
is a host-side table mapping aggregator ID -> local mailbox (socket
analogue), and the ``RoutingManager`` performs the online hierarchy
update (App-A: ``bpf_map_update_elem`` on re-plan): given a new TAG it
rewrites both tables without touching in-flight state — aggregators are
stateless, so re-routing is safe mid-round.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.gateway import Gateway, UpdateEnvelope
from repro_torch.core.tag import CHANNEL_SHM, TAG


class SockMap:
    """aggregator id -> mailbox (the BPF_MAP_TYPE_SOCKMAP analogue)."""

    def __init__(self):
        self._m: Dict[str, Deque[UpdateEnvelope]] = {}
        self._notify: Dict[str, Callable[[UpdateEnvelope], None]] = {}
        self._lock = threading.Lock()

    def register(self, agg_id: str,
                 notify: Optional[Callable[[UpdateEnvelope], None]] = None):
        with self._lock:
            self._m.setdefault(agg_id, deque())
            if notify:
                self._notify[agg_id] = notify

    def unregister(self, agg_id: str):
        with self._lock:
            self._m.pop(agg_id, None)
            self._notify.pop(agg_id, None)

    def deliver(self, agg_id: str, env: UpdateEnvelope) -> bool:
        """SKMSG redirect: pass the object key to the destination's
        mailbox; zero-copy (payload stays in shared memory)."""
        with self._lock:
            box = self._m.get(agg_id)
            notify = self._notify.get(agg_id)
        if box is None:
            return False
        box.append(env)
        if notify:
            notify(env)
        return True

    def mailbox(self, agg_id: str) -> Deque[UpdateEnvelope]:
        with self._lock:
            return self._m[agg_id]


@dataclass
class Route:
    dst_agg: str
    dst_node: str
    channel: str  # CHANNEL_SHM | CHANNEL_NET


class RoutingManager:
    """Per-node LIFL-agent routing component."""

    def __init__(self, node: str, gateway: Gateway, sockmap: SockMap):
        self.node = node
        self.gateway = gateway
        self.sockmap = sockmap
        # src aggregator id -> Route (the inter-node routing table + the
        # intra-node next-hop table, App-A)
        self.routes: Dict[str, Route] = {}
        self.stats = {"intra_node_sends": 0, "inter_node_sends": 0,
                      "route_updates": 0}

    # ------------------------------------------------------------------
    @staticmethod
    def node_of(agg_id: str) -> str:
        return agg_id.rsplit("@", 1)[1]

    def install_tag(self, tag: TAG) -> None:
        """Online hierarchy update: rebuild routes from the (new) TAG."""
        self.routes.clear()
        for ch in tag.channels:
            if ch.src not in tag.nodes or tag.nodes[ch.src].role != "aggregator":
                continue
            if self.node_of(ch.src) != self.node:
                continue
            self.routes[ch.src] = Route(
                dst_agg=ch.dst,
                dst_node=self.node_of(ch.dst),
                channel=ch.channel,
            )
            self.stats["route_updates"] += 1

    # ------------------------------------------------------------------
    def send(self, src_agg: str, env: UpdateEnvelope) -> bool:
        """Route an intermediate update from ``src_agg`` one level up."""
        route = self.routes.get(src_agg)
        if route is None:
            return False
        if route.dst_node == self.node:
            # intra-node: sockmap redirect of the object key (zero-copy)
            self.stats["intra_node_sends"] += 1
            return self.sockmap.deliver(route.dst_agg, env)
        # inter-node: via gateways (serialize once, App-A TX)
        self.stats["inter_node_sends"] += 1
        remote_env = self.gateway.send_to_node(env, route.dst_node)
        remote_mgr = _REGISTRY.get(route.dst_node)
        if remote_mgr is not None:
            return remote_mgr.sockmap.deliver(route.dst_agg, remote_env)
        return False


# node -> RoutingManager (cluster wiring for tests/simulator)
_REGISTRY: Dict[str, "RoutingManager"] = {}


def register_node(mgr: RoutingManager) -> None:
    _REGISTRY[mgr.node] = mgr


def clear_registry() -> None:
    _REGISTRY.clear()
