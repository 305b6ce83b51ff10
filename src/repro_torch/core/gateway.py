"""Per-node gateway: in-place message queuing (paper §4.2, App-C).

The gateway is the only stateful data-plane component ("stateful tax",
App-F.1).  It terminates client connections, performs the consolidated
one-time payload processing (protocol decode, deserialize, dtype
conversion — App-C RX path), writes the model update into the node's
shared-memory object store, and enqueues only the 16-byte object key.
Aggregators then consume updates in place — no broker, no per-function
queue, no sidecar copies.

TX path (inter-node routing, App-A): the gateway reads the object from
shared memory, serializes once, and ships it to the destination node's
gateway, which stores it and notifies the destination aggregator with a
local key.
"""
from __future__ import annotations

import io
import pickle
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.objectstore import InProcObjectStore


@dataclass
class UpdateEnvelope:
    """What travels between tiers: a key + auxiliary info A_i^k (Eq. 1)."""

    object_key: str
    round_id: int
    sender_id: str
    num_samples: float  # c_i^k — FedAvg weight
    model_version: int = 0
    enqueue_ts: float = 0.0


def serialize_update(update: np.ndarray, aux: Dict) -> bytes:
    """Wire format for inter-node / client->gateway transfer."""
    buf = io.BytesIO()
    np.save(buf, update, allow_pickle=False)
    return pickle.dumps((buf.getvalue(), aux))


def deserialize_update(payload: bytes) -> Tuple[np.ndarray, Dict]:
    raw, aux = pickle.loads(payload)
    return np.load(io.BytesIO(raw)), aux


class Gateway:
    """One per worker node; addressable by clients and peer gateways."""

    def __init__(self, node: str, store=None, cores: int = 1):
        self.node = node
        self.store = store if store is not None else InProcObjectStore(node)
        # FIFO of object keys = the *in-place* message queue (keys only;
        # payloads live in shared memory)
        self.queue: Deque[UpdateEnvelope] = deque()
        self._lock = threading.Lock()
        self.cores = cores  # vertical scaling (§4.2): adjustable
        self.peers: Dict[str, "Gateway"] = {}
        self._subscribers: List[Callable[[UpdateEnvelope], None]] = []
        self.stats = {
            "rx_updates": 0, "rx_bytes": 0, "tx_updates": 0, "tx_bytes": 0,
            "deserialize_s": 0.0,
        }

    # ------------------------------------------------------------------
    # control plane wiring
    # ------------------------------------------------------------------
    def connect_peer(self, other: "Gateway") -> None:
        self.peers[other.node] = other
        other.peers[self.node] = self

    def subscribe(self, fn: Callable[[UpdateEnvelope], None]) -> None:
        """Event-driven delivery (SKMSG notify analogue): called the
        moment an update is queued — enables eager aggregation."""
        self._subscribers.append(fn)

    def set_cores(self, cores: int) -> None:
        """Vertical scaling of the gateway (§4.2)."""
        self.cores = max(1, cores)

    # ------------------------------------------------------------------
    # RX path
    # ------------------------------------------------------------------
    def receive_from_client(self, payload: bytes, round_id: int,
                            sender_id: str) -> UpdateEnvelope:
        """Client -> gateway: one-time payload processing, then in-place
        queue into shared memory (App-C RX)."""
        t0 = time.perf_counter()
        update, aux = deserialize_update(payload)
        self.stats["deserialize_s"] += time.perf_counter() - t0
        return self.put_local(
            update, round_id, sender_id, float(aux.get("num_samples", 1.0))
        )

    def put_local(self, update: np.ndarray, round_id: int, sender_id: str,
                  num_samples: float) -> UpdateEnvelope:
        """Local (already-deserialized) ingest — e.g. a colocated
        aggregator emitting an intermediate update: zero-copy."""
        key = self.store.put(update)
        env = UpdateEnvelope(
            object_key=key, round_id=round_id, sender_id=sender_id,
            num_samples=num_samples, enqueue_ts=time.perf_counter(),
        )
        with self._lock:
            self.queue.append(env)
            self.stats["rx_updates"] += 1
            self.stats["rx_bytes"] += update.nbytes
        for fn in list(self._subscribers):
            fn(env)
        return env

    # ------------------------------------------------------------------
    # TX path (inter-node, App-A)
    # ------------------------------------------------------------------
    def send_to_node(self, env: UpdateEnvelope, dst_node: str) -> UpdateEnvelope:
        """Serialize once, ship to the remote gateway, store remotely."""
        peer = self.peers[dst_node]
        update = self.store.get(env.object_key)
        payload = serialize_update(
            np.asarray(update), {"num_samples": env.num_samples}
        )
        self.stats["tx_updates"] += 1
        self.stats["tx_bytes"] += len(payload)
        return peer.receive_from_client(payload, env.round_id, env.sender_id)

    # ------------------------------------------------------------------
    def pop(self, max_items: int = 1) -> List[UpdateEnvelope]:
        out = []
        with self._lock:
            while self.queue and len(out) < max_items:
                out.append(self.queue.popleft())
        return out

    def queue_length(self) -> int:
        with self._lock:
            return len(self.queue)
