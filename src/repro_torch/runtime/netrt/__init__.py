"""netrt — the multi-node transport: netd daemons + RemoteRuntime.

The layer that turns the single-node event-driven runtime into the
paper's platform: per-node daemons (``netd.py``) own their local
shared-memory runtimes, the frame transport (``transport.py``) carries
the typed event protocol plus serialize-once payloads, and
``RemoteRuntime`` (``remote.py``) implements the ``Runtime`` protocol
so the unchanged ``RoundDriver`` drives cross-node hierarchical
rounds.  See README.md in this package for the frame format, the
handshake, and the failure model.
"""
from repro_torch.runtime.netrt.faults import FaultPlan
from repro_torch.runtime.netrt.remote import (
    BusyError,
    NoLiveNodeError,
    RemoteRuntime,
    push_update,
)
from repro_torch.runtime.netrt.transport import (
    Backoff,
    Frame,
    FrameConn,
    FrameServer,
    PeerDead,
    connect,
)

def __getattr__(name):
    # lazy: `python -m repro_torch.runtime.netrt.netd` must not re-import the
    # daemon module through the package (runpy double-import warning)
    if name in ("NodeDaemon", "spawn_local_daemon", "reap_local_daemon"):
        from repro_torch.runtime.netrt import netd
        return getattr(netd, name)
    raise AttributeError(name)


__all__ = [
    "Backoff",
    "BusyError",
    "FaultPlan",
    "Frame",
    "FrameConn",
    "FrameServer",
    "NodeDaemon",
    "NoLiveNodeError",
    "PeerDead",
    "RemoteRuntime",
    "connect",
    "push_update",
    "reap_local_daemon",
    "spawn_local_daemon",
]
