"""shmrt — the multi-process, event-driven aggregation runtime.

The paper's §4.2/App-A data plane, realized on one node: aggregator
*worker processes* connected by lock-free SPSC shared-memory rings that
carry nothing but 16-byte object keys (+ auxiliary info A_i^k), with
payloads resident in the shared-memory object store and accumulator
scratch allocated *inside* the store so intermediate aggregates are
published zero-copy.  See README.md in this package for the
architecture sketch.
"""
from repro_torch.runtime.shmrt.dispatcher import ShmRuntime, WorkerCrash
from repro_torch.runtime.shmrt.messages import Record, RecordKind
from repro_torch.runtime.shmrt.ring import Doorbell, SpscRing
from repro_torch.runtime.shmrt.shmengine import ShmAccumulatorEngine

__all__ = [
    "Doorbell",
    "Record",
    "RecordKind",
    "ShmAccumulatorEngine",
    "ShmRuntime",
    "SpscRing",
    "WorkerCrash",
]
