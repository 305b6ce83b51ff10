"""Fixed-size ring records: what actually crosses a process boundary.

One slot = one 64-byte record.  The data-plane record is exactly the
paper's envelope — a 16-byte object key plus auxiliary info A_i^k
(round, FedAvg weight c_i^k, enqueue timestamp); control records (task
assignment, drain, shutdown, ack, ready, partial) reuse the same layout
with kind-specific meaning for the scalar fields, so one codec serves
both rings.

Layout (64 bytes, little-endian):
  kind u8 | pad 7 | key 16s | round_id u32 | flags u32 |
  num_samples f64 | ts f64 | a u64 | b u64
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from enum import IntEnum

RECORD_BYTES = 64
_FMT = "<B7x16sIIddQQ"
assert struct.calcsize(_FMT) == RECORD_BYTES


class RecordKind(IntEnum):
    TASK = 1      # dispatcher → worker: key=agg tag, flags=seq,
                  #   a=goal, b=n_elems
    UPDATE = 2    # dispatcher → worker: key=object key, num_samples=c_i^k
    DRAIN = 3     # dispatcher → worker: close out the open task
    SHUTDOWN = 4  # dispatcher → worker: exit the loop (graceful)
    READY = 5     # worker → dispatcher: process up, polling (a=pid)
    ACK = 6       # worker → dispatcher: task picked up (flags=seq, ts=now)
    PARTIAL = 7   # worker → dispatcher: key=partial-sum object, flags=seq,
                  #   num_samples=Σ weight, a=count folded, b=exec ns
    ERROR = 8     # worker → dispatcher: dropped/failed record
    EMPTY = 9     # worker → dispatcher: task closed with nothing folded
                  #   (DRAIN before any update arrived)
    PARTIAL_IN = 10  # dispatcher → worker: fold a published raw partial
                  #   Σ c·u (root fold): key=partial object,
                  #   num_samples=Σ weight, a=subtree update count
    TELEM = 11    # worker → dispatcher: task telemetry at publish time
                  #   (flags=seq, num_samples=ring-wait seconds while
                  #   the task was open, ts=publish ts, a=count folded)
                  #   — rides the same result ring, fired only on the
                  #   publish edge: no polling, no extra syscalls


@dataclass
class Record:
    kind: int
    key: str = ""            # 16-char hex object key / agg tag
    round_id: int = 0
    flags: int = 0
    num_samples: float = 0.0
    ts: float = 0.0          # CLOCK_MONOTONIC (perf_counter) — one host,
                             # comparable across the node's processes
    a: int = 0
    b: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            _FMT, self.kind, self.key.encode("ascii"), self.round_id,
            self.flags, self.num_samples, self.ts, self.a, self.b,
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "Record":
        kind, key, round_id, flags, num_samples, ts, a, b = struct.unpack(
            _FMT, raw[:RECORD_BYTES])
        return cls(
            kind=kind, key=key.rstrip(b"\0").decode("ascii"),
            round_id=round_id, flags=flags, num_samples=num_samples,
            ts=ts, a=a, b=b,
        )
