"""Lock-free SPSC rings over shared memory — the eBPF-proxy analog.

The paper's lightweight proxy replaces a per-function message broker
with an in-kernel sockmap redirect: the only thing that moves between
functions on a node is a 16-byte object key (§4.2, App-A).  The
host-side analog is a single-producer/single-consumer ring in a shared
memory segment: fixed-size slots, a producer-owned head counter and a
consumer-owned tail counter on separate cache lines, no locks.

Correctness model (x86-64 / CPython): each counter has exactly one
writer; 8-byte aligned loads/stores through a ``memoryview`` cast are
single machine accesses, and the GIL's memory fences on bytecode
boundaries give the release/acquire ordering a C implementation would
get from atomics.  The producer writes the slot *then* bumps head; the
consumer reads head *then* the slot.

Blocking: an ``eventfd``-backed :class:`Doorbell` gives epoll-style
wakeups (the SKMSG notify analog — the paper's event-driven "no
polling" property).  Where ``os.eventfd`` is unavailable the doorbell
degrades to a bounded-backoff sleep poll (the futex/condvar fallback),
with the same API and the same observable semantics, just worse tail
latency.

Ring layout (bytes):
  [0:8)    magic  b"LIFLRING"
  [8:12)   slot_size u32
  [12:16)  nslots    u32
  [64:72)  head  u64   (producer cache line)
  [128:136) tail u64   (consumer cache line)
  [192:..) slots
"""
from __future__ import annotations

import os
import select
import struct
import time
from typing import List, Optional

from repro_torch.core.objectstore import (
    attach_segment,
    create_segment,
    unlink_segment,
    untrack_segment,
)

_MAGIC = b"LIFLRING"
_HDR_FMT = "<8sII"
_HEAD_OFF = 64
_TAIL_OFF = 128
_DATA_OFF = 192

HAVE_EVENTFD = hasattr(os, "eventfd")


class Doorbell:
    """Cross-process wakeup: ``ring()`` on one side, ``wait()`` on the
    other.  eventfd when the platform has it (fd inherited across
    fork), else a backoff sleep poll."""

    def __init__(self) -> None:
        self._fd = os.eventfd(0, os.EFD_NONBLOCK) if HAVE_EVENTFD else -1

    # -- producer side --------------------------------------------------
    def ring(self) -> None:
        if self._fd >= 0:
            try:
                os.eventfd_write(self._fd, 1)
            except BlockingIOError:
                pass  # counter saturated: the sleeper is already woken

    # -- consumer side --------------------------------------------------
    def wait(self, timeout: Optional[float]) -> bool:
        """Block up to ``timeout`` s for a ring.  Returns True on a
        wakeup, False on timeout.  The caller re-checks its condition
        either way (wakeups can be spurious/coalesced)."""
        if self._fd >= 0:
            r, _, _ = select.select([self._fd], [], [],
                                    timeout if timeout is not None else None)
            if r:
                try:
                    os.eventfd_read(self._fd)  # drain the counter
                except BlockingIOError:
                    pass
                return True
            return False
        # fallback: bounded sleep (condvar-less poll)
        time.sleep(min(timeout if timeout is not None else 0.001, 0.001))
        return False

    def drain(self) -> None:
        if self._fd >= 0:
            try:
                os.eventfd_read(self._fd)
            except BlockingIOError:
                pass

    def fileno(self) -> int:
        """-1 when the fallback (no eventfd) is active — callers that
        multiplex over several doorbells must skip those."""
        return self._fd

    def close(self) -> None:
        if self._fd >= 0:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = -1


class SpscRing:
    """Single-producer single-consumer ring of fixed-size slots.

    One side constructs with ``create=True`` (owns the segment and
    unlinks it); the other attaches by name — or, under fork, simply
    inherits the object (the mmap is shared either way).
    """

    def __init__(self, name: str, slot_size: int = 64, nslots: int = 1024,
                 *, create: bool = False,
                 data_bell: Optional[Doorbell] = None,
                 space_bell: Optional[Doorbell] = None):
        if create:
            size = _DATA_OFF + slot_size * nslots
            self._seg = create_segment(name, size)
            struct.pack_into(_HDR_FMT, self._seg.buf, 0,
                             _MAGIC, slot_size, nslots)
            self._owner = True
        else:
            self._seg = attach_segment(name)
            magic, slot_size, nslots = struct.unpack_from(
                _HDR_FMT, self._seg.buf, 0)
            if magic != _MAGIC:
                raise ValueError(f"segment {name!r} is not a LIFL ring")
            self._owner = False
        self.name = name
        self.slot_size = int(slot_size)
        self.nslots = int(nslots)
        self._q = self._seg.buf.cast("Q")  # u64 lattice over the segment
        self._buf = self._seg.buf
        # data_bell: producer rings after push (consumer sleeps on it);
        # space_bell: consumer rings after pop (backpressured producer
        # sleeps on it)
        self.data_bell = data_bell
        self.space_bell = space_bell

    # -- counters (single-writer each) ----------------------------------
    @property
    def _head(self) -> int:
        return self._q[_HEAD_OFF // 8]

    @_head.setter
    def _head(self, v: int) -> None:
        self._q[_HEAD_OFF // 8] = v

    @property
    def _tail(self) -> int:
        return self._q[_TAIL_OFF // 8]

    @_tail.setter
    def _tail(self, v: int) -> None:
        self._q[_TAIL_OFF // 8] = v

    def __len__(self) -> int:
        return self._head - self._tail

    @property
    def capacity(self) -> int:
        return self.nslots

    def full(self) -> bool:
        return len(self) >= self.nslots

    # -- producer -------------------------------------------------------
    def push(self, payload: bytes, *, timeout: Optional[float] = None) -> bool:
        """Write one slot.  Full ring: returns False immediately when
        ``timeout is None``, else blocks up to ``timeout`` s for space
        (backpressure).  Payload must fit a slot."""
        if len(payload) > self.slot_size:
            raise ValueError(f"payload {len(payload)}B > slot {self.slot_size}B")
        if self.full():
            if timeout is None:
                return False
            deadline = time.perf_counter() + timeout
            while self.full():
                left = deadline - time.perf_counter()
                if left <= 0:
                    return False
                if self.space_bell is not None:
                    self.space_bell.wait(min(left, 0.05))
                else:
                    time.sleep(0.0002)
        head = self._head
        off = _DATA_OFF + (head % self.nslots) * self.slot_size
        self._buf[off:off + len(payload)] = payload
        self._head = head + 1          # publish after the slot is written
        if self.data_bell is not None:
            self.data_bell.ring()
        return True

    # -- consumer -------------------------------------------------------
    def pop(self, *, timeout: Optional[float] = None) -> Optional[bytes]:
        """Read one slot, or None.  ``timeout`` blocks on the data
        doorbell (event-driven idle — no spin while parked warm)."""
        if self._tail >= self._head and timeout is not None:
            deadline = time.perf_counter() + timeout
            while self._tail >= self._head:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                if self.data_bell is not None:
                    self.data_bell.wait(min(left, 0.5))
                else:
                    time.sleep(0.0002)
        tail = self._tail
        if tail >= self._head:
            return None
        off = _DATA_OFF + (tail % self.nslots) * self.slot_size
        payload = bytes(self._buf[off:off + self.slot_size])
        self._tail = tail + 1
        if self.space_bell is not None:
            self.space_bell.ring()
        return payload

    def pop_many(self, max_n: int) -> List[bytes]:
        """Drain up to ``max_n`` queued slots without blocking — the
        K-way burst the batched engine fold consumes."""
        out: List[bytes] = []
        while len(out) < max_n:
            rec = self.pop()
            if rec is None:
                break
            out.append(rec)
        return out

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        # release the memoryview casts before closing the mmap
        try:
            self._q.release()
        except Exception:
            pass
        try:
            self._seg.close()
        except BufferError:
            pass

    def unlink(self) -> None:
        self.close()
        untrack_segment(self.name)
        unlink_segment(self.name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._owner:
            self.unlink()
        else:
            self.close()
