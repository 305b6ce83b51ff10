"""Aggregation engine whose accumulator lives in the object store.

The PR-1 blocked engine, with one change: ``begin`` allocates the fp32
accumulator *inside* a shared-memory object (``store.alloc``) instead
of the process heap.  The worker folds updates into it in place (same
cache-tiled hot loop), and when the aggregation goal is met the
accumulator is published with :meth:`publish` — ``seal`` writes the
object header, ``disown`` hands cleanup to the dispatcher, and the
16-byte key goes up the result ring.  The parent then folds this
partial straight out of the store: the intermediate aggregate is never
copied, serialized, or re-queued (paper §4.2: shared-memory processing
between hierarchical aggregators on one node).

Warm reuse: the scratch tile survives across tasks like any blocked
engine.  The accumulator segment is surrendered on publish (it *is*
the published object), so each task allocates one fresh segment — the
§5.3 warm-start win in the multi-process runtime is the resident
process + rings + scratch, measured by ``bench_shmrt``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.engine import BLOCK_ELEMS, BlockedNumpyEngine
from repro_torch.core.objectstore import SharedMemoryObjectStore


class ShmAccumulatorEngine(BlockedNumpyEngine):
    name = "shm_blocked"

    def __init__(self, store: SharedMemoryObjectStore,
                 block_elems: int = BLOCK_ELEMS,
                 key_prefix: str = "") -> None:
        super().__init__(block_elems)
        self.store = store
        self.key_prefix = key_prefix
        self._key: Optional[str] = None

    def _new_key(self) -> str:
        """Worker-tagged object key: the first chars identify the
        creating worker, so the dispatcher can reclaim a SIGKILLed
        worker's segments by name prefix."""
        import secrets

        from repro_torch.core.objectstore import KEY_BYTES

        n = KEY_BYTES - len(self.key_prefix)
        return self.key_prefix + secrets.token_hex(n // 2)[:n]

    def begin(self, n: int) -> np.ndarray:
        if (self._acc_buf is not None and not self._acc_out
                and self._acc_buf.size == n):
            self._acc_buf.fill(0.0)  # warm: reuse the resident segment
            self._acc_out = True
            return self._acc_buf
        if self._key is not None and not self._acc_out:
            # idle accumulator of the wrong size: hard-unlink it —
            # delete() would park it on the store's free list, which
            # alloc-with-explicit-key (our path) never consults, so the
            # parked segment would be stranded tmpfs until shutdown
            self._acc_buf = None
            self.store.destroy(self._key)
            self._key = None
        key, view = self.store.alloc((n,), np.float32, key=self._new_key())
        view.fill(0.0)
        self.buffer_allocs += 1
        self._key = key
        self._acc_buf = view
        self._acc_out = True
        return view

    @property
    def key(self) -> Optional[str]:
        return self._key

    def publish(self) -> str:
        """Seal + disown the accumulator object; returns its key.

        Zero-copy hand-off: the buffer the folds targeted becomes the
        published partial.  The engine surrenders it — the next
        ``begin`` allocates a fresh segment."""
        assert self._key is not None, "publish() before begin()"
        key = self._key
        self.store.seal(key)
        self.store.disown(key)
        self._key = None
        self._acc_buf = None
        self._acc_out = False
        return key
