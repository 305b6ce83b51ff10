"""Shared-memory object store (paper §4.1) — the intra-node data plane.

Immutable, keyed objects in named POSIX shared-memory segments:
model updates are written once by the gateway and read zero-copy (numpy
views over the shared segment) by any aggregator process on the node.
Immutability removes locking (paper: "LIFL only allows immutable
(read-only) objects to guarantee safe sharing").

Object keys are 16-byte random strings, exactly as in Appendix-A.  Each
object lives in a *named* segment (``<prefix>-<key>``) carrying a
64-byte self-describing header (magic, dtype, shape), so any process on
the node can attach and map an object knowing only its key — this is
what lets the multi-process runtime (repro_torch.runtime.shmrt) move nothing
but 16-byte keys through its rings.

Crash safety: every segment created in this process is recorded in a
process-local registry and unlinked on ``close()``/interpreter exit, so
crashed tests don't leak ``/dev/shm`` segments.  Segments are mapped
straight from /dev/shm (no stdlib resource tracker — see
:class:`ShmSegment` for why), so attaching never perturbs the
creator's lifetime and SIGKILLed workers are reclaimed by the
dispatcher's name-prefix sweep.

The single-process variant (``InProcObjectStore``) backs unit tests and
the event-driven simulator without OS shared memory.
"""
from __future__ import annotations

import atexit
import mmap
import os
import secrets
import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

KEY_BYTES = 16

# -- object-segment header (64 bytes) ---------------------------------------
#    magic 8s | dtype 16s | ndim u32 | shape 4×u64 | pad
_HEADER_FMT = "<8s16sI4Q"
_HEADER_BYTES = 64
_MAGIC = b"LIFLOBJ1"
_MAX_NDIM = 4


def new_object_key() -> str:
    """16-byte random object key (App-A)."""
    return secrets.token_hex(KEY_BYTES // 2)


# ---------------------------------------------------------------------------
# process-local registry of created segments (leak-proofing)
# ---------------------------------------------------------------------------

_CREATED: Dict[str, "ShmSegment"] = {}
_CREATED_LOCK = threading.Lock()


def _registry_add(seg: "ShmSegment") -> None:
    with _CREATED_LOCK:
        _CREATED[seg.name] = seg


def _registry_discard(name: str) -> None:
    with _CREATED_LOCK:
        _CREATED.pop(name, None)


def cleanup_created_segments() -> int:
    """Unlink every segment this process created and hasn't deleted yet.
    Runs at interpreter exit; safe to call any time.  Returns the number
    of segments reclaimed."""
    with _CREATED_LOCK:
        pending = list(_CREATED.items())
        _CREATED.clear()
    n = 0
    for _, seg in pending:
        try:
            seg.unlink()
            n += 1
        except Exception:
            pass
        try:
            seg.close()
        except Exception:
            pass
    return n


atexit.register(cleanup_created_segments)


class ShmSegment:
    """POSIX shm segment mapped directly from /dev/shm, *bypassing* the
    stdlib resource tracker.

    ``shared_memory.SharedMemory`` registers every create **and attach**
    with the tracker: an attaching process's tracker then unlinks the
    segment when that process exits — yanking it out from under the
    creator (bpo-39959) — while un-registering instead corrupts the
    creator's entry whenever attacher and creator share a tracker (fork
    children do).  Mapping /dev/shm directly sidesteps the whole
    ledger: attachments have no lifetime side effects and creators keep
    sole unlink rights (enforced by the process-local registry +
    dispatcher crash reclaim instead).
    """

    __slots__ = ("name", "size", "_mmap", "buf")

    def __init__(self, name: str, *, create: bool = False, size: int = 0):
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        fd = os.open(f"/dev/shm/{name}", flags, 0o600)
        try:
            if create:
                os.ftruncate(fd, size)
            self.size = size if create else os.fstat(fd).st_size
            self._mmap = mmap.mmap(fd, self.size)
        except BaseException:
            os.close(fd)
            if create:
                try:
                    os.unlink(f"/dev/shm/{name}")
                except OSError:
                    pass
            raise
        os.close(fd)
        self.name = name
        self.buf = memoryview(self._mmap)

    def close(self) -> None:
        try:
            self.buf.release()
        except Exception:
            pass
        try:
            self._mmap.close()
        except BufferError:
            pass

    def unlink(self) -> None:
        try:
            os.unlink(f"/dev/shm/{self.name}")
        except FileNotFoundError:
            pass


def create_segment(name: str, size: int) -> ShmSegment:
    """Create+map a named segment (raises FileExistsError on collision).
    Tracked only by this process's atexit registry — see
    :class:`ShmSegment` for why the stdlib tracker is avoided."""
    seg = ShmSegment(name, create=True, size=size)
    _registry_add(seg)
    return seg


def attach_segment(name: str) -> ShmSegment:
    """Attach an existing segment WITHOUT adopting its lifetime.
    Raises FileNotFoundError if no such segment."""
    return ShmSegment(name)


def track_segment(seg) -> None:
    """Enroll a segment created outside the store (e.g. a ring) in this
    process's atexit cleanup registry."""
    _registry_add(seg)


def untrack_segment(name: str) -> None:
    _registry_discard(name)


def unlink_segment(name: str) -> bool:
    """Best-effort unlink of a named segment (crash cleanup).  Plain
    os.unlink — attaching first would fail on exactly the half-created
    segments (e.g. SIGKILL between open and ftruncate → 0-byte file,
    unmappable) that crash cleanup exists to reclaim."""
    try:
        os.unlink(f"/dev/shm/{name}")
    except OSError:
        return False
    return True


def sweep_dead_segments(prefix: str) -> int:
    """Unlink every /dev/shm segment under a dead owner's ``prefix``
    (objects ``prefix-<key>``, rings ``prefix-tq<i>``/``-rq<i>``).

    The reclaim path for SIGKILLed runtimes: atexit never ran, so the
    segments outlive the process until someone sweeps the name space —
    the controller on re-adoption (the welcome's epoch bump proves the
    old process, hence every one of its segments, is dead) and
    ``reap_local_daemon`` after a kill.  Prefixes embed a per-instance
    nonce, so a sweep can never hit a live runtime's segments.
    Returns the number of segments reclaimed."""
    if not prefix:
        return 0
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return 0
    swept = 0
    for name in names:
        if name == prefix or name.startswith(prefix + "-"):
            if unlink_segment(name):
                _registry_discard(name)
                swept += 1
    return swept


def _pack_header(shape, dtype) -> bytes:
    shape = tuple(int(s) for s in shape)
    if len(shape) > _MAX_NDIM:
        raise ValueError(f"object store supports ≤{_MAX_NDIM}-d arrays, "
                         f"got shape {shape}")
    dims = list(shape) + [0] * (_MAX_NDIM - len(shape))
    hdr = struct.pack(_HEADER_FMT, _MAGIC, str(np.dtype(dtype)).encode()[:16],
                      len(shape), *dims)
    return hdr + b"\0" * (_HEADER_BYTES - len(hdr))


def _unpack_header(buf) -> Tuple[Tuple[int, ...], np.dtype]:
    magic, dt, ndim, *shape = struct.unpack_from(_HEADER_FMT, buf, 0)
    if magic != _MAGIC:
        raise ValueError("segment is not a sealed LIFL object")
    dtype = np.dtype(dt.rstrip(b"\0").decode())
    return tuple(shape[:ndim]), dtype


@dataclass
class ObjectMeta:
    key: str
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    refcount: int = 0
    sealed: bool = False


class SharedMemoryObjectStore:
    """Per-node object store over POSIX shared memory.

    Lifecycle (managed by the LIFL agent, §4.1): allocate -> write ->
    seal (immutable) -> get (zero-copy views) -> release -> destroy when
    refcount drops and the object was recycled.

    Cross-process: every store instance with the same ``prefix`` on the
    node sees the same objects — ``get`` falls back to attaching the
    named segment when the key wasn't created locally.  Only the
    creating process unlinks.

    Recycling (the §4.1 "destroy when ... recycled" step): ``delete``
    parks up to ``recycle_limit`` same-process segments on a size-keyed
    free list instead of unlinking, and ``put`` reuses them — a
    long-lived gateway then writes updates into already-faulted tmpfs
    pages (memcpy speed) instead of paying the kernel's first-touch
    fault cost per round (~10× on this host, see ROADMAP).  A recycled
    object keeps its segment *and key*: the key is retired with the old
    object and reissued with the new one.
    """

    def __init__(self, node: str = "node0", capacity_bytes: int = 1 << 32,
                 prefix: str = "lifl", recycle_limit: int = 64):
        self.node = node
        self.prefix = prefix
        self.capacity_bytes = capacity_bytes
        self.recycle_limit = recycle_limit
        self._segments: Dict[str, ShmSegment] = {}  # created
        self._attached: Dict[str, ShmSegment] = {}
        self._meta: Dict[str, ObjectMeta] = {}
        self._free: Dict[int, list] = {}  # payload nbytes -> [(key, seg)]
        self._free_count = 0
        self._lock = threading.Lock()
        self.bytes_in_use = 0
        # stats (read by the metrics sidecar)
        self.stats = {"puts": 0, "gets": 0, "zero_copy_gets": 0,
                      "evictions": 0, "attaches": 0, "recycled": 0}

    # ------------------------------------------------------------------
    def segment_name(self, key: str) -> str:
        return f"{self.prefix}-{key}"

    def _create_segment(self, key: str, nbytes: int) -> ShmSegment:
        return create_segment(
            self.segment_name(key), _HEADER_BYTES + max(nbytes, 1))

    def _obtain(self, key: Optional[str], nbytes: int
                ) -> Tuple[str, ShmSegment]:
        """Free-listed segment of the right size if any (key is then the
        recycled one), else a fresh named segment.  Caller holds the
        lock."""
        if key is None:
            bucket = self._free.get(nbytes)
            if bucket:
                rkey, seg = bucket.pop()
                self._free_count -= 1
                self.stats["recycled"] += 1
                return rkey, seg
            key = new_object_key()
        return key, self._create_segment(key, nbytes)

    # ------------------------------------------------------------------
    def put(self, array: np.ndarray, key: Optional[str] = None) -> str:
        """Serialize-once write; returns the object key."""
        arr = np.ascontiguousarray(array)
        with self._lock:
            if self.bytes_in_use + arr.nbytes > self.capacity_bytes:
                raise MemoryError(
                    f"object store over capacity on {self.node}: "
                    f"{self.bytes_in_use + arr.nbytes} > {self.capacity_bytes}"
                )
            key, seg = self._obtain(key, arr.nbytes)
            view = np.ndarray(arr.shape, arr.dtype, buffer=seg.buf,
                              offset=_HEADER_BYTES)
            view[...] = arr
            seg.buf[:_HEADER_BYTES] = _pack_header(arr.shape, arr.dtype)
            # ^ header written last: the object is sealed once it parses
            self._segments[key] = seg
            self._meta[key] = ObjectMeta(
                key=key, shape=arr.shape, dtype=str(arr.dtype),
                nbytes=arr.nbytes, sealed=True,
            )
            self.bytes_in_use += arr.nbytes
            self.stats["puts"] += 1
        return key

    # ------------------------------------------------------------------
    def alloc(self, shape, dtype=np.float32,
              key: Optional[str] = None) -> Tuple[str, np.ndarray]:
        """Allocate an *unsealed* object in place and return a writable
        view — the aggregation-engine path: an accumulator lives its
        whole life inside the store's shared memory, and ``seal`` later
        publishes it without a copy."""
        shape = tuple(int(s) for s in (
            shape if isinstance(shape, (tuple, list)) else (shape,)))
        dt = np.dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize if shape \
            else dt.itemsize
        with self._lock:
            if self.bytes_in_use + nbytes > self.capacity_bytes:
                raise MemoryError(f"object store over capacity on {self.node}")
            if key is None:
                key, seg = self._obtain(None, nbytes)  # free list eligible
            else:
                seg = self._create_segment(key, nbytes)
            self._segments[key] = seg
            self._meta[key] = ObjectMeta(
                key=key, shape=shape, dtype=str(dt),
                nbytes=nbytes, sealed=False,
            )
            self.bytes_in_use += nbytes
        view = np.ndarray(shape, dt, buffer=seg.buf, offset=_HEADER_BYTES)
        return key, view

    def seal(self, key: str) -> None:
        """Publish an ``alloc``'d object: write the header (readers poll
        the magic) and mark immutable.  Zero-copy — the accumulator the
        worker folded into *is* the published object."""
        with self._lock:
            meta = self._meta[key]
            seg = self._segments[key]
            seg.buf[:_HEADER_BYTES] = _pack_header(meta.shape, meta.dtype)
            meta.sealed = True
            self.stats["puts"] += 1

    def disown(self, key: str) -> None:
        """Relinquish cleanup responsibility for a segment this process
        created — the ownership-transfer half of publishing a partial
        aggregate: the worker seals + disowns, the dispatcher (which
        outlives the worker) becomes responsible for ``destroy``."""
        with self._lock:
            seg = self._segments.pop(key, None)
            if seg is None:
                return
            # demote to an attach-only mapping: this store will close it
            # but never unlink it — the adopter does that via destroy().
            # The bytes leave this store's books with the ownership.
            self._attached[key] = seg
            meta = self._meta.get(key)
            if meta is not None:
                self.bytes_in_use -= meta.nbytes
        _registry_discard(seg.name)

    def destroy(self, key: str) -> None:
        """Unlink the object's segment regardless of which process
        created it (the adopter's half of ``disown``)."""
        with self._lock:
            meta = self._meta.pop(key, None)
            owned = self._segments.pop(key, None)
            att = self._attached.pop(key, None)
        seg = owned or att
        name = seg.name if seg is not None else self.segment_name(key)
        if seg is not None:
            try:
                seg.close()
            except BufferError:
                pass
            _registry_discard(name)
        unlink_segment(name)  # best-effort: tolerate already-unlinked
        # only segments still on this store's books (created here and
        # not disowned) count against bytes_in_use; attach-only objects
        # were never counted
        if owned is not None and meta is not None:
            self.bytes_in_use -= meta.nbytes
            self.stats["evictions"] += 1

    # ------------------------------------------------------------------
    def get(self, key: str) -> np.ndarray:
        """Zero-copy read-only view of a sealed object.  Falls back to
        attaching the named segment for objects created by a peer
        process on the node."""
        with self._lock:
            seg = self._segments.get(key) or self._attached.get(key)
            meta = self._meta.get(key)
            if seg is None:
                seg = attach_segment(self.segment_name(key))
                self._attached[key] = seg
                self.stats["attaches"] += 1
            if meta is None:
                shape, dtype = _unpack_header(seg.buf)
                meta = ObjectMeta(
                    key=key, shape=shape, dtype=str(dtype),
                    nbytes=int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                    if shape else dtype.itemsize,
                    sealed=True,
                )
                self._meta[key] = meta
            meta.refcount += 1
            self.stats["gets"] += 1
            self.stats["zero_copy_gets"] += 1
        view = np.ndarray(meta.shape, np.dtype(meta.dtype), buffer=seg.buf,
                          offset=_HEADER_BYTES)
        view.flags.writeable = False
        return view

    def release(self, key: str) -> None:
        with self._lock:
            if key in self._meta:
                self._meta[key].refcount = max(0, self._meta[key].refcount - 1)

    def detach(self, key: str) -> None:
        """Drop a peer object's local mapping (the creator still owns the
        segment).  Call after the last view is dead — a live numpy view
        into a closed mapping segfaults."""
        with self._lock:
            seg = self._attached.pop(key, None)
            self._meta.pop(key, None) if seg is not None else None
        if seg is not None:
            try:
                seg.close()
            except BufferError:
                # a view still borrows the mmap: keep the mapping alive
                with self._lock:
                    self._attached[key] = seg

    def delete(self, key: str) -> None:
        with self._lock:
            meta = self._meta.pop(key, None)
            seg = self._segments.pop(key, None)
            att = self._attached.pop(key, None)
            if seg is not None and meta is not None and (
                    meta.refcount == 0
                    and self._free_count < self.recycle_limit):
                # refcount guard: a live get() view means the bytes are
                # still being read — recycling would rewrite them under
                # the reader, so those segments take the unlink path
                # (the mapping outlives the name)
                # park on the free list: the warm pages get rewritten by
                # a future put() of the same size (gateway steady state).
                # Clear the magic so a stale attach of the retired key
                # fails loudly instead of reading the next object.
                seg.buf[:8] = b"\0" * 8
                self._free.setdefault(meta.nbytes, []).append((key, seg))
                self._free_count += 1
                self.bytes_in_use -= meta.nbytes
                self.stats["evictions"] += 1
                seg = None  # keep the segment (and registry entry) alive
            if seg is not None:
                # unlink first: frees the name even if a live numpy view
                # still pins the mapping (memory reclaimed when the last
                # map dies)
                try:
                    seg.unlink()
                except FileNotFoundError:
                    pass
                try:
                    seg.close()
                except BufferError:
                    pass
                _registry_discard(seg.name)
            if att is not None:
                try:
                    att.close()
                except BufferError:
                    pass
            if meta is not None and seg is not None:
                self.bytes_in_use -= meta.nbytes
                self.stats["evictions"] += 1

    def contains(self, key: str) -> bool:
        with self._lock:
            if key in self._meta:
                return True
        try:
            seg = attach_segment(self.segment_name(key))
        except FileNotFoundError:
            return False
        with self._lock:
            self._attached[key] = seg
        return True

    def meta(self, key: str) -> ObjectMeta:
        with self._lock:
            m = self._meta.get(key)
        if m is None:
            self.get(key)  # attach + header parse
            self.release(key)
            with self._lock:
                m = self._meta[key]
        return m

    def close(self) -> None:
        with self._lock:
            free_segs = [seg for bucket in self._free.values()
                         for _, seg in bucket]
            for seg in list(self._segments.values()) + free_segs:
                try:
                    seg.unlink()
                except FileNotFoundError:
                    pass
                try:
                    seg.close()
                except BufferError:
                    pass
                _registry_discard(seg.name)
            for seg in self._attached.values():
                try:
                    seg.close()
                except BufferError:
                    pass
            self._segments.clear()
            self._attached.clear()
            self._meta.clear()
            self._free.clear()
            self._free_count = 0
            self.bytes_in_use = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class InProcObjectStore:
    """Same interface, plain-dict backing (tests / simulator)."""

    def __init__(self, node: str = "node0", capacity_bytes: int = 1 << 34):
        self.node = node
        self.capacity_bytes = capacity_bytes
        self._objs: Dict[str, np.ndarray] = {}
        self.bytes_in_use = 0
        self.stats = {"puts": 0, "gets": 0, "zero_copy_gets": 0, "evictions": 0}

    def put(self, array: np.ndarray, key: Optional[str] = None) -> str:
        key = key or new_object_key()
        arr = np.ascontiguousarray(array)
        if self.bytes_in_use + arr.nbytes > self.capacity_bytes:
            raise MemoryError(f"object store over capacity on {self.node}")
        arr = arr.copy()
        arr.flags.writeable = False  # immutable objects (paper §4.1)
        self._objs[key] = arr
        self.bytes_in_use += arr.nbytes
        self.stats["puts"] += 1
        return key

    def get(self, key: str) -> np.ndarray:
        self.stats["gets"] += 1
        self.stats["zero_copy_gets"] += 1
        return self._objs[key]

    def release(self, key: str) -> None:
        pass

    def delete(self, key: str) -> None:
        arr = self._objs.pop(key, None)
        if arr is not None:
            self.bytes_in_use -= arr.nbytes
            self.stats["evictions"] += 1

    def contains(self, key: str) -> bool:
        return key in self._objs

    def meta(self, key: str) -> ObjectMeta:
        arr = self._objs[key]
        return ObjectMeta(
            key=key, shape=arr.shape, dtype=str(arr.dtype),
            nbytes=arr.nbytes, sealed=True,
        )

    def close(self) -> None:
        self._objs.clear()
        self.bytes_in_use = 0
