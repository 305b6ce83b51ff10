"""Frame transport — length-prefixed JSON + binary blob over sockets.

The multi-node control plane (netd ↔ RemoteRuntime, external clients ↔
``Session.serve``) speaks one frame format on TCP or Unix sockets::

    ┌─────────────┬─────────────┬───────────────┬──────────────┐
    │ json_len u32│ blob_len u32│  JSON body    │  blob bytes  │
    │  (big-end.) │  (big-end.) │  {"kind":...} │  (optional)  │
    └─────────────┴─────────────┴───────────────┴──────────────┘

Control fields ride the JSON body (``kind`` names the frame type; typed
round events are carried verbatim as ``events.to_wire`` dicts under
``kind="event"``); payloads — serialized-once model updates and sealed
partial sums — ride the blob, so a frame is decoded without ever
copying the payload through a JSON string.  Because ``kind`` belongs
to the codec, frame metas must not use it for their own fields (spawn
frames carry ``agg_kind`` instead).

Optional zlib compression (``FrameConn(compress=level)``): outbound
blobs ≥ :data:`COMPRESS_MIN_BYTES` are compressed when that actually
shrinks them — the ``_z`` meta key then carries the raw size, so any
receiver can decode without negotiation; incompressible blobs ship
raw.  ``tx_raw_by_kind``/``rx_raw_by_kind`` track pre-compression
frame sizes next to the wire counters, making the win measurable.

Failure model: every socket error, EOF, or handshake timeout surfaces
as :class:`PeerDead`; callers translate that into a ``NodeLost`` event
(see ``remote.py``).  ``connect`` retries until its deadline so a
controller can start before its daemons finish binding.  Byte counters
(total and per frame kind, both directions) make the wire cost of a
round directly measurable — ``benchmarks/bench_net.py`` gates on them.
"""
from __future__ import annotations

import json
import os
import random
import select
import socket
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.bf16 import BF16_WORDS

_HEADER = struct.Struct("!II")
#: sanity bounds: a corrupt/foreign header must not trigger a GB recv
MAX_JSON_BYTES = 1 << 22
MAX_BLOB_BYTES = 1 << 31
_RECV_CHUNK = 1 << 16
#: blobs below this never compress (zlib overhead dominates tiny frames)
COMPRESS_MIN_BYTES = 512


class PeerDead(ConnectionError):
    """The remote end of a frame connection is unreachable (EOF, reset,
    refused, or a hard send/handshake timeout)."""


class Backoff:
    """Jittered exponential backoff — the one retry schedule every
    redial in this package uses (``connect``, netd's peer redials, the
    ``push_update`` client helper, RemoteRuntime's re-adoption probe).

    Delays grow ``base · factor^k`` up to ``cap``, each scaled by a
    uniform jitter in ``[1-jitter, 1+jitter]`` so a fleet of retriers
    never thunders in lockstep.  Deterministic under ``seed`` (tests
    pin schedules); an unseeded instance draws from the process RNG.
    ``deadline_s`` bounds the TOTAL time budget: ``next_delay`` returns
    ``None`` (and ``sleep`` returns ``False``) once sleeping again
    would overrun it, and the last delay is clipped to the remainder.
    """

    def __init__(self, base: float = 0.05, factor: float = 2.0,
                 cap: float = 2.0, jitter: float = 0.25,
                 deadline_s: Optional[float] = None,
                 seed: Optional[int] = None):
        if base <= 0 or factor < 1.0 or not (0.0 <= jitter < 1.0):
            raise ValueError(
                f"bad backoff policy (base={base}, factor={factor}, "
                f"jitter={jitter})")
        self.base = float(base)
        self.factor = float(factor)
        self.cap = float(cap)
        self.jitter = float(jitter)
        self.deadline_s = deadline_s
        self._rng = random.Random(seed)
        self._attempt = 0
        self._raw = self.base               # grown by factor, capped
        self._deadline: Optional[float] = None  # armed at first use

    def _arm(self) -> None:
        if self.deadline_s is not None and self._deadline is None:
            self._deadline = time.perf_counter() + self.deadline_s

    @property
    def attempt(self) -> int:
        """Delays handed out so far."""
        return self._attempt

    def remaining(self) -> Optional[float]:
        """Seconds left in the budget (``None`` = unbounded)."""
        self._arm()
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.perf_counter())

    def next_delay(self) -> Optional[float]:
        """The next delay in seconds, or ``None`` when the deadline
        budget is exhausted."""
        self._arm()
        # incremental growth, clamped at the cap — never an overflowing
        # factor**attempt, however long the schedule runs
        raw = min(self.cap, self._raw)
        self._raw = min(self.cap, self._raw * self.factor)
        delay = raw * (1.0 + self.jitter * (2.0 * self._rng.random() - 1.0))
        if self._deadline is not None:
            left = self._deadline - time.perf_counter()
            if left <= 0:
                return None
            delay = min(delay, left)
        self._attempt += 1
        return delay

    def sleep(self) -> bool:
        """Sleep the next delay; ``False`` once the budget is gone (the
        caller's cue to give up and surface the failure)."""
        delay = self.next_delay()
        if delay is None:
            return False
        time.sleep(delay)
        return True

    def hint_delay(self, hint_s: float) -> Optional[float]:
        """A server-supplied pacing hint (a ``busy`` reply's
        ``retry_after_s``): jittered and deadline-clipped like a
        scheduled delay, counted as an attempt, but the exponential
        schedule does NOT advance — backpressure is the server pacing
        the client, not a failure to punish."""
        self._arm()
        delay = max(0.0, float(hint_s)) * (
            1.0 + self.jitter * (2.0 * self._rng.random() - 1.0))
        if self._deadline is not None:
            left = self._deadline - time.perf_counter()
            if left <= 0:
                return None
            delay = min(delay, left)
        self._attempt += 1
        return delay

    def sleep_hint(self, hint_s: float) -> bool:
        """Sleep a server-supplied ``retry_after_s`` hint; ``False``
        once the deadline budget is gone."""
        delay = self.hint_delay(hint_s)
        if delay is None:
            return False
        time.sleep(delay)
        return True

    def __iter__(self) -> Iterator[float]:
        """Yield the schedule (for tests / non-sleeping pacers); ends
        when the deadline budget does, never for an unbounded policy."""
        while True:
            delay = self.next_delay()
            if delay is None:
                return
            yield delay


def resolve_dtype(name: str) -> np.dtype:
    """``np.dtype`` by name.  numpy has no bfloat16 and the port never
    imports ``ml_dtypes``: a bf16 payload decodes to ``BF16_WORDS``,
    its raw 16-bit words, which the port's engines and ingress
    recognise (``repro_torch.bf16``) and no numpy arithmetic accepts.
    Other extended dtypes (fp8) are refused with numpy's
    ``TypeError``."""
    if name == "bfloat16":
        return BF16_WORDS
    return np.dtype(name)


def parse_addr(addr: str) -> Tuple[int, object]:
    """``"host:port"`` → TCP, ``"unix:/path"`` → AF_UNIX."""
    if addr.startswith("unix:"):
        return socket.AF_UNIX, addr[len("unix:"):]
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad address {addr!r} "
                         "(expected 'host:port' or 'unix:/path')")
    return socket.AF_INET, (host, int(port))


def format_addr(family: int, sockaddr) -> str:
    if family == socket.AF_UNIX:
        return f"unix:{sockaddr}"
    host, port = sockaddr[:2]
    return f"{host}:{port}"


@dataclass
class Frame:
    """One decoded frame: ``kind`` + JSON meta + optional payload."""

    kind: str
    meta: Dict
    blob: bytes = b""


class FrameConn:
    """One frame connection over a connected socket.

    ``recv`` is an incremental parser (partial frames survive across
    calls); ``send`` is a blocking write with a hard timeout.  Both
    raise :class:`PeerDead` on any transport failure, after which the
    connection is closed and unusable."""

    def __init__(self, sock: socket.socket, peer: str = "?",
                 send_timeout: float = 30.0, compress: Any = 0,
                 faults: Any = None, metrics: Any = None):
        sock.setblocking(True)
        try:  # latency matters more than throughput for 64-byte frames
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # AF_UNIX
        self._sock: Optional[socket.socket] = sock
        self.peer = peer
        self.send_timeout = send_timeout
        # zlib level for outbound blobs (0 = off).  Sender-only choice:
        # the `_z` meta marker makes every receiver able to decode, so
        # no negotiation is needed.  Incompressible blobs fall back to
        # raw (the marker is only set when compression actually won).
        self.compress = 6 if compress is True else int(compress or 0)
        # deterministic fault injection (faults.FaultPlan): consulted on
        # every outbound frame; None (production) costs one attr check
        self.faults = faults
        # optional core.sidecar.MetricsMap: when set, every outbound
        # frame lands a per-kind serialize+compress+write timing sample
        # (owner "wire") — the SKMSG-hook analogue of the obs layer,
        # fired only on the send edge; None costs one attr check
        self.metrics = metrics
        self._rbuf = bytearray()
        self.tx_bytes = 0
        self.rx_bytes = 0
        self.tx_by_kind: Dict[str, int] = {}
        self.rx_by_kind: Dict[str, int] = {}
        # pre-compression ("raw") frame sizes, per kind, both ways —
        # wire minus raw is the measured compression win
        self.tx_raw_by_kind: Dict[str, int] = {}
        self.rx_raw_by_kind: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def fileno(self) -> int:
        return self._sock.fileno() if self._sock is not None else -1

    @property
    def alive(self) -> bool:
        return self._sock is not None

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _dead(self, why: str) -> PeerDead:
        self.close()
        return PeerDead(f"peer {self.peer} gone: {why}")

    # ------------------------------------------------------------------
    def send(self, kind: str, meta: Optional[Dict] = None,
             blob: bytes = b"") -> None:
        """Write one frame (header + JSON + blob, single syscall path).
        ``blob`` may be any buffer (bytes, memoryview, C-contiguous
        numpy array) — it is never copied into the JSON body."""
        if self._sock is None:
            raise PeerDead(f"peer {self.peer} gone: already closed")
        if self.faults is not None:
            action, delay = self.faults.on_send(kind, len(memoryview(
                blob).cast("B")) if not isinstance(blob, bytes) else
                len(blob))
            if action == "drop":
                return  # the frame never reaches the wire
            if action == "reset":
                raise self._dead("fault-injected reset")
            if action == "delay":
                time.sleep(delay)
        t_send = time.perf_counter() if self.metrics is not None else 0.0
        body = dict(meta or {})
        body["kind"] = kind
        mv = memoryview(blob).cast("B") if not isinstance(blob, bytes) \
            else blob
        raw_blob = len(mv)
        if self.compress and raw_blob >= COMPRESS_MIN_BYTES:
            comp = zlib.compress(mv, self.compress)  # buffer proto: no copy
            if len(comp) < raw_blob:
                body["_z"] = raw_blob   # marker + uncompressed size
                mv = comp
        js = json.dumps(body, separators=(",", ":")).encode("utf-8")
        head = _HEADER.pack(len(js), len(mv))
        n = len(head) + len(js) + len(mv)
        # one gathered write per frame: header+meta+blob leave as a
        # single sendmsg, so a frame costs one syscall and one skb —
        # three separate sendalls triple the kernel's per-skb buffer
        # accounting and can wedge a burst of small frames against an
        # unread peer long before the nominal SO_SNDBUF is full
        bufs: List[memoryview] = [memoryview(head), memoryview(js)]
        if len(mv):
            bufs.append(mv if isinstance(mv, memoryview)
                        else memoryview(mv))
        try:
            self._sock.settimeout(self.send_timeout)
            while bufs:
                sent = self._sock.sendmsg(bufs)
                while sent:
                    if sent >= len(bufs[0]):
                        sent -= len(bufs[0])
                        bufs.pop(0)
                    else:
                        bufs[0] = bufs[0][sent:]
                        sent = 0
        except (OSError, ValueError) as e:
            raise self._dead(f"send failed ({e})") from e
        self.tx_bytes += n
        self.tx_by_kind[kind] = self.tx_by_kind.get(kind, 0) + n
        raw_n = len(head) + len(js) + raw_blob
        self.tx_raw_by_kind[kind] = self.tx_raw_by_kind.get(kind, 0) + raw_n
        if self.metrics is not None:
            self.metrics.update("wire", f"tx_{kind}_s",
                                time.perf_counter() - t_send)
            self.metrics.update("wire", f"tx_{kind}_bytes", float(n))

    # ------------------------------------------------------------------
    def _parse_one(self) -> Optional[Frame]:
        buf = self._rbuf
        if len(buf) < _HEADER.size:
            return None
        jlen, blen = _HEADER.unpack_from(buf, 0)
        if jlen > MAX_JSON_BYTES or blen > MAX_BLOB_BYTES:
            raise self._dead(f"oversized frame header ({jlen}/{blen})")
        total = _HEADER.size + jlen + blen
        if len(buf) < total:
            return None
        meta = json.loads(bytes(buf[_HEADER.size:_HEADER.size + jlen]))
        blob = bytes(buf[_HEADER.size + jlen:total])
        del buf[:total]
        kind = meta.pop("kind", "?")
        self.rx_by_kind[kind] = self.rx_by_kind.get(kind, 0) + total
        raw_total = total
        z = meta.pop("_z", None)
        if z is not None:
            z = int(z)
            if z > MAX_BLOB_BYTES:
                raise self._dead(f"oversized compressed blob ({z})")
            try:
                # bound the EXPANSION, not just the declared size — a
                # frame lying about _z must not decompress to GBs
                d = zlib.decompressobj()
                blob = d.decompress(blob, z)
                if d.unconsumed_tail or not d.eof or len(blob) != z:
                    raise self._dead("compressed blob size mismatch")
            except zlib.error as e:
                raise self._dead(f"corrupt compressed blob ({e})") from e
            raw_total = _HEADER.size + jlen + len(blob)
        self.rx_raw_by_kind[kind] = \
            self.rx_raw_by_kind.get(kind, 0) + raw_total
        return Frame(kind=kind, meta=meta, blob=blob)

    def recv(self, timeout: float = 0.0) -> Optional[Frame]:
        """Next frame, or ``None`` if nothing complete arrives within
        ``timeout``.  Raises :class:`PeerDead` on EOF/reset."""
        deadline = time.perf_counter() + timeout
        while True:
            frame = self._parse_one()
            if frame is not None:
                return frame
            if self._sock is None:
                raise PeerDead(f"peer {self.peer} gone: already closed")
            left = deadline - time.perf_counter()
            r, _, _ = select.select([self._sock], [], [], max(0.0, left))
            if not r:
                return None
            try:
                data = self._sock.recv(_RECV_CHUNK)
            except OSError as e:
                raise self._dead(f"recv failed ({e})") from e
            if not data:
                raise self._dead("EOF")
            self._rbuf += data
            self.rx_bytes += len(data)

    def recv_expect(self, kinds: Tuple[str, ...], timeout: float,
                    stash: Optional[List[Frame]] = None) -> Frame:
        """Read until a frame of one of ``kinds`` arrives; unrelated
        frames (event pushes racing a reply) go to ``stash``."""
        deadline = time.perf_counter() + timeout
        while True:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise self._dead(f"timed out waiting for {kinds}")
            frame = self.recv(timeout=left)
            if frame is None:
                continue
            if frame.kind in kinds:
                return frame
            if stash is not None:
                stash.append(frame)

    # ------------------------------------------------------------------
    def ping(self, timeout: float = 5.0,
             stash: Optional[List[Frame]] = None) -> float:
        """Liveness probe: round-trip one ``ping`` frame, returns the
        RTT in seconds (raises :class:`PeerDead` on a dead peer)."""
        t0 = time.perf_counter()
        self.send("ping", {"t": t0})
        self.recv_expect(("pong",), timeout, stash=stash)
        rtt = time.perf_counter() - t0
        if self.metrics is not None:
            observe = getattr(self.metrics, "observe", None)
            if observe is not None:
                observe("wire", "rtt_s", rtt)
        return rtt


class FrameServer:
    """Non-blocking accept loop + frame demux over all connections.

    ``poll`` returns ``(conn, frame)`` pairs; a dying connection yields
    one final ``(conn, None)`` so the owner can unregister it."""

    def __init__(self, addr: str, backlog: int = 16, faults: Any = None,
                 metrics: Any = None):
        family, sockaddr = parse_addr(addr)
        self._family = family
        self.faults = faults   # inherited by every accepted FrameConn
        self.metrics = metrics  # likewise (per-kind tx timings)
        sock = socket.socket(family, socket.SOCK_STREAM)
        if family == socket.AF_INET:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(sockaddr)
        sock.listen(backlog)
        sock.setblocking(False)
        self._listener = sock
        self._unix_path = sockaddr if family == socket.AF_UNIX else None
        self.addr = format_addr(family, sock.getsockname())
        self.conns: List[FrameConn] = []

    def poll(self, timeout: float = 0.0) -> List[Tuple[FrameConn,
                                                       Optional[Frame]]]:
        out: List[Tuple[FrameConn, Optional[Frame]]] = []
        for conn in list(self.conns):
            if not conn.alive:
                # died on the SEND path (a push hit PeerDead): emit the
                # (conn, None) notification recv-side deaths get, so
                # owners run their disconnect cleanup either way
                self.conns.remove(conn)
                out.append((conn, None))
                continue
            # frames already buffered from a previous read: no select
            self._pump(conn, out, readable=False)
        watch = [self._listener] + [c for c in self.conns if c.alive]
        r, _, _ = select.select(watch, [], [], 0.0 if out else timeout)
        for sock in r:
            if sock is self._listener:
                try:
                    raw, peer_addr = self._listener.accept()
                except OSError:
                    continue
                peer = format_addr(self._family, peer_addr) \
                    if self._family == socket.AF_INET else "unix-peer"
                self.conns.append(FrameConn(raw, peer=peer,
                                            faults=self.faults,
                                            metrics=self.metrics))
            else:
                self._pump(sock, out, readable=True)
        return out

    def _pump(self, conn: FrameConn, out, *, readable: bool) -> None:
        try:
            while True:
                frame = conn.recv(timeout=0.0) if readable \
                    else conn._parse_one()
                if frame is None:
                    return
                out.append((conn, frame))
                readable = False  # drain what's buffered, don't re-select
        except PeerDead:
            if conn in self.conns:
                self.conns.remove(conn)
            out.append((conn, None))

    def close(self) -> None:
        for conn in self.conns:
            conn.close()
        self.conns.clear()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._unix_path:
            try:
                os.unlink(self._unix_path)
            except OSError:
                pass


def connect(addr: str, *, timeout: float = 10.0,
            retry_interval: float = 0.05, peer: Optional[str] = None,
            compress: Any = 0, faults: Any = None,
            backoff: Optional[Backoff] = None,
            metrics: Any = None) -> FrameConn:
    """Connect to a frame server, retrying until ``timeout`` — a
    controller may race its daemons' bind.  Retries follow the shared
    jittered-exponential :class:`Backoff` schedule (``retry_interval``
    is its base; ``timeout`` its total deadline), so a refused port is
    probed densely at first and gently once it looks genuinely down."""
    family, sockaddr = parse_addr(addr)
    bo = backoff if backoff is not None else Backoff(
        base=retry_interval, cap=max(retry_interval, 0.5),
        deadline_s=timeout)
    deadline = time.perf_counter() + timeout
    while True:
        sock = socket.socket(family, socket.SOCK_STREAM)
        try:
            sock.settimeout(max(0.1, deadline - time.perf_counter()))
            sock.connect(sockaddr)
            return FrameConn(sock, peer=peer or addr, compress=compress,
                             faults=faults, metrics=metrics)
        except (ConnectionError, FileNotFoundError, socket.timeout,
                OSError) as e:
            sock.close()
            if not bo.sleep():
                raise PeerDead(f"connect to {addr} failed: {e}") from e
