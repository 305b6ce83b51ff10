"""Pluggable aggregation engines — the fold hot loop, made swappable.

LIFL's aggregation throughput is bounded by memory movement, not compute:
the shared-memory object store exists so each update element is touched
once.  All backends implement one interface (fold one update, fold a
K-way burst, merge a partial aggregate) and are exercised by the same
``Aggregator`` pipeline:

  * ``naive``   — a full-size ``update.astype(f32) * w`` temporary, then
    ``acc += tmp``: the measurable baseline.
  * ``blocked`` — cache-tiled numpy with preallocated scratch: zero
    per-fold allocation, one read pass over the store's view.
  * ``torch``   — :class:`TorchEngine`: a device-resident fp32
    accumulator folded by the ``kernels/fedavg`` CUDA kernels
    (``eager_accumulate`` for one update, ``fedavg_accumulate_k`` for a
    K-way burst); on a CPU device the same calls run the kernels' plain
    PyTorch versions.  ``auto`` resolves to it.

Engines own their buffers (accumulator, scratch, staging slabs) and are
*warm-reusable*: a warm aggregator re-enters a round with its buffers
already resident (``buffer_allocs`` stays flat).  One engine serves one
aggregator at a time: ``begin()`` hands out the single cached
accumulator.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bf16 import is_bf16, widen_bf16
from repro_torch.device import host_like, resolve_device
from repro_torch.kernels.fedavg import eager_accumulate, fedavg_accumulate_k

# Cache-sized tile: 64 Ki f32 = 256 KiB — acc block + update block +
# scratch fit in L2 so the scratch round-trip never touches DRAM.
BLOCK_ELEMS = 64 * 1024

ENGINE_NAMES = ("naive", "blocked", "torch")

# one-shot block-size autotune, cached per process AND per probe
# arguments (the cache hierarchy doesn't change under us; re-probing
# every engine build would put a measurement in every cold start — but
# a caller constraining the candidate set must not get another probe's
# answer)
_AUTOTUNE_CANDIDATES = (16 * 1024, 32 * 1024, 64 * 1024, 128 * 1024,
                        256 * 1024)
_AUTOTUNE_CACHE: Dict[Tuple, int] = {}


def autotune_block_elems(
    candidates: Sequence[int] = _AUTOTUNE_CANDIDATES,
    n_elems: int = 1 << 21,
    repeats: int = 3,
) -> int:
    """Pick the blocked-engine tile size from measured fold throughput.

    One-shot probe at engine init (``EngineConfig(block="auto")`` /
    ``BlockedNumpyEngine(block_elems="auto")``): folds an 8 MB synthetic
    update through each candidate tile and keeps the fastest — the
    empirical answer to where this machine's cache/NUMA sweet spot is,
    instead of the hardcoded 64 Ki guess.  Cached per process, keyed by
    the probe arguments."""
    cache_key = (tuple(int(c) for c in candidates), int(n_elems),
                 int(repeats))
    cached = _AUTOTUNE_CACHE.get(cache_key)
    if cached is not None:
        return cached
    rng = np.random.default_rng(0)
    update = rng.standard_normal(n_elems).astype(np.float32)
    best: Tuple[float, int] = (-1.0, int(candidates[0]))
    for blk in candidates:
        eng = BlockedNumpyEngine(block_elems=int(blk))
        acc = eng.begin(n_elems)
        eng.fold(acc, update, 1.0)          # fault + warm the buffers
        t0 = time.perf_counter()
        for _ in range(repeats):
            eng.fold(acc, update, 1.0)
        dt = (time.perf_counter() - t0) / repeats
        gbs = update.nbytes / max(dt, 1e-9)
        if gbs > best[0]:
            best = (gbs, int(blk))
    _AUTOTUNE_CACHE[cache_key] = best[1]
    return best[1]


@dataclass(frozen=True)
class EngineConfig:
    """Declarative engine spec accepted by :func:`make_engine`.

    ``block`` applies to the blocked engine: an explicit element count,
    or ``"auto"`` to run the one-shot throughput probe
    (:func:`autotune_block_elems`, cached per process).  ``device``
    places the torch engine (``"auto"`` / ``"torch"``); None is the
    card."""

    name: str = "blocked"
    block: Any = None        # None | int | "auto"
    device: Optional[str] = None   # the torch engine's device

    def resolve_block(self) -> Optional[int]:
        if self.block is None:
            return None
        if self.block == "auto":
            return autotune_block_elems()
        return int(self.block)


class AggregationEngine:
    """Folds weighted updates into an fp32 accumulator it owns.

    Stateless w.r.t. the running (Σ c·w, Σ c) pair — ``FedAvgState``
    owns that — stateful w.r.t. preallocated buffers, which survive
    across folds and (via the warm pool) across aggregator lifetimes.
    """

    name = "base"

    def __init__(self) -> None:
        self.fold_calls = 0
        self.elements_folded = 0
        self.buffer_allocs = 0

    # -- accumulator lifecycle -----------------------------------------
    def begin(self, n: int) -> Any:
        """Zeroed length-``n`` accumulator (reuses the warm buffer)."""
        raise NotImplementedError

    def fold(self, acc: Any, update: np.ndarray, w: float) -> Any:
        """acc += w·u for one update; returns the (possibly new) handle."""
        raise NotImplementedError

    def fold_many(self, acc: Any, updates: Sequence[np.ndarray],
                  weights: Sequence[float]) -> Any:
        """K-way burst fold — one logical read of the accumulator."""
        for u, w in zip(updates, weights):
            acc = self.fold(acc, u, w)
        return acc

    def add_partial(self, acc: Any, partial: np.ndarray) -> Any:
        """acc += partial (hierarchy merge of two running sums)."""
        raise NotImplementedError

    def recycle(self, acc: Any = None) -> None:
        """Return the accumulator to the warm buffer pool (no-op for
        engines that allocate per round)."""

    def sync(self, acc: Any) -> None:
        """Block until pending folds on ``acc`` have executed — numpy
        engines are synchronous (no-op); the torch engine launches
        asynchronously on the card, so timing a fold without this
        measures only the launch."""

    def to_numpy(self, acc: Any) -> np.ndarray:
        return np.asarray(acc)

    def _count(self, k: int, n: int) -> None:
        self.fold_calls += 1
        self.elements_folded += k * n


class NaiveEngine(AggregationEngine):
    """The seed's scalar path, verbatim — the measurable baseline."""

    name = "naive"

    def begin(self, n: int) -> np.ndarray:
        self.buffer_allocs += 1
        return np.zeros((n,), np.float32)

    def fold(self, acc: np.ndarray, update: np.ndarray, w: float) -> np.ndarray:
        self._count(1, update.size)
        u = widen_bf16(update) if is_bf16(update.dtype) \
            else update.astype(np.float32)
        contrib = u * np.float32(w)
        acc += contrib
        return acc

    def add_partial(self, acc: np.ndarray, partial: np.ndarray) -> np.ndarray:
        acc += np.asarray(partial, np.float32)
        return acc


class BlockedNumpyEngine(AggregationEngine):
    """Cache-tiled in-place fold: zero per-fold allocation, one pass."""

    name = "blocked"

    def __init__(self, block_elems: Any = BLOCK_ELEMS) -> None:
        super().__init__()
        if block_elems == "auto":
            block_elems = autotune_block_elems()
        self.block_elems = int(block_elems)
        self._acc_buf: Optional[np.ndarray] = None
        self._scratch: Optional[np.ndarray] = None
        self._acc_out = False  # the single cached acc is handed out

    # -- buffers --------------------------------------------------------
    def begin(self, n: int) -> np.ndarray:
        if self._acc_buf is not None and not self._acc_out:
            if self._acc_buf.size == n:
                self._acc_buf.fill(0.0)   # warm: reuse, no allocation
                self._acc_out = True
                return self._acc_buf
            self._acc_buf = None          # idle but wrong size: replace
        acc = np.zeros((n,), np.float32)
        self.buffer_allocs += 1
        if self._acc_buf is None:
            # adopt as the cached warm buffer; if the cached one is
            # still handed out, this is a one-off allocation instead —
            # the warm buffer stays tracked for its eventual recycle
            self._acc_buf = acc
            self._acc_out = True
        return acc

    def recycle(self, acc: Optional[np.ndarray] = None) -> None:
        """Return the accumulator to the warm pool.  Only call once the
        round is over — result() has copied out and no FedAvgState still
        folds into this handle (the next begin() re-zeros it)."""
        if acc is None or acc is self._acc_buf:
            self._acc_out = False

    def _scratch_for(self, n: int) -> np.ndarray:
        m = min(n, self.block_elems)
        if self._scratch is None or self._scratch.size < m:
            self._scratch = np.empty((m,), np.float32)
            self.buffer_allocs += 1
        return self._scratch

    # -- folds ----------------------------------------------------------
    def fold(self, acc: np.ndarray, update: np.ndarray, w: float) -> np.ndarray:
        return self.fold_many(acc, (update,), (w,))

    def fold_many(self, acc: np.ndarray, updates: Sequence[np.ndarray],
                  weights: Sequence[float]) -> np.ndarray:
        n = acc.size
        ws = [np.float32(w) for w in weights]
        scratch = self._scratch_for(n)
        blk = scratch.size
        for off in range(0, n, blk):
            end = min(off + blk, n)
            a = acc[off:end]
            s = scratch[: end - off]
            # acc block stays cache-resident across all K rows: the
            # burst costs one DRAM read of the accumulator, not K
            for u, w in zip(updates, ws):
                ub = u[off:end]
                if ub.dtype == np.float32:
                    np.multiply(ub, w, out=s, casting="unsafe")
                elif is_bf16(ub.dtype):
                    # bf16 words (no numpy bf16): widened exactly into
                    # the f32 scratch, as ml_dtypes' cast does
                    widen_bf16(ub, out=s)
                    np.multiply(s, w, out=s)
                else:
                    # dtype-preserving fold: the wire update stays in
                    # its reduced dtype (bf16/f16 — half the DRAM read);
                    # upcast happens block-wise into the f32 scratch, so
                    # accumulation precision is still full f32
                    np.copyto(s, ub, casting="unsafe")
                    np.multiply(s, w, out=s)
                np.add(a, s, out=a, casting="unsafe")
        self._count(len(ws), n)
        return acc

    def add_partial(self, acc: np.ndarray, partial: np.ndarray) -> np.ndarray:
        np.add(acc, partial, out=acc, casting="unsafe")
        return acc


class _Staging:
    """One wire dtype's staging: a host slab (pinned when the engine is
    on the card) that the store's numpy views are copied into, and its
    device twin that the kernels read.  ``copied`` is recorded on the
    stream after each host-to-device copy; the next fill waits on it
    before it overwrites the host slab, whatever the caller syncs."""

    def __init__(self, rows: int, n: int, wire: str, device) -> None:
        storage = _WIRE_STORAGE[wire]
        on_card = device.type == "cuda"
        self.wire = wire
        self.host = torch.empty((rows, n), dtype=storage,
                                pin_memory=on_card)
        self.host_np = self.host.numpy()
        self.w_host = torch.empty((rows,), dtype=torch.float32,
                                  pin_memory=on_card)
        if on_card:
            self.dev = torch.empty((rows, n), dtype=storage, device=device)
            self.w_dev = torch.empty((rows,), dtype=torch.float32,
                                     device=device)
            self.copied = torch.cuda.Event()
        else:
            self.dev, self.w_dev, self.copied = self.host, self.w_host, None
        self.device = device

    @property
    def rows(self) -> int:
        return self.host.shape[0]

    def fill(self, arrays: Sequence[np.ndarray],
             weights: Optional[Sequence[float]] = None):
        """-> ((k, n) wire-dtype rows, (k,) fp32 weights) on the device."""
        if self.copied is not None:
            self.copied.synchronize()   # the last copy has left the slab
        k = len(arrays)
        for i, a in enumerate(arrays):          # row fill, no concat/stack
            np.copyto(self.host_np[i], _as_wire(a, self.wire),
                      casting="unsafe")
        if weights is not None:
            self.w_host.numpy()[:k] = np.asarray(weights, np.float32)
        if self.copied is not None:
            self.dev[:k].copy_(self.host[:k], non_blocking=True)
            if weights is not None:
                self.w_dev[:k].copy_(self.w_host[:k], non_blocking=True)
            self.copied.record(torch.cuda.current_stream(self.device))
        rows = self.dev[:k]
        if self.wire == "bf16":
            rows = rows.view(torch.bfloat16)
        return rows, self.w_dev[:k]


#: wire dtype -> the torch dtype of its staging slabs.  bf16 is staged
#: as raw 16-bit words: numpy has no bf16 of its own (the wire's
#: ``BF16_WORDS`` and the ml_dtypes type a caller may hand in are
#: recognised by ``is_bf16`` and viewed as int16).
_WIRE_STORAGE = {"f32": torch.float32, "f16": torch.float16,
                 "bf16": torch.int16}


def _wire_of(a: np.ndarray) -> str:
    if a.dtype == np.float16:
        return "f16"
    if is_bf16(a.dtype):
        return "bf16"
    return "f32"      # f32, and anything else staged (cast) through f32


def _as_wire(a: np.ndarray, wire: str) -> np.ndarray:
    if is_bf16(a.dtype):
        # the words as they are onto bf16 staging; widened exactly onto
        # f32 staging (a mixed burst), never cast as integers
        return a.view(np.int16) if wire == "bf16" else widen_bf16(a)
    return a


class TorchEngine(AggregationEngine):
    """Kernel-backed engine: ``eager_accumulate`` for single folds,
    ``fedavg_accumulate_k`` for bursts, into a device-resident fp32
    accumulator that is zeroed in place and reused across
    ``begin()`` / ``recycle()``.  Updates reach the device through one
    staging slab per wire dtype; bf16 and f16 bursts keep their dtype
    on the wire and accumulate in fp32.  On a CUDA device each fold
    launches its kernel or raises.

    ``to_numpy`` copies the accumulator to the host once per state of
    it: a publish asks twice (``FedAvgState.result`` and the runtime's
    ``_publish``) and gets the one copy, in pinned memory on the card.
    The kernels write through the data pointer (``ctypes``), which
    ``tensor._version`` does not see, so every writer here drops the
    cached copy itself; a dropped copy is never written again, so an
    array handed out stays as it was."""

    name = "torch"

    def __init__(self, device: Any = None) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self._staging: Dict[str, _Staging] = {}
        self._acc_buf: Optional[torch.Tensor] = None
        self._acc_out = False  # the single cached acc is handed out
        # (accumulator, its _version, host copy) of the last to_numpy
        self._host: Optional[Tuple[torch.Tensor, int, np.ndarray]] = None
        self.host_copies = 0        # device-to-host copies of an accumulator
        self.host_copy_s = 0.0      # their wall time, synchronised

    # -- buffers --------------------------------------------------------
    def begin(self, n: int) -> torch.Tensor:
        self._host = None
        if self._acc_buf is not None and not self._acc_out:
            if self._acc_buf.numel() == n:
                self._acc_buf.zero_()     # warm: reuse, no allocation
                self._acc_out = True
                return self._acc_buf
            self._acc_buf = None          # idle but wrong size: replace
        acc = torch.zeros((n,), dtype=torch.float32, device=self.device)
        self.buffer_allocs += 1
        if self._acc_buf is None:
            self._acc_buf = acc
            self._acc_out = True
        return acc

    def recycle(self, acc: Optional[torch.Tensor] = None) -> None:
        """Return the accumulator to the warm pool.  Only call once the
        round is over — result() has copied out (the next begin()
        re-zeros it)."""
        self._host = None
        if acc is None or acc is self._acc_buf:
            self._acc_out = False

    def _staging_for(self, wire: str, k: int, n: int) -> _Staging:
        """Rows grow to the largest burst seen: pinned host memory is
        slow to allocate and scarce, so none is reserved up front."""
        st = self._staging.get(wire)
        if st is None or st.rows < k or st.host.shape[1] != n:
            st = _Staging(k, n, wire, self.device)
            self._staging[wire] = st
            self.buffer_allocs += 1
        return st

    # -- folds ----------------------------------------------------------
    def fold(self, acc: torch.Tensor, update: np.ndarray,
             w: float) -> torch.Tensor:
        self._host = None
        self._count(1, update.size)
        st = self._staging_for(_wire_of(update), 1, update.size)
        rows, _ = st.fill([update])
        return eager_accumulate(acc, rows[0], np.float32(w))

    def fold_many(self, acc: torch.Tensor, updates: Sequence[np.ndarray],
                  weights: Sequence[float]) -> torch.Tensor:
        k = len(updates)
        if k == 1:
            return self.fold(acc, updates[0], weights[0])
        self._host = None
        n = acc.numel()
        # a homogeneous burst keeps its wire dtype end-to-end; a mixed
        # one stages through f32 (the common denominator)
        wires = {_wire_of(u) for u in updates}
        wire = wires.pop() if len(wires) == 1 else "f32"
        st = self._staging_for(wire, k, n)
        rows, ws = st.fill(updates, weights)
        self._count(k, n)
        return fedavg_accumulate_k(acc, rows, ws)

    def add_partial(self, acc: torch.Tensor,
                    partial: np.ndarray) -> torch.Tensor:
        self._host = None
        st = self._staging_for("f32", 1, acc.numel())
        rows, _ = st.fill([partial])
        return acc.add_(rows[0])

    def sync(self, acc: Any) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def to_numpy(self, acc: torch.Tensor) -> np.ndarray:
        """The accumulator on the host: one copy per state of it, into a
        buffer of its own (pinned on the card) that nothing here writes
        again, so a caller may keep it."""
        cached = self._host
        if cached is not None and cached[0] is acc \
                and cached[1] == acc._version:
            return cached[2]
        t0 = time.perf_counter()
        host = host_like(acc)
        host.copy_(acc)       # waits for the folds queued on the stream
        self.host_copies += 1
        self.host_copy_s += time.perf_counter() - t0
        arr = host.numpy()
        self._host = (acc, acc._version, arr)
        return arr


def _auto_name() -> str:
    """The engine ``make_engine("auto")`` builds: the torch engine."""
    return "torch"


def make_engine(spec: Any = "auto", **kwargs) -> AggregationEngine:
    """Resolve an engine spec: an instance passes through (how the warm
    pool hands a resident engine to a fresh Aggregator), a name builds
    one, an :class:`EngineConfig` carries options (``block="auto"``
    runs the one-shot tile autotune, ``device`` places the torch
    engine).  ``auto`` → the torch engine (on the card unless a device
    is given)."""
    if isinstance(spec, AggregationEngine):
        return spec
    if isinstance(spec, EngineConfig):
        name = spec.name or "auto"
        if name == "blocked":
            blk = spec.resolve_block()
            if blk is not None:
                kwargs.setdefault("block_elems", blk)
        if name in ("auto", "torch") and spec.device is not None:
            kwargs.setdefault("device", spec.device)
        return make_engine(name, **kwargs)
    name = spec or "auto"
    if name == "naive":
        return NaiveEngine()
    if name == "blocked":
        return BlockedNumpyEngine(**kwargs)
    if name in ("auto", "torch"):
        return TorchEngine(**kwargs)
    raise ValueError(f"unknown aggregation engine {spec!r} "
                     f"(expected one of {ENGINE_NAMES} or 'auto')")
