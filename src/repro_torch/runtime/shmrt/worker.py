"""Aggregator worker process: the step-based function body (App-G).

One worker = one homogenized aggregator runtime, parked warm between
tasks.  The loop is strictly event-driven: blocked on the task ring's
doorbell while idle (no polling), woken per record:

  TASK     — open an aggregation task: a FedAvgState over the
             shared-memory accumulator engine (scratch stays warm from
             the previous task; this is what makes warm dispatch cheap).
  UPDATE   — Recv∥Agg: drain the ring in K-way bursts and fold through
             the engine, reading payloads zero-copy out of the store;
             when the goal is met the partial sum is published
             (seal+disown, no copy) and a PARTIAL record goes up.
  DRAIN    — close out a short task (stragglers): publish whatever has
             been folded so far.
  SHUTDOWN — graceful exit: surrender buffers, close the store.

The worker only ever touches numpy — no jax in the child (forking a
process with live XLA threads is not safe to re-enter).
"""
from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.aggregation import FedAvgState
from repro_torch.core.objectstore import SharedMemoryObjectStore
from repro_torch.runtime.shmrt.messages import Record, RecordKind
from repro_torch.runtime.shmrt.ring import SpscRing
from repro_torch.runtime.shmrt.shmengine import ShmAccumulatorEngine

IDLE_TIMEOUT_S = 30.0  # doorbell wait slice while parked


@dataclass
class _OpenTask:
    agg_tag: str
    seq: int
    round_id: int
    goal: int
    n_elems: int
    state: FedAvgState
    folded: int = 0
    exec_ns: int = 0
    wait_ns: int = 0  # blocked-on-ring time while this task was open


def worker_main(widx: int, task_ring: SpscRing, result_ring: SpscRing,
                store_prefix: str, batch_k: int = 8) -> None:
    """Entry point of a forked aggregator worker (never returns)."""
    store = SharedMemoryObjectStore(
        node=f"worker{widx}", prefix=store_prefix)
    # 'w' prefix: dispatcher-generated keys are pure hex, so the crash
    # sweep by this prefix can never match a live gateway object
    engine = ShmAccumulatorEngine(store, key_prefix=f"w{widx & 0xff:02x}")
    task: Optional[_OpenTask] = None

    def publish(t: _OpenTask) -> str:
        key = engine.publish()
        # telemetry rides the publish edge (event-driven: zero cost
        # while parked) and goes up FIRST — the PARTIAL closes the task
        # dispatcher-side, so anything after it loses its agg_id
        result_ring.push(Record(
            kind=RecordKind.TELEM, key=key, round_id=t.round_id,
            flags=t.seq, num_samples=t.wait_ns / 1e9,
            ts=time.perf_counter(), a=t.state.count,
        ).pack(), timeout=5.0)
        # a = updates folded end-to-end: equals t.folded for a mid,
        # and the subtree total for a root task absorbing partials
        result_ring.push(Record(
            kind=RecordKind.PARTIAL, key=key, round_id=t.round_id,
            flags=t.seq, num_samples=t.state.weight,
            ts=time.perf_counter(), a=t.state.count, b=t.exec_ns,
        ).pack(), timeout=5.0)
        return key

    def close_task(t: Optional[_OpenTask], published_key: Optional[str]
                   ) -> None:
        """Drop the task's references, then the disowned accumulator
        mapping: a warm worker must not pin unlinked segments across
        tasks (the dispatcher owns the published object now)."""
        if t is not None:
            t.state.acc = None  # free the view before closing the mmap
        if published_key is not None:
            store.detach(published_key)
        if t is not None and published_key is None:
            # task ended without publishing: hand the accumulator back
            # to the engine's warm buffer instead of leaking its segment
            engine.recycle()

    result_ring.push(Record(
        kind=RecordKind.READY, ts=time.perf_counter(), a=os.getpid(),
    ).pack(), timeout=5.0)

    parent = os.getppid()
    pending: deque = deque()  # control records found mid-burst
    while True:
        if pending:
            rec = pending.popleft()
        else:
            # with a task open, blocked-on-ring is starvation the
            # dispatcher should see (worker.wait); parked-idle is not
            t_wait = time.perf_counter_ns() if task is not None else 0
            raw = task_ring.pop(timeout=IDLE_TIMEOUT_S)
            if task is not None:
                task.wait_ns += time.perf_counter_ns() - t_wait
            if raw is None:
                if os.getppid() != parent:
                    # orphaned: the dispatcher died without sending
                    # SHUTDOWN (SIGKILLed daemon).  Exit through the
                    # normal path so atexit sweeps our segments —
                    # otherwise the orphan pins its inherited fds and
                    # /dev/shm mappings forever
                    break
                continue
            rec = Record.unpack(raw)

        if rec.kind == RecordKind.SHUTDOWN:
            break

        if rec.kind == RecordKind.TASK:
            if task is not None:
                # force-released upstream: close the stale task so its
                # accumulator is reused, not leaked
                close_task(task, None)
            # ACK first: dispatch latency is task-pickup, not the
            # accumulator allocation that follows
            result_ring.push(Record(
                kind=RecordKind.ACK, key=rec.key, flags=rec.flags,
                ts=time.perf_counter(),
            ).pack(), timeout=5.0)
            task = _OpenTask(
                agg_tag=rec.key, seq=rec.flags, round_id=rec.round_id,
                goal=max(int(rec.a), 1), n_elems=rec.b,
                state=FedAvgState(engine=engine),
            )
            task.state._ensure_acc(rec.b)
            continue

        if rec.kind == RecordKind.DRAIN:
            if task is not None and task.folded > 0:
                key = publish(task)
                close_task(task, key)
            elif task is not None:
                result_ring.push(Record(
                    kind=RecordKind.EMPTY, flags=task.seq,
                    round_id=task.round_id, ts=time.perf_counter(),
                ).pack(), timeout=5.0)
                close_task(task, None)
            task = None
            continue

        if rec.kind == RecordKind.PARTIAL_IN:
            # root fold: absorb a published raw partial Σ c·u straight
            # out of the store (zero-copy), in ring order — the
            # dispatcher delivers in plan order, so the fold sequence
            # is deterministic and bit-identical to the controller fold
            if task is None:
                result_ring.push(Record(
                    kind=RecordKind.ERROR, key=rec.key,
                ).pack(), timeout=5.0)
                continue
            t0 = time.perf_counter_ns()
            view = store.get(rec.key)
            task.state.absorb(np.asarray(view), rec.num_samples, int(rec.a))
            del view  # drop the view before detaching the mapping
            store.release(rec.key)
            store.detach(rec.key)  # the dispatcher owns the segment
            task.folded += 1
            task.exec_ns += time.perf_counter_ns() - t0
            if task.folded >= task.goal:
                key = publish(task)
                close_task(task, key)
                task = None
            continue

        if rec.kind == RecordKind.UPDATE:
            if task is None:
                result_ring.push(Record(
                    kind=RecordKind.ERROR, key=rec.key,
                ).pack(), timeout=5.0)
                continue
            # K-way burst: this update plus whatever else is queued
            batch = [rec]
            room = min(batch_k - 1, task.goal - task.folded - 1)
            while room > 0:
                raw = task_ring.pop()
                if raw is None:
                    break
                r = Record.unpack(raw)
                if r.kind != RecordKind.UPDATE:
                    pending.append(r)  # control record: handle after burst
                    break
                batch.append(r)
                room -= 1
            updates, weights = [], []
            t0 = time.perf_counter_ns()
            for r in batch:
                updates.append(store.get(r.key))
                weights.append(r.num_samples)
            task.state.fold_many(updates, weights)
            task.folded += len(updates)
            del updates  # drop the views before detaching the mappings
            for r in batch:
                store.release(r.key)
                store.detach(r.key)  # creator (gateway) owns the segment
            task.exec_ns += time.perf_counter_ns() - t0
            if task.folded >= task.goal:
                key = publish(task)
                close_task(task, key)
                task = None

    store.close()
