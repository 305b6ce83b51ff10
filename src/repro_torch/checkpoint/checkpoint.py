"""Checkpoints of the global params (paper App-B), in the JAX package's
format.

The LIFL agent checkpoints the global model params to persistent
storage after the aggregation goal is met, asynchronously, so the write
never adds to the aggregation completion time.

Format (``repro.checkpoint``'s own): one ``ckpt_%08d.npz`` per
checkpoint, written as ``.tmp`` and renamed into place, keyed by the
JAX package's path keys (dict keys and list indices joined with ``/``,
e.g. ``stages/0/1/conv1``), each leaf in the JAX layout (conv kernels
HWIO, through ``convert.py``); a ``ckpt_%08d.json`` manifest (step,
time, keys, extra); and a ``LATEST`` marker.  npz has no bf16: a bf16
leaf is stored as fp32, which holds every bf16 value exactly, and cast
back on restore.  So a checkpoint written by either package restores
into the other, bit for bit.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bf16 import widen_bf16
from repro_torch.convert import conv_flags, leaf_from_jax, leaf_to_jax
from repro_torch.device import host_like
from repro_torch.tree import named_leaves, tree_flatten, tree_unflatten

#: a snapshot: (key, host tensor in the port's layout, conv kernel?)
_Snapshot = List[Tuple[str, torch.Tensor, bool]]


def _keys(tree: Any) -> List[str]:
    return [k for k, _ in named_leaves(tree, sep="/")]


def _snapshot(params: Any, reuse: Optional[_Snapshot] = None) -> _Snapshot:
    """Every leaf copied to the host: queued into pinned buffers for
    leaves on the card (``reuse``'s, when they fit) and waited for once."""
    leaves = tree_flatten(params)[0]
    old = {k: t for k, t, _ in reuse or ()}
    out: _Snapshot = []
    on_card = False
    for key, leaf, conv in zip(_keys(params), leaves, conv_flags(params)):
        leaf = leaf.detach()
        host = old.get(key)
        if host is None or host.shape != leaf.shape \
                or host.dtype != leaf.dtype:
            host = host_like(leaf)
        on_card |= leaf.device.type == "cuda"
        host.copy_(leaf, non_blocking=leaf.device.type == "cuda")
        out.append((key, host, conv))
    if on_card:
        torch.cuda.current_stream().synchronize()
    return out


def _to_jax(host: torch.Tensor, conv: bool) -> np.ndarray:
    """One host leaf as the JAX package stores it: its layout, bf16 as
    fp32."""
    t = leaf_to_jax(host, conv)
    if t.dtype == torch.bfloat16:
        return widen_bf16(t.contiguous().view(torch.int16).numpy())
    return np.ascontiguousarray(t.numpy())


def _write(directory: Path, step: int, snap: _Snapshot,
           extra: Optional[Dict[str, Any]]) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"ckpt_{step:08d}.npz.tmp"
    final = directory / f"ckpt_{step:08d}.npz"
    flat = {key: _to_jax(host, conv) for key, host, conv in snap}
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    tmp.rename(final)  # atomic publish
    manifest = {"step": step, "time": time.time(),
                "keys": sorted(flat.keys()), "extra": extra or {}}
    (directory / f"ckpt_{step:08d}.json").write_text(json.dumps(manifest))
    (directory / "LATEST").write_text(str(step))
    return final


def save_checkpoint(directory: str | Path, step: int, params: Any,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    """Synchronous save: copies the params to the host and writes the
    npz and its manifest."""
    return _write(Path(directory), step, _snapshot(params), extra)


def latest_step(directory: str | Path) -> Optional[int]:
    marker = Path(directory) / "LATEST"
    if not marker.exists():
        return None
    return int(marker.read_text().strip())


def restore_checkpoint(directory: str | Path, like: Any,
                       step: Optional[int] = None,
                       device: Any = None) -> Tuple[Any, int]:
    """Restore into the structure, layout and dtypes of ``like`` (a
    params tree of tensors), each leaf on ``like``'s device or on
    ``device`` when given.  -> (params, step)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    leaves, treedef = tree_flatten(like)
    out = []
    with np.load(directory / f"ckpt_{step:08d}.npz") as data:
        for key, leaf, conv in zip(_keys(like), leaves, conv_flags(like)):
            arr = data[key]
            want = tuple(leaf_to_jax(leaf, conv).shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}"
                                 f" != expected {want}")
            t = leaf_from_jax(torch.from_numpy(arr).to(leaf.dtype), conv)
            out.append(t.contiguous().to(
                device if device is not None else leaf.device))
    return tree_unflatten(treedef, out), step


class AsyncCheckpointer:
    """Background-thread checkpointing (App-B): ``submit`` copies the
    params to the host and returns; a thread writes them.  The previous
    write is joined first, so at most one write is in flight and
    checkpoints commit in order; its pinned host buffers are then free
    and the next snapshot reuses them."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._snap: Optional[_Snapshot] = None
        self.completed: int = 0
        #: the last submit's time in the caller (s): join, snapshot
        self.submit_s = 0.0
        #: the last write's time on the thread (s): layout, npz, manifest
        self.write_s = 0.0

    def submit(self, step: int, params: Any,
               extra: Optional[Dict[str, Any]] = None) -> None:
        t0 = time.perf_counter()
        self.wait()
        # snapshot to host *before* returning so the training step can
        # overwrite device buffers safely
        snap = self._snap = _snapshot(params, reuse=self._snap)

        def run():
            t1 = time.perf_counter()
            try:
                _write(self.directory, step, snap, extra)
                self.completed += 1
            except BaseException as e:  # surfaced on next wait()
                self._error = e
            self.write_s = time.perf_counter() - t1

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        self.submit_s = time.perf_counter() - t0

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
