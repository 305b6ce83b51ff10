#!/usr/bin/env python3
"""Count the ops that one fused round dispatches, on the CPU.

    PYTHONPATH=src python tools/count_round_ops.py falcon-mamba-7b --layers 1

One hierarchical int8 round at ``chip_smoke.py`` phase 11's traffic (2
pods x 2 microbatches x 2 sequences of ``--seq`` tokens) through
``FusedFLTrainer`` with ``build_train_step``'s options, on the arch's
reduced widths (``ArchConfig.reduced``, bf16) at ``--layers`` layers
(hymba-1.5b keeps its pattern of global and windowed layers).  Prints
the aten ops the round dispatches (a ``TorchDispatchMode`` count, views
included: each is a call on the host, and the card launches a kernel
for fewer of them), the most frequent ops, and the round's wall time
without the count, a CPU time, not a device one.  The count does not
depend on the widths, so it reckons the host's share of a full-width
round on the card.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS
from repro_torch.data.loader import CohortTokenLoader
from repro_torch.fl.round import AggregationConfig
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.runtime import FusedFLTrainer


class OpCount(TorchDispatchMode):
    """Counts every aten op dispatched inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", choices=sorted(ARCHS))
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args()
    full = ARCHS[args.arch]
    cfg = dataclasses.replace(full.reduced(dtype="bfloat16"),
                              num_layers=args.layers,
                              attn_pattern=full.attn_pattern)
    trainer = FusedFLTrainer(
        cfg, make_debug_mesh((2, 1, 1), ("pod", "data", "model")),
        AggregationConfig(compress="int8", num_microbatches=2),
        device="cpu")
    trainer.init(0)
    batch = CohortTokenLoader(cfg.vocab_size, seq_len=args.seq,
                              n_cohorts=4).round_batch(8, 0)
    if cfg.frontend:
        batch["frontend"] = np.zeros((8, cfg.frontend_tokens, cfg.d_model),
                                     np.float32)
    params = trainer.params
    trainer.train_round(batch)                      # warm
    trainer.params = params
    t0 = time.perf_counter()
    trainer.train_round(batch)
    wall = time.perf_counter() - t0
    trainer.params = params
    count = OpCount()
    with count:
        trainer.train_round(batch)
    print(f"{args.arch}, {args.layers} layers, seq {args.seq}: "
          f"{sum(count.ops.values())} ops dispatched a round, "
          f"CPU wall {wall:.2f} s")
    for name, n in count.ops.most_common(12):
        print(f"  {name} {n}")


if __name__ == "__main__":
    main()
