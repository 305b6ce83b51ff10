"""Plain PyTorch versions of the fedavg kernels: the CPU path of
``ops.py`` and the oracle the CUDA kernels are held against.

Same arithmetic order as the kernels: the burst and the reduce sum the
K weighted rows first, then (burst only) add the accumulator once —
``acc + Σ_k w_k·u_k``, not K sequential adds.  Each product and each
sum is one fp32 rounding; the kernels keep nvcc from contracting them
into an FMA, so the one-update fold gives the kernel's bits exactly.
The K-row sums may be taken in another order by torch's reduction than
by the kernel's ascending loop, hence the burst's tolerance (1e-5).
"""
from __future__ import annotations

import numpy as np
import torch


def fedavg_reduce_ref(updates: torch.Tensor, weights: torch.Tensor
                      ) -> torch.Tensor:
    """(K, N) × (K,) -> (N,) fp32 weighted sum (weights pre-normalized)."""
    return (updates.float() * weights.float()[:, None]).sum(dim=0)


def eager_accumulate_ref(acc: torch.Tensor, update: torch.Tensor,
                         weight: float) -> torch.Tensor:
    """acc + w·u in fp32 (a new tensor; ``ops.py`` writes it back)."""
    # the fp32 weight times an fp32 tensor stays in fp32
    w = float(np.float32(weight))
    return (acc.float() + update.float() * w).to(acc.dtype)


def fedavg_accumulate_k_ref(acc: torch.Tensor, updates: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """(N,) + (K, N) × (K,) -> (N,): running-sum burst fold (weights raw)."""
    return (acc.float() + fedavg_reduce_ref(updates, weights)).to(acc.dtype)
