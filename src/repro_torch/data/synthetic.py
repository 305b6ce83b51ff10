"""Synthetic data sources.

* ``TokenTaskStream`` — a *learnable* synthetic LM task (affine-recurrent
  token sequences): next-token entropy is genuinely reducible, so the
  end-to-end training examples show real loss curves, not noise fitting.
* ``synthetic_femnist`` — FEMNIST-shaped image classification (28×28×1,
  62 classes) with per-class Gaussian prototypes; learnable by the
  ResNet examples, partitionable non-IID per client.
* ``StragglerModel`` — heavy-tailed client execution times (lognormal /
  shifted-Pareto), the realistic arrival process behind
  ``RoundDeadline`` partial-round coverage: a handful of clients in
  every cohort take many multiples of the median, so a deadline-closed
  round with the partials at hand is the *normal* case, not a corner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass
class StragglerModel:
    """Heavy-tailed per-client execution times (mobile/edge cohorts).

    ``lognormal``: ``median_s · exp(sigma·Z)`` — the classic device-speed
    spread; with ``sigma≈1`` the p99/p50 ratio is ~10×.
    ``pareto``: shifted Pareto (Lomax + 1 floor), ``median_s`` scales the
    floor; ``alpha ≤ 2`` gives the infinite-variance tail where a single
    client can dominate the round — exactly what the aggregation goal +
    deadline are designed to absorb.

    Deterministic under a seeded ``np.random.Generator``; ``sample``
    never mutates shared state, so two schedulers with equal seeds see
    equal cohorts.
    """

    dist: str = "lognormal"     # "lognormal" | "pareto"
    median_s: float = 1.0
    sigma: float = 1.0          # lognormal shape (log-space std)
    alpha: float = 1.5          # Pareto tail index (≤2 ⇒ inf. variance)

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """``n`` i.i.d. client exec times (seconds, float64)."""
        if self.dist == "lognormal":
            return self.median_s * np.exp(
                self.sigma * rng.standard_normal(n))
        if self.dist == "pareto":
            # Lomax sample + 1 == Pareto with x_m = 1: floor at median_s
            return self.median_s * (rng.pareto(self.alpha, size=n) + 1.0)
        raise ValueError(f"unknown straggler dist {self.dist!r} "
                         "(expected 'lognormal' or 'pareto')")

    def tail_ratio(self, n: int, rng: np.random.Generator,
                   q: float = 0.99) -> float:
        """p_q / p50 of a size-``n`` sample — the straggler severity
        figure benches and tests assert on."""
        s = self.sample(n, rng)
        return float(np.quantile(s, q) / np.quantile(s, 0.5))


@dataclass
class TokenTaskStream:
    """Markov-ish token stream: next = (a·cur + b + drift(pos)) mod V."""

    vocab_size: int
    seq_len: int
    seed: int = 0
    a: int = 5
    b: int = 17

    def batch(self, batch_size: int, round_id: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, round_id))
        V = self.vocab_size
        starts = rng.integers(0, V, size=(batch_size, 1))
        toks = np.zeros((batch_size, self.seq_len), np.int32)
        toks[:, 0] = starts[:, 0]
        noise = rng.random((batch_size, self.seq_len)) < 0.05
        rand_toks = rng.integers(0, V, size=(batch_size, self.seq_len))
        for t in range(1, self.seq_len):
            nxt = (self.a * toks[:, t - 1] + self.b) % V
            toks[:, t] = np.where(noise[:, t], rand_toks[:, t], nxt)
        labels = np.roll(toks, -1, axis=1).astype(np.int32)
        labels[:, -1] = -1
        return {"tokens": toks, "labels": labels}


def synthetic_femnist(
    n_samples: int,
    num_classes: int = 62,
    image_size: int = 28,
    seed: int = 0,
    class_distribution: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> images (N, H, W, 1) fp32, labels (N,) int32.

    Class prototypes are fixed Gaussian blobs + frequency gratings so a
    small CNN separates them after a few dozen steps."""
    rng = np.random.default_rng(seed)
    proto_rng = np.random.default_rng(1234)  # shared across clients
    protos = proto_rng.normal(0, 1, size=(num_classes, image_size, image_size))
    # low-pass the prototypes so they're smooth/learnable
    for c in range(num_classes):
        f = np.fft.rfft2(protos[c])
        f[6:, :] = 0
        f[:, 6:] = 0
        protos[c] = np.fft.irfft2(f, s=(image_size, image_size))
    protos /= protos.std(axis=(1, 2), keepdims=True) + 1e-6

    if class_distribution is None:
        class_distribution = np.full((num_classes,), 1.0 / num_classes)
    labels = rng.choice(num_classes, size=n_samples, p=class_distribution)
    noise = rng.normal(0, 0.6, size=(n_samples, image_size, image_size))
    images = protos[labels] + noise
    return images[..., None].astype(np.float32), labels.astype(np.int32)
