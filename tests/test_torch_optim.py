"""The port's ``optim/adam.py`` and ``optim/schedule.py`` against the
JAX package's: Adam with and without weight decay over 5 steps from
numpy-seeded trees, ``clip_by_global_norm`` above and below its limit,
and both schedules over a run, within 1e-6 (relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam as jadam
from repro.optim import schedule as jsched
from repro_torch.optim import (adam_apply, adam_init, clip_by_global_norm,
                               constant, warmup_cosine)
from repro_torch.tree import tree_leaves

RTOL = 1e-6


def _tree(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((5, 7))).astype(np.float32),
            "layers": [(scale * rng.standard_normal(3)).astype(np.float32),
                       (scale * rng.standard_normal((2, 4))).astype(
                           np.float32)]}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _close(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.all(np.abs(g - w) <= RTOL * np.maximum(np.abs(w), 1e-30))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_matches_jax_over_five_steps(weight_decay):
    rng = np.random.default_rng(0)
    init = _tree(rng)
    jp, tp = _jax(init), _torch(init)
    js, ts = jadam.adam_init(jp), adam_init(tp)
    for _ in range(5):
        g = _tree(rng, 0.1)
        jp, js = jadam.adam_apply(jp, _jax(g), js, lr=1e-2,
                                  weight_decay=weight_decay)
        tp, ts = adam_apply(tp, _torch(g), ts, lr=1e-2,
                            weight_decay=weight_decay)
        _close(tp, jp)
        _close(ts["m"], js["m"])
        _close(ts["v"], js["v"])
        assert int(ts["step"]) == int(js["step"])
    assert ts["step"].dtype == torch.int32


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(1))
    _close(clip_by_global_norm(_torch(g), max_norm),
           jadam.clip_by_global_norm(_jax(g), max_norm))


def test_schedules_match_jax():
    jw, tw = jsched.warmup_cosine(3e-4, 10, 100, 1e-5), \
        warmup_cosine(3e-4, 10, 100, 1e-5)
    for step in range(0, 120):
        assert abs(float(tw(step)) - float(jw(step))) <= \
            RTOL * abs(float(jw(step)))
        assert tw(step).dtype == torch.float32
    assert float(constant(0.3)(7)) == float(jsched.constant(0.3)(7))
