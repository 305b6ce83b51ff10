"""The port's examples (``examples/*_torch.py``) on the CPU.

Each example is the JAX example of the same name on ``repro_torch``:
its arguments and printed lines, plus ``--device`` (the card unless
named).  Checked here:

* importing an example loads neither ``jax`` nor any ``repro.*``
  module (a subprocess, so this process's JAX imports do not count);
* each example's ``main`` runs in-process with ``--device cpu`` to its
  OK line and the markers ``tests/test_examples_smoke.py`` asserts for
  the JAX example; the ResNet examples' data is capped (their
  ``synthetic_femnist`` patched, as ``tests/test_torch_session.py``
  uses 48 images) and ``train_fl_lm``'s 100M config replaced by the
  reduced llama, so the suite stays fast: the paths are the examples';
* without a card and without ``--device`` an example exits non-zero
  with "no CUDA device", never falling back to the CPU;
* ``serve_decode_torch``'s loop against the JAX example's loop on the
  JAX draw of the same reduced fp32 params: prefill logits within
  ``tests/test_torch_lm.py``'s fp32 limit, greedy tokens equal.  For
  internvl2-26b the JAX side decodes at ``F + prompt_len + i``, the
  JAX package's test's positions (``tests/test_smoke_archs.py:76``).
"""
import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs.resnet import RESNET18 as J_RESNET18
from repro.data import TokenTaskStream
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build
from repro.models.resnet import build_resnet as j_build
from repro_torch.configs import ARCHS as TORCH_ARCHS
from repro_torch.serve import AggregationService

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
NAMES = ("quickstart", "elastic_scaling", "fl_resnet_femnist",
         "serve_decode", "train_fl_lm", "multinode", "serve_gateway")
#: the ResNet examples' images, capped
N_IMAGES = 96
#: tests/test_torch_lm.py's fp32 logits limit, rtol = atol
LOGITS_TOL = 1e-4


def _load(name):
    """``examples/<name>_torch.py`` as a fresh module."""
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch_example",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capped(mod, monkeypatch):
    orig = mod.synthetic_femnist
    monkeypatch.setattr(mod, "synthetic_femnist",
                        lambda n, **kw: orig(min(n, N_IMAGES), **kw))
    return mod


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


# ---------------------------------------------------------------------------
# the examples import the port alone
# ---------------------------------------------------------------------------

ISOLATION = """
import importlib.util, json, sys
out = {}
for name in NAMES:
    spec = importlib.util.spec_from_file_location(
        name + "_torch_example", f"EXAMPLES/{name}_torch.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    out[name] = sorted(m for m in sys.modules if m == "jax"
                       or m.startswith(("jax.", "repro.")) or m == "repro")
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def imported():
    """One subprocess imports every example in turn and lists, after
    each, the JAX and ``repro`` modules loaded so far."""
    code = ISOLATION.replace("NAMES", repr(NAMES)).replace(
        "EXAMPLES", str(EXAMPLES))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_neither_jax_nor_repro(imported, name):
    assert imported[name] == [], imported[name]


@pytest.fixture(scope="module")
def refused():
    """Each example run as a user would, with no card visible and no
    ``--device`` (all seven at once) -> {name: CompletedProcess}."""
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = {name: subprocess.Popen(
        [sys.executable, str(EXAMPLES / f"{name}_torch.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name in NAMES}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        out[name] = subprocess.CompletedProcess(proc.args, proc.returncode,
                                                stdout, stderr)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_example_refuses_a_host_without_a_card(refused, name):
    """No card and no ``--device``: the example exits non-zero naming
    the missing device, before it prints or runs anything."""
    out = refused[name]
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""


# ---------------------------------------------------------------------------
# each example on the CPU, to its OK line
# ---------------------------------------------------------------------------


def _jax_resnet_params():
    """The JAX example's draw: ``init(PRNGKey(0))`` of ResNet-18-reduced,
    as numpy in the JAX layout."""
    params = j_build(J_RESNET18.reduced()).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def test_quickstart_runs_on_the_cpu(monkeypatch, capsys):
    """Both parts at ``--fast``, part 1 from the JAX example's draw: its
    first evaluation is the JAX model's on the same test images.  The
    external update is a tree of zeros on the session's device.  oneDNN
    stays on: client SGD turns it off on the CPU itself."""
    mod = _capped(_load("quickstart"), monkeypatch)
    jparams = _jax_resnet_params()
    mod.main(["--fast", "--device", "cpu"], params=jparams)
    out = capsys.readouterr().out
    assert "quickstart OK" in out
    assert "model_version=2" in out and "events=" in out
    assert "fused FL round" in out and "XLA" not in out
    imgs, labels = mod.synthetic_femnist(400, num_classes=10, seed=0)
    jloss, jaux = jax.jit(j_build(J_RESNET18.reduced()).loss)(
        jparams, {"images": imgs[:128], "labels": labels[:128]})
    before = ast.literal_eval(re.search(r"before: (\{.*\})", out).group(1))
    assert abs(before["loss"] - float(jloss)) < 1e-4
    assert abs(before["accuracy"] - float(jaux["accuracy"])) < 1e-6
    assert re.findall(r"round (\d): updates=", out) == ["0", "1"]
    losses = re.findall(r"round \d: loss=([\d.]+)", out)
    assert len(losses) == 2 and all(np.isfinite(float(l)) for l in losses)
    assert torch.backends.mkldnn.enabled


def test_elastic_scaling_runs_on_the_cpu(monkeypatch, capsys):
    mod = _capped(_load("elastic_scaling"), monkeypatch)
    seen = []
    orig = mod.Session.emit

    def emit(self, ev):
        seen.append(type(ev).__name__)
        return orig(self, ev)

    monkeypatch.setattr(mod.Session, "emit", emit)
    mod.main(["--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "elastic_scaling OK" in out
    assert "node_lost" in out and "node_joined" in out
    # NodeLost at rounds // 2, NodeJoined at rounds - 2, a decision a round
    assert seen == ["ScaleDecision", "ScaleDecision", "NodeLost",
                    "NodeJoined", "ScaleDecision", "ScaleDecision"]
    decisions = re.search(r"scale decisions: (\[.*\])", out).group(1)
    assert [d.split(":")[0] for d in ast.literal_eval(decisions)] == [
        "0", "1", "2", "3"]


def test_fl_resnet_femnist_runs_on_the_cpu(monkeypatch, capsys):
    mod = _capped(_load("fl_resnet_femnist"), monkeypatch)
    mod.main(["--rounds", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fl_resnet_femnist OK" in out
    rows = re.findall(r"^\s+(\d)\s+([\d.]+)\s+([\d.]+)\s", out, re.M)
    assert [r[0] for r in rows] == ["0", "1"]
    assert all(np.isfinite(float(loss)) for _, _, loss in rows)
    ratio = float(re.search(r"\(([\d.]+)x\)", out).group(1))
    assert ratio > 1.0            # LIFL ahead of SL-H in the simulator


def test_train_fl_lm_resumes_from_round_50(monkeypatch, capsys, tmp_path):
    """51 rounds leave the round-50 checkpoint; ``--resume --rounds 53``
    restores it with the server state rebuilt (FedAdam's step back at
    0) and trains rounds 50-52.  Round 50's loss is taken before the
    server step, on the same params and batch: the same in both runs
    (rtol 1e-6: the same arithmetic on the same inputs)."""
    mod = _load("train_fl_lm")
    monkeypatch.setattr(mod, "build_100m_config",
                        lambda: TORCH_ARCHS["llama3.2-3b"].reduced(
                            dtype="float32"))
    small = ["--batch", "4", "--seq", "16", "--cohorts", "2",
             "--ckpt", str(tmp_path / "ckpt"), "--device", "cpu"]
    first = mod.main(["--rounds", "51", *small])
    assert first.agg.server_opt == "fedadam"
    assert int(first.server_state["step"]) == 51
    out = capsys.readouterr().out
    assert "round   50 loss=" in out and "final loss:" in out
    resumed = mod.main(["--rounds", "53", "--resume", *small])
    out = capsys.readouterr().out
    assert "resumed from round 50" in out
    assert [h["round"] for h in resumed.history] == [51, 52, 53]
    assert int(resumed.server_state["step"]) == 3
    np.testing.assert_allclose(resumed.history[0]["loss"],
                               first.history[50]["loss"], rtol=1e-6)
    assert all(np.isfinite(h["loss"]) for h in resumed.history)
    assert re.findall(r"round\s+(\d+) loss=", out) == ["50", "52"]


def test_multinode_runs_on_the_cpu(monkeypatch, capfd):
    """Two port daemons (``--device cpu``) and an external pusher
    process that imports the port alone (its line reaches fd 1, hence
    ``capfd``)."""
    mod = _capped(_load("multinode"), monkeypatch)
    mod.main(["--fast", "--device", "cpu"])
    out = capfd.readouterr().out
    assert "Multi-node LIFL" in out
    assert "connected nodes: ['node0', 'node1']" in out
    assert "partial from mid@" in out
    assert "client:" in out
    assert "done: cross-node rounds" in out
    assert "(with external update)" in out


def test_serve_gateway_runs_on_the_cpu(monkeypatch, capfd):
    """Rolling rounds overlap, the monitor scrapes, and the ingress
    counters account for every submission: each ``submit`` (the pusher
    threads' and the external process's frames) is admitted, shed or a
    duplicate, and each admitted update folded in a round or is still
    queued.  Counts depend on timing; these sums do not."""
    mod = _load("serve_gateway")
    verdicts = []
    lock = threading.Lock()
    orig = AggregationService.submit

    def submit(self, *a, **kw):
        v = orig(self, *a, **kw)
        with lock:
            verdicts.append(v)
        return v

    monkeypatch.setattr(AggregationService, "submit", submit)
    mod.main(["--fast", "--device", "cpu"])
    out = capfd.readouterr().out
    assert "done: two jobs, one fleet" in out
    assert "edge client: 8 updates pushed" in out
    assert float(re.search(r"pipeline_overlap=([\d.]+)", out).group(1)) > 0
    assert int(re.search(r"monitor: (\d+) scrapes", out).group(1)) > 0
    m = {k: int(v) for k, v in re.findall(
        r"(admitted|shed|duplicates|queued_now)=(\d+)", out)}
    assert m["admitted"] + m["shed"] + m["duplicates"] == len(verdicts)
    assert m["admitted"] == sum(v["admitted"] for v in verdicts)
    folded = sum(int(c) for c in re.findall(r"cohort=(\d+)", out))
    assert folded + m["queued_now"] == m["admitted"]
    assert len(re.findall(r"ticket \d+: job=", out)) == 6


# ---------------------------------------------------------------------------
# serve_decode_torch's loop against the JAX example's
# ---------------------------------------------------------------------------

BATCH, PROMPT, STEPS = 4, 48, 32


def _jax_serve(arch):
    """``examples/serve_decode.py``'s loop on ``init(PRNGKey(0))``, at
    the JAX package's test's positions -> (params as numpy, prefill
    logits, greedy tokens (B, 1 + STEPS))."""
    cfg = ARCHS[arch].reduced(dtype="float32")
    offset = cfg.frontend_tokens if cfg.frontend and not cfg.encoder_layers \
        else 0
    model = jax_build(cfg, JaxOptions(
        attn_impl="chunked", moe_impl="dense", block_kv=32, remat=False,
        prefill_cache_capacity=offset + PROMPT + STEPS + 8))
    params = model.init(jax.random.PRNGKey(0))
    stream = TokenTaskStream(cfg.vocab_size, PROMPT, seed=1)
    batch = {"tokens": jnp.asarray(stream.batch(BATCH)["tokens"])}
    if cfg.frontend:
        batch["frontend"] = jnp.zeros(
            (BATCH, cfg.frontend_tokens, cfg.d_model), jnp.float32)
    logits, caches = jax.jit(model.prefill)(params, batch)
    first = np.asarray(logits)
    decode = jax.jit(model.decode_step)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    generated = [tok]
    for i in range(STEPS):
        logits, caches = decode(params, tok, caches,
                                jnp.int32(offset + PROMPT + i))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        generated.append(tok)
    return (jax.tree.map(np.asarray, params), first,
            np.asarray(jnp.concatenate(generated, axis=1)))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-26b"])
def test_serve_decode_matches_the_jax_loop(arch, capsys):
    params, want_logits, want_tokens = _jax_serve(arch)
    got = _load("serve_decode").main(
        ["--arch", arch, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
         "--steps", str(STEPS), "--device", "cpu"], params=params)
    assert "serve_decode OK" in capsys.readouterr().out
    np.testing.assert_allclose(got["prefill_logits"].numpy(), want_logits,
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    np.testing.assert_array_equal(got["tokens"], want_tokens)
    assert got["lat_ms"].shape == (STEPS - 1,)
