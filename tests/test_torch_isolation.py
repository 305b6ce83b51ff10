"""The port stands alone: it imports neither JAX nor the JAX package,
its copied modules stay the JAX package's code, its entry points run
on the card unless told otherwise, and what it has not ported yet is
refused by name."""
import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

#: modules copied from the JAX package with only the import prefix changed
VERBATIM = [
    "core/objectstore.py", "core/gateway.py", "core/sidecar.py",
    "obs/live.py", "core/aggregation.py", "core/tag.py", "core/reuse.py",
    "core/hierarchy.py", "core/placement.py", "core/coordinator.py",
    "runtime/events.py", "obs/trace.py", "configs/resnet.py",
    "data/partition.py", "data/synthetic.py", "data/loader.py",
    "configs/__init__.py", "configs/base.py", "configs/llama32_3b.py",
    "configs/gemma3_4b.py", "configs/gemma3_12b.py",
    "configs/h2o_danube3_4b.py", "configs/hymba_1_5b.py",
    "configs/internvl2_26b.py", "configs/kimi_k2_1t_a32b.py",
    "configs/deepseek_v2_lite_16b.py", "configs/falcon_mamba_7b.py",
    "configs/seamless_m4t_large_v2.py",
]


def test_importing_every_port_module_pulls_in_no_jax():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or"
        " n.startswith('jax.') or n == 'repro' or n.startswith('repro.')"
        " or n == 'ml_dtypes')\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.strip().splitlines()
    assert int(n_mods) >= 30 and bad == "[]"


@pytest.mark.parametrize("path", sorted(p.relative_to(PORT).as_posix()
                                        for p in PORT.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tree = ast.parse((PORT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("path", VERBATIM)
def test_copied_module_is_the_jax_packages_own(path):
    orig = (SRC / "repro" / path).read_text()
    assert (PORT / path).read_text() == re.sub(r"\brepro\.", "repro_torch.",
                                               orig)


def test_driver_differs_from_the_jax_package_only_where_intended():
    orig = re.sub(r"\brepro\.", "repro_torch.",
                  (SRC / "repro/runtime/driver.py").read_text())
    port = (PORT / "runtime/driver.py").read_text()
    head = orig[:orig.index("class ShmProcRuntime(")].replace(
        "self.store.put(np.asarray(agg.state.acc, dtype=np.float32))",
        "self.store.put(agg.engine.to_numpy(agg.state.acc))")
    tail = orig[orig.index("def make_runtime("):]
    assert port.startswith(head) and port.endswith(tail)
    stub = port[len(head): len(port) - len(tail)]
    assert stub.startswith("class ShmProcRuntime:") and "A.4" in stub


def _tiny_session_args():
    from repro_torch.configs.resnet import RESNET18
    from repro_torch.models.resnet import build_resnet

    model = build_resnet(RESNET18.reduced())
    return model, model.init(0, device="cpu"), []


def test_session_defaults_to_the_card():
    from repro_torch.api import Session

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session.open(*_tiny_session_args())


@pytest.mark.parametrize("entry", ["init", "params_from_jax", "lm_init",
                                   "lm_init_decode", "lm_params_from_jax",
                                   "fused_trainer", "lm_init_train",
                                   "tree_from_jax"])
def test_params_default_to_the_card(entry):
    from repro_torch.configs import ARCHS
    from repro_torch.configs.resnet import RESNET18
    from repro_torch.convert import (lm_params_from_jax, params_from_jax,
                                     tree_from_jax)
    from repro_torch.fl.round import AggregationConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.models.resnet import build_resnet
    from repro_torch.runtime import FusedFLTrainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = build_resnet(RESNET18.reduced())
    lm = build_model(ARCHS["llama3.2-3b"].reduced(),
                     ModelOptions(attn_impl="pallas", remat=False))
    make = {"init": lambda: model.init(0),
            "params_from_jax": lambda: params_from_jax({"w": np.ones(3)}),
            "lm_init": lambda: lm.init(0),
            "lm_init_decode": lambda: lm.init_decode(1, 8),
            "lm_params_from_jax":
                lambda: lm_params_from_jax({"embed": np.ones((4, 2))}),
            "fused_trainer": lambda: FusedFLTrainer(
                ARCHS["llama3.2-3b"].reduced(),
                make_debug_mesh((2, 1, 1), ("pod", "data", "model")),
                AggregationConfig(compress="int8")),
            "lm_init_train": lambda: build_model(
                ARCHS["llama3.2-3b"].reduced(),
                ModelOptions(attn_impl="chunked", remat=True)).init(0),
            "tree_from_jax": lambda: tree_from_jax({"step": np.int32(0)})}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make[entry]()


@pytest.mark.parametrize("kwargs,item", [
    ({"runtime": "shmproc"}, "A.4"),
    ({"nodes": ["127.0.0.1:7000"]}, "A.4"),
    ({"wire_compress": 6}, "A.4"),
    ({"admission": True}, "A.4"),
    ({"checkpoint_dir": "ckpt"}, "A.8"),
])
def test_unported_inputs_name_their_roadmap_item(kwargs, item):
    from repro_torch.api import Session

    with pytest.raises(NotImplementedError, match=item):
        Session.open(*_tiny_session_args(), device="cpu", **kwargs)


def test_serve_and_shmproc_runtime_are_refused():
    from repro_torch.api import Session
    from repro_torch.runtime import ShmProcRuntime

    with Session.open(*_tiny_session_args(), device="cpu") as s:
        with pytest.raises(NotImplementedError, match="A.4"):
            s.serve()
        assert s.metrics()["rounds"] == []
    with pytest.raises(NotImplementedError, match="A.4"):
        ShmProcRuntime()


@pytest.mark.parametrize("op", ["quantize", "dequantize", "fedavg",
                                "flash"])
def test_kernel_ops_launch_or_raise_on_the_card_path(op):
    """``impl="cuda"`` is the card's path: given a CPU tensor it raises,
    and never runs the plain version."""
    from repro_torch.kernels.fedavg import ops as fed_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.quantize import ops as q_ops

    x = torch.zeros(256)
    call = {
        "quantize": lambda: q_ops.quantize(x, impl="cuda"),
        "dequantize": lambda: q_ops.dequantize(
            torch.zeros(1, 256, dtype=torch.int8), torch.ones(1), 256,
            impl="cuda"),
        "fedavg": lambda: fed_ops.eager_accumulate(x, x, 1.0, impl="cuda"),
        "flash": lambda: fa_ops.flash_attention(
            torch.zeros(1, 4, 1, 1, 8), torch.zeros(1, 4, 1, 8),
            torch.zeros(1, 4, 1, 8), impl="cuda"),
    }
    with pytest.raises(ValueError, match="CUDA tensor"):
        call[op]()
