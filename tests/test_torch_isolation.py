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
    "runtime/shmrt/messages.py", "runtime/shmrt/ring.py",
    "runtime/shmrt/shmengine.py", "runtime/shmrt/worker.py",
    "runtime/shmrt/dispatcher.py", "runtime/shmrt/__init__.py",
    "runtime/netrt/faults.py",
    "runtime/netrt/remote.py", "runtime/netrt/__init__.py",
    "serve/gateway.py",
]

#: copies that must differ: each edit, by name, is a list of (JAX text,
#: port text) replacements applied to the JAX module
TRANSPORT_EDITS = {
    # the port never imports ml_dtypes: a name numpy does not know is
    # numpy's TypeError, not a lazy import
    "no-ml_dtypes": [
        ('    """``np.dtype`` by name, registering ml_dtypes (bfloat16, fp8)'
         ' on\n    demand so bf16 wire updates decode in processes that '
         'never imported\n    jax."""\n    try:\n        return '
         'np.dtype(name)\n    except TypeError:\n        import ml_dtypes'
         '  # noqa: F401  (registers the extended dtypes)\n        return '
         'np.dtype(name)\n',
         '    """``np.dtype`` by name.  The extended dtypes (bfloat16, fp8) '
         'resolve\n    once the process has imported ``ml_dtypes``, which '
         'registers them;\n    the port never imports it (the card\'s '
         'machine has none), so there\n    a bf16 wire update is refused '
         'with numpy\'s ``TypeError``."""\n    return np.dtype(name)\n'),
    ],
}

#: the port's netd: three edits
NETD_EDITS = {
    # --device: the daemon's engines run on the card unless named, and
    # a daemon on a host without one fails at start
    "device": [
        ("from repro_torch.core.sidecar import MetricsMap, series_flatten\n"
         "from repro_torch.runtime.driver import make_runtime\n",
         "from repro_torch.core.engine import EngineConfig\n"
         "from repro_torch.core.sidecar import MetricsMap, series_flatten\n"
         "from repro_torch.device import resolve_device\n"
         "from repro_torch.kernels.fedavg.fedavg import KERNELS as "
         "FOLD_KERNELS\n"
         "from repro_torch.runtime.driver import make_runtime\n"),
        ("                 compress: int = 0, fault_plan: Optional[FaultPlan]"
         " = None):\n        self.node = node\n",
         "                 compress: int = 0, fault_plan: Optional[FaultPlan]"
         " = None,\n                 device: Optional[str] = None):\n"
         "        self.node = node\n"
         "        # the card unless the caller names another device: a "
         "daemon on\n"
         "        # a host without one fails here, at start, never folding "
         "on the\n"
         "        # CPU in its place\n"
         "        self.device = resolve_device(device)\n"),
        ("        self.rt = make_runtime(runtime, agg_engine=agg_engine,\n"
         "                               metrics=self.metrics)\n",
         "        self.rt = make_runtime(runtime, agg_engine=EngineConfig(\n"
         "            name=agg_engine, device=str(self.device)), "
         "metrics=self.metrics)\n"),
        ("                         \"for chaos tests; see netrt/faults.py)\")\n",
         "                         \"for chaos tests; see netrt/faults.py)\")\n"
         "    ap.add_argument(\"--device\", default=None,\n"
         "                    help=\"where the aggregation engines run: the "
         "card \"\n"
         "                         \"unless named (e.g. cpu)\")\n"),
        ("        if args.fault_spec else None)\n",
         "        if args.fault_spec else None, device=args.device)\n"),
    ],
    # spawn_local_daemon(..., device=None) passes --device on
    "spawn": [
        ("                       fault_spec: Optional[FaultPlan] = None):\n",
         "                       fault_spec: Optional[FaultPlan] = None,\n"
         "                       device: Optional[str] = None):\n"),
        ("        argv += [\"--fault-spec\", fault_spec.to_json()]\n",
         "        argv += [\"--fault-spec\", fault_spec.to_json()]\n"
         "    if device is not None:\n"
         "        argv += [\"--device\", str(device)]\n"),
    ],
    # stats_reply carries the engines' device and this process's fold
    # kernel launches: the counts live in the daemon, not the caller
    "stats": [
        ("                \"workers\": self.rt.worker_count(),\n"
         "            })\n",
         "                \"workers\": self.rt.worker_count(),\n"
         "                # this process's fold kernel launches: the only "
         "witness\n"
         "                # that the daemon's folds ran on the card\n"
         "                \"device\": str(self.device),\n"
         "                \"kernel_launches\": {k.name: k.launches\n"
         "                                    for k in FOLD_KERNELS},\n"
         "            })\n"),
    ],
}


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


def _rewritten(path):
    return re.sub(r"\brepro\.", "repro_torch.",
                  (SRC / "repro" / path).read_text())


def test_driver_differs_from_the_jax_package_only_where_intended():
    """One edit: publish copies the accumulator to the host through the
    engine (``np.asarray`` raises on a CUDA tensor)."""
    old = "self.store.put(np.asarray(agg.state.acc, dtype=np.float32))"
    orig = _rewritten("runtime/driver.py")
    assert orig.count(old) == 1
    assert (PORT / "runtime/driver.py").read_text() == orig.replace(
        old, "self.store.put(agg.engine.to_numpy(agg.state.acc))")


@pytest.mark.parametrize("path,edits", [
    ("runtime/netrt/netd.py", NETD_EDITS),
    ("runtime/netrt/transport.py", TRANSPORT_EDITS),
], ids=["netd", "transport"])
def test_copy_differs_from_the_jax_package_only_by_its_named_edits(
        path, edits):
    want = _rewritten(path)
    for edit, pairs in edits.items():
        for old, new in pairs:
            assert want.count(old) == 1, (edit, old)
            want = want.replace(old, new)
    assert (PORT / path).read_text() == want


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
    ({"checkpoint_dir": "ckpt"}, "A.8"),
])
def test_unported_inputs_name_their_roadmap_item(kwargs, item):
    from repro_torch.api import Session

    with pytest.raises(NotImplementedError, match=item):
        Session.open(*_tiny_session_args(), device="cpu", **kwargs)


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
