"""The port stands alone: it imports neither JAX nor the JAX package,
its copied modules stay the JAX package's code, its entry points run
on the card unless told otherwise, and what it has not ported yet is
refused by name."""
import ast
import importlib
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
    "serve/scheduler.py", "obs/export.py", "runtime/elastic.py",
    "core/routing.py", "obs/__init__.py", "runtime/__init__.py",
]

#: copies that must differ: each edit, by name, is a list of (JAX text,
#: port text) replacements applied to the JAX module
TRANSPORT_EDITS = {
    # the port never imports ml_dtypes: a bf16 payload decodes to raw
    # 16-bit words under a void dtype (repro_torch/bf16.py), which the
    # port's engines and ingress recognise and no numpy cast accepts
    "bf16-words": [
        ("import numpy as np\n",
         "import numpy as np\n\nfrom repro_torch.bf16 import BF16_WORDS\n"),
        ('    """``np.dtype`` by name, registering ml_dtypes (bfloat16, fp8)'
         ' on\n    demand so bf16 wire updates decode in processes that '
         'never imported\n    jax."""\n    try:\n        return '
         'np.dtype(name)\n    except TypeError:\n        import ml_dtypes'
         '  # noqa: F401  (registers the extended dtypes)\n        return '
         'np.dtype(name)\n',
         '    """``np.dtype`` by name.  numpy has no bfloat16 and the port '
         'never\n    imports ``ml_dtypes``: a bf16 payload decodes to '
         '``BF16_WORDS``,\n    its raw 16-bit words, which the port\'s '
         'engines and ingress\n    recognise (``repro_torch.bf16``) and no '
         'numpy arithmetic accepts.\n    Other extended dtypes (fp8) are '
         'refused with numpy\'s\n    ``TypeError``."""\n    if name == '
         '"bfloat16":\n        return BF16_WORDS\n    return '
         'np.dtype(name)\n'),
    ],
}

#: the port's AggregationService: two edits
SERVICE_EDITS = {
    # device=: the shared runtime's engines and every job's trainer run
    # on the card unless named, and a host without one fails at start
    "device": [
        ("from repro_torch.core import Coordinator, MetricsMap, NodeState, "
         "Selector\n",
         "from repro_torch.core import Coordinator, MetricsMap, NodeState, "
         "Selector\n"
         "from repro_torch.core.engine import EngineConfig\n"
         "from repro_torch.device import resolve_device\n"),
        ("                 max_open_rounds: int = 2, seed: int = 0):\n"
         "        self.metrics = MetricsMap()\n",
         "                 max_open_rounds: int = 2, seed: int = 0,\n"
         "                 device: Optional[str] = None):\n"
         "        # the card unless the caller names another device: the "
         "shared\n"
         "        # runtime's engines and every job's params and clients "
         "live\n"
         "        # there; a host without one fails here, never on the CPU\n"
         "        self.device = resolve_device(device)\n"
         "        self.metrics = MetricsMap()\n"),
        ("        self.runtime = make_runtime(runtime, metrics=self.metrics,\n"
         "                                    agg_engine=agg_engine)\n",
         "        self.runtime = make_runtime(\n"
         "            runtime, metrics=self.metrics,\n"
         "            agg_engine=EngineConfig(name=agg_engine, "
         "device=str(self.device)))\n"),
        ("            coordinator=self.coordinator, driver=self.driver,\n"
         "        )\n",
         "            coordinator=self.coordinator, driver=self.driver,\n"
         "            device=self.device,\n"
         "        )\n"),
    ],
    # submit(): bf16 words off the wire (the port's BF16_WORDS) are
    # widened exactly, as ml_dtypes' cast widens them in the JAX package
    "bf16": [
        ("from repro_torch.core import Coordinator, MetricsMap, NodeState, "
         "Selector\n",
         "from repro_torch.bf16 import as_f32\n"
         "from repro_torch.core import Coordinator, MetricsMap, NodeState, "
         "Selector\n"),
        ("        flat = np.ascontiguousarray(update, dtype=np.float32)"
         ".reshape(-1)\n",
         "        flat = as_f32(update).reshape(-1)   # bf16 words widened "
         "exactly\n"),
    ],
}

#: the port's cluster simulator: two edits
SIMULATION_EDITS = {
    # "auto" resolves through the port's engine module: _auto_name() is
    # "torch", the engine make_engine("auto") builds
    "auto-name": [
        ('        if engine == "auto":\n'
         "            from repro_torch.core.engine import _auto_name\n",
         '        if engine == "auto":\n'
         '            # the engine make_engine("auto") builds: "torch" in the '
         "port\n"
         "            from repro_torch.core.engine import _auto_name\n"),
    ],
    # the torch engine's fold speedup over the naive engine, measured on
    # the card (chip_smoke.py's engine_speedup)
    "torch speedup": [
        ("    # re-calibrates from a live measurement before simulating.\n"
         "    agg_engine_speedup: Dict[str, float] = field(default_factory="
         "lambda: {\n"
         '        "naive": 1.0, "blocked": 4.0, "jnp": 2.0, "pallas": 8.0,\n'
         "    })\n",
         '    # re-calibrates from a live measurement before simulating.  '
         '"torch"\n'
         "    # (TorchEngine: pinned staging + the fedavg kernels) over "
         '"naive", one\n'
         "    # 44.8 MB ResNet-18 update folded from the host: chip_smoke.py's"
         "\n"
         "    # engine_speedup on an NVIDIA H100 80GB HBM3 (700 W power limit),"
         " the\n"
         "    # median of three runs in one call (4.09-5.59; the host's numpy"
         "\n"
         "    # folds set the spread).\n"
         "    agg_engine_speedup: Dict[str, float] = field(default_factory="
         "lambda: {\n"
         '        "naive": 1.0, "blocked": 4.0, "jnp": 2.0, "pallas": 8.0,\n'
         '        "torch": 5.12,\n'
         "    })\n"),
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
    ("serve/service.py", SERVICE_EDITS),
    ("core/simulation.py", SIMULATION_EDITS),
], ids=["netd", "transport", "service", "simulation"])
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
                                   "tree_from_jax", "aggregation_service"])
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
    from repro_torch.serve import AggregationService

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
            "tree_from_jax": lambda: tree_from_jax({"step": np.int32(0)}),
            "aggregation_service": lambda: AggregationService()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make[entry]()


#: the JAX package's exported names the port has under another name
EXPORT_RENAMES = {"JaxEngine": "TorchEngine"}


@pytest.mark.parametrize("package", ["core", "serve", "obs", "runtime",
                                     "checkpoint"])
def test_package_exports_the_jax_packages_names(package):
    """Each ported package exports what the JAX package's does (its
    ``__all__``, or its public names where it has none), the engine
    renamed."""
    def exported(mod):
        names = getattr(mod, "__all__", None)
        if names is None:
            names = [n for n, v in vars(mod).items()
                     if not n.startswith("_")
                     and not getattr(v, "__name__", "").startswith(
                         mod.__name__ + ".")]
        return {EXPORT_RENAMES.get(n, n) for n in names}

    want = exported(importlib.import_module(f"repro.{package}"))
    got = exported(importlib.import_module(f"repro_torch.{package}"))
    assert got == want


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
