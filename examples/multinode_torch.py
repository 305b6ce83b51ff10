"""Multi-node LIFL on the PyTorch port: two netd daemons, one Session,
node-rooted rounds.

``examples/multinode.py`` on ``repro_torch``, on the card unless
``--device`` names another: the Session's clients train there and each
daemon folds there (``netd --device``), each daemon its own process
with its own CUDA context.  Spawns two per-node daemons as real OS
processes (each owning its own local runtime — shared-memory workers
where /dev/shm exists), connects a Session to the fleet, and drives
hierarchical rounds under the **node-top** fold topology: the round's
top fold runs ON the busiest worker node (the FoldPlan root), the other
node ships its sealed partial daemon→daemon, and only the final folded
Σ c·u returns to the controller — ~1 × model per round instead of
nodes × model.  Then turns the session into an ingest endpoint
(`serve`) and pushes an external update over the wire from a separate
process that imports ``repro_torch`` alone, exactly as an edge client
would.  A daemon or the pusher that dies fails the run.

Without ``params`` the ResNet's weights come from the port's own
seeded init (``model.init(0)``), not the JAX package's PRNG draw, so
the rounds can differ from ``multinode.py``'s by the draw; tests pass
the JAX draw as ``params`` (a numpy tree in the JAX layout).

  PYTHONPATH=src python examples/multinode_torch.py [--fast] [--device cpu]
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.api import Session
from repro_torch.configs.resnet import RESNET18
from repro_torch.convert import params_from_jax
from repro_torch.core import ClientInfo, RoundConfig
from repro_torch.data import build_client_datasets, dirichlet_partition, synthetic_femnist
from repro_torch.device import resolve_device
from repro_torch.models import build_resnet
from repro_torch.runtime import ClientRuntime, PartialReady
from repro_torch.runtime.events import PartialShipped, TopFolded
from repro_torch.runtime.netrt import reap_local_daemon, spawn_local_daemon
from repro_torch.tree import tree_leaves

SRC = str(Path(__file__).parent.parent / "src")

#: the external client's whole program: it imports the port alone
PUSHER = (
    "import sys\n"
    "import numpy as np\n"
    "from repro_torch.runtime.netrt import push_update\n"
    "addr, n = sys.argv[1], int(sys.argv[2])\n"
    "print('client:', push_update(addr, 'edge-0', "
    "np.zeros(n, np.float32), weight=2.0))\n")


def run(fast: bool = False, device=None, params=None):
    rounds = 2 if fast else 4
    node_rt = "shmproc" if os.path.isdir("/dev/shm") else "inproc"
    print(f"=== Multi-node LIFL: 2 × netd({node_rt}) over loopback TCP ===")

    cfg = RESNET18.reduced()
    model = build_resnet(cfg)
    params = (model.init(0, device=device) if params is None
              else params_from_jax(params, device=device))
    imgs, labels = synthetic_femnist(240, num_classes=10, seed=0)
    shards = dirichlet_partition(labels, 10, alpha=0.5)
    clients = [ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
               for d in build_client_datasets(imgs, labels, shards)]

    # capacity 4 < the over-provisioned cohort: the locality packer must
    # spill onto the second node, so the round actually exercises the
    # daemon→daemon partial ship (capacity 20 would fit on one node)
    daemons = []
    try:
        for i in range(2):
            daemons.append(spawn_local_daemon(
                f"node{i}", runtime=node_rt, capacity=4, timeout=120.0,
                device=str(device)))
        addrs = [a for _, a in daemons]
        with Session.open(
            model, params, clients, nodes=addrs,     # ← multi-node mode
            round_cfg=RoundConfig(aggregation_goal=4, over_provision=1.5,
                                  placement_policy="locality",
                                  topology="node"),  # ← node-side top fold
            device=device,
        ) as s:
            print(f"connected nodes: {list(s.nodes)}  "
                  f"(runtime={s.metrics()['runtime']})")
            n_model = sum(l.numel() for l in tree_leaves(params))
            model_mb = 4 * n_model / 1e6
            s.on(PartialReady,
                 lambda ev: print(f"  partial from {ev.agg_id}: "
                                  f"count={ev.count} Σc={ev.weight:.0f}"))
            s.on(PartialShipped,
                 lambda ev: print(f"  partial shipped {ev.src} → {ev.dst} "
                                  f"({ev.nbytes / 1e6:.2f} MB, "
                                  f"daemon→daemon)"))
            s.on(TopFolded,
                 lambda ev: print(f"  round rooted on {ev.node} "
                                  f"(tier={ev.tier}): top folded "
                                  f"count={ev.count}"))
            rx0 = 0.0
            for _ in range(rounds):
                rec = s.run_round(client_lr=0.05)
                rx1 = s.metrics()["sidecar"].get("net/rx_bytes", 0.0)
                ret_mb = (rx1 - rx0) / 1e6
                rx0 = rx1
                ctrl_mb = rec["nodes_used"] * model_mb
                print(f"round {int(rec['round'])}: updates={rec['updates']:.0f} "
                      f"nodes_used={rec['nodes_used']:.0f} "
                      f"workers={rec['workers']:.0f} "
                      f"wall={rec['wall_s']:.2f}s  return={ret_mb:.2f} MB "
                      f"(controller-top would return {ctrl_mb:.2f} MB)")
                # the TTA breakdown (§4.3): driver spans + each daemon's
                # telemetry, drained over the wire, one line per tier
                trace = s.trace()
                print(f"  {trace.summary()}")
                ship_s, ships = trace.telemetry_series("netd/ship_s")
                if ships:
                    print(f"  telemetry: {ships} partial ship(s) "
                          f"{ship_s * 1e3:.1f}ms on the shipping daemon, "
                          f"nodes drained: {sorted(trace.telemetry)}")

            # --- serve mode: external client process pushes an update --
            addr = s.serve("127.0.0.1:0")
            env = dict(os.environ)
            env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
            subprocess.run([sys.executable, "-c", PUSHER, addr,
                            str(n_model)], env=env, check=True, timeout=300)
            rec = s.run_round(client_lr=0.05)
            print(f"round {int(rec['round'])} (with external update): "
                  f"updates={rec['updates']:.0f}")
            print("sidecar bytes:",
                  {k: int(v) for k, v in s.metrics()["sidecar"].items()
                   if k.endswith("tx_bytes")})
    finally:
        for proc, _ in daemons:
            reap_local_daemon(proc)
    print("done: cross-node rounds drove the same RoundDriver loop; only "
          "sealed partials crossed the wire.")


def main(argv=None, *, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where to run: the card unless named (e.g. cpu)")
    args = ap.parse_args(argv)
    run(fast=args.fast, device=resolve_device(args.device), params=params)


if __name__ == "__main__":
    main()
