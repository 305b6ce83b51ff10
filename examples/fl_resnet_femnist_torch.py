"""Paper-faithful workload on the PyTorch port: ResNet-18 (reduced) on
non-IID synthetic FEMNIST via the full LIFL control plane — the Fig 9(a)
setup at laptop scale, comparing the LIFL configuration against the
SL-H-style baseline (WorstFit spreading, lazy, no reuse) on the SAME
learning trajectory.

``examples/fl_resnet_femnist.py`` on ``repro_torch``, on the card
unless ``--device`` names another: client SGD and the folds run there
(the fedavg CUDA kernels), the LIFL-vs-SL-H wall-clock comparison is
the cluster simulator's.

Without ``params`` the ResNet's weights come from the port's own
seeded init (``model.init(0)``), not the JAX package's PRNG draw, so
the accuracy and loss differ from ``fl_resnet_femnist.py``'s by the
draw; tests pass the JAX draw as ``params`` (a numpy tree in the JAX
layout).

  PYTHONPATH=src python examples/fl_resnet_femnist_torch.py [--rounds 8] [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.api import Session
from repro_torch.configs.resnet import RESNET18
from repro_torch.convert import params_from_jax
from repro_torch.core import (
    AggregatorPool,
    ClientInfo,
    RoundConfig,
    SimConfig,
    simulate_round,
)
from repro_torch.core.simulation import DataPlaneCosts
from repro_torch.data import build_client_datasets, dirichlet_partition, synthetic_femnist
from repro_torch.device import resolve_device
from repro_torch.models import build_resnet
from repro_torch.runtime import ClientRuntime


def main(argv=None, *, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--goal", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="where to run: the card unless named (e.g. cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = RESNET18.reduced()
    model = build_resnet(cfg)
    params = (model.init(0, device=device) if params is None
              else params_from_jax(params, device=device))
    imgs, labels = synthetic_femnist(1000, num_classes=10, seed=0)
    shards = dirichlet_partition(labels, args.clients, alpha=0.3)
    clients = [
        ClientRuntime(ClientInfo(d.client_id, d.num_samples), d,
                      failure_prob=0.05)
        for d in build_client_datasets(imgs, labels, shards)
    ]
    test = {"images": imgs[:256], "labels": labels[:256]}

    lifl_cfg = SimConfig(n_nodes=5, mc_per_node=20, placement_policy="bestfit",
                         reuse=True, eager=True, dataplane="shm",
                         costs=DataPlaneCosts())
    slh_cfg = SimConfig(n_nodes=5, mc_per_node=20, placement_policy="worstfit",
                        reuse=False, eager=False, dataplane="shm",
                        costs=DataPlaneCosts())
    lifl_pool = AggregatorPool(cold_start_s=2.0)
    wall = {"lifl": 0.0, "sl_h": 0.0}
    print(f"{'round':>5} {'acc':>6} {'loss':>7} {'lifl_t':>8} {'slh_t':>8}")
    with Session.open(
        model, params, clients,
        round_cfg=RoundConfig(aggregation_goal=args.goal, over_provision=1.4,
                              placement_policy="bestfit"),
        device=device,
    ) as sess:
        for r in range(args.rounds):
            sess.run_round(client_lr=0.08, client_batch_size=32)
            ev = sess.evaluate(test)
            lifl = simulate_round(args.goal, lifl_cfg, pool=lifl_pool,
                                  arrival_span_s=8.0)
            slh = simulate_round(args.goal, slh_cfg,
                                 pool=AggregatorPool(cold_start_s=2.0),
                                 arrival_span_s=8.0)
            wall["lifl"] += max(30.0, lifl.act_s)   # eager overlaps training
            wall["sl_h"] += 30.0 + slh.act_s        # lazy adds up
            print(f"{r:5d} {ev['accuracy']:6.3f} {ev['loss']:7.4f} "
                  f"{wall['lifl']:8.1f} {wall['sl_h']:8.1f}")
    print(f"\nsame accuracy, simulated wall-clock: "
          f"LIFL {wall['lifl']:.0f}s vs SL-H {wall['sl_h']:.0f}s "
          f"({wall['sl_h']/wall['lifl']:.2f}x)")
    print("fl_resnet_femnist OK")


if __name__ == "__main__":
    main()
