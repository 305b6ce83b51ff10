"""Elastic scaling through the event protocol (Fig 10(a,b) shape), on
the PyTorch port.

``examples/elastic_scaling.py`` on ``repro_torch``, on the card unless
``--device`` names another.  A varying client arrival rate drives the
EWMA hierarchy planner; the elastic controller and the coordinator are
ordinary event handlers on the Session's round driver:
``NodeLost``/``NodeJoined`` injected with ``Session.emit`` reshape the
*next* round's plan (the warm pool absorbs re-plans without cold
starts), and every re-plan is published as a typed ``ScaleDecision``
event.

Without ``params`` the ResNet's weights come from the port's own
seeded init (``model.init(0)``), not the JAX package's PRNG draw, so
the rounds' updates can differ from ``elastic_scaling.py``'s by the
draw; tests pass the JAX draw as ``params`` (a numpy tree in the JAX
layout).

  PYTHONPATH=src python examples/elastic_scaling_torch.py [--fast] [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.api import Session
from repro_torch.configs.resnet import RESNET18
from repro_torch.convert import params_from_jax
from repro_torch.core import ClientInfo, NodeState, RoundConfig
from repro_torch.data import build_client_datasets, dirichlet_partition, synthetic_femnist
from repro_torch.device import resolve_device
from repro_torch.models import build_resnet
from repro_torch.runtime import (
    ArrivalTrace,
    ClientRuntime,
    ElasticController,
    NodeJoined,
    NodeLost,
    ScaleDecision,
)


def run(rounds: int = 8, device=None, params=None):
    cfg = RESNET18.reduced()
    model = build_resnet(cfg)
    params = (model.init(0, device=device) if params is None
              else params_from_jax(params, device=device))
    imgs, labels = synthetic_femnist(300, num_classes=10, seed=0)
    shards = dirichlet_partition(labels, 10, alpha=0.5)
    clients = [ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
               for d in build_client_datasets(imgs, labels, shards)]
    nodes = {f"n{i}": NodeState(node=f"n{i}", max_capacity=20) for i in range(5)}

    ec = ElasticController(nodes)
    trace = ArrivalTrace(base_rate=40, variability=0.6, period_rounds=6)
    decisions = []

    with Session.open(
        model, params, clients, nodes=nodes,
        round_cfg=RoundConfig(aggregation_goal=4, over_provision=1.5),
        device=device,
    ) as sess:
        # the controller reacts to churn; anyone can watch the decisions
        sess.on(NodeLost, ec.handle)
        sess.on(NodeJoined, ec.handle)
        sess.on(ScaleDecision, decisions.append)

        print(f"{'round':>5} {'arrivals':>9} {'aggs':>5} {'nodes':>6} "
              f"{'updates':>8} {'reused':>7}")
        for r in range(rounds):
            if r == rounds // 2:
                sess.emit(NodeLost(node="n1"))            # pod failure
            if r == rounds - 2:
                sess.emit(NodeJoined(node="n5", capacity=20))  # replacement
            rate = trace.rate(r)
            sess.emit(ec.decide(r, expected_updates=rate))
            rec = sess.run_round(client_lr=0.05, client_batch_size=32)
            d = decisions[-1]
            print(f"{r:5d} {rate:9.1f} {d.aggregators_planned:5d} "
                  f"{rec['nodes_used']:6.0f} {rec['updates']:8.0f} "
                  f"{rec['reused']:7.0f}")

        print("\ncontroller events:")
        for e in ec.events[:12]:
            print(f"  round {e.round_id}: {e.kind} {e.detail}")
        print(f"scale decisions: "
              f"{[f'{d.round_id}:{d.direction}' for d in decisions]}")
    print("elastic_scaling OK")


def main(argv=None, *, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where to run: the card unless named (e.g. cpu)")
    args = ap.parse_args(argv)
    run(rounds=4 if args.fast else 8, device=resolve_device(args.device),
        params=params)


if __name__ == "__main__":
    main()
