"""Quickstart on the PyTorch port: one LIFL FL round, end to end.

``examples/quickstart.py`` on ``repro_torch``, on the card unless
``--device`` names another.  Part 1 runs the whole pipeline at toy
scale through the public API:
  Session.open → clients → selector → BestFit placement → EWMA
  hierarchy plan → warm engines → RoundDriver event loop → eager
  hierarchical FedAvg (the fedavg CUDA kernels on the card) → server
  update (plus an externally-submitted update riding a cohort slot),
then part 2 runs the same semantics as one fused FL round a step
through ``FusedFLTrainer``.

Without ``params`` the ResNet's weights come from the port's own
seeded init (``model.init(0)``), not the JAX package's PRNG draw, so
the accuracies and losses differ from ``quickstart.py``'s by the draw;
tests pass the JAX draw as ``params`` (a numpy tree in the JAX layout).

  PYTHONPATH=src python examples/quickstart_torch.py [--fast] [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import torch

from repro_torch.api import Session
from repro_torch.configs import ARCHS
from repro_torch.configs.resnet import RESNET18
from repro_torch.convert import params_from_jax
from repro_torch.core import ClientInfo, NodeState, RoundConfig
from repro_torch.data import build_client_datasets, dirichlet_partition, synthetic_femnist
from repro_torch.data.loader import CohortTokenLoader
from repro_torch.device import resolve_device
from repro_torch.fl.round import AggregationConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ModelOptions, build_resnet
from repro_torch.runtime import ClientRuntime, FusedFLTrainer, UpdateArrived
from repro_torch.tree import tree_map


def part1_paper_faithful(rounds: int = 4, device=None, params=None):
    print("=== Part 1: paper-faithful LIFL round (ResNet-18-reduced, FEMNIST) ===")
    cfg = RESNET18.reduced()
    model = build_resnet(cfg)
    params = (model.init(0, device=device) if params is None
              else params_from_jax(params, device=device))
    imgs, labels = synthetic_femnist(400, num_classes=10, seed=0)
    shards = dirichlet_partition(labels, 12, alpha=0.5)
    clients = [
        ClientRuntime(ClientInfo(d.client_id, d.num_samples), d, failure_prob=0.1)
        for d in build_client_datasets(imgs, labels, shards)
    ]
    test = {"images": imgs[:128], "labels": labels[:128]}
    arrivals = []
    with Session.open(
        model, params, clients,
        nodes={f"node{i}": NodeState(node=f"node{i}", max_capacity=20)
               for i in range(3)},
        round_cfg=RoundConfig(aggregation_goal=6, over_provision=1.5),
        device=device,
    ) as sess:
        sess.on(UpdateArrived, lambda ev: arrivals.append(ev.client_id))
        print("  before:", sess.evaluate(test))
        for r in range(rounds):
            if r == 1:
                # an externally-computed update rides a cohort slot
                # (a params-shaped tree delta; flat vectors work too)
                sess.submit_update(
                    "edge-client",
                    tree_map(torch.zeros_like, sess.params), weight=1.0)
            rec = sess.run_round(client_lr=0.05, client_batch_size=32)
            print(f"  round {r}: updates={rec['updates']:.0f} "
                  f"nodes={rec['nodes_used']:.0f} inter_node={rec['inter_node']:.0f} "
                  f"cold={rec['cold_starts']:.0f} reused={rec['reused']:.0f}")
        print("  after :", sess.evaluate(test))
        m = sess.metrics()
        print(f"  metrics: model_version={m['model_version']} "
              f"events={m['driver']['events_dispatched']} "
              f"arrivals_seen={len(arrivals)}")


def part2_fused_round(rounds: int = 6, device=None):
    print("=== Part 2: the fused FL round, one step a round (tiny llama) ===")
    cfg = ARCHS["llama3.2-3b"].reduced(dtype="float32")
    mesh = make_host_mesh()
    agg = AggregationConfig(hierarchy="flat", timing="eager", num_microbatches=4)
    opts = ModelOptions(attn_impl="chunked", moe_impl="dense", ssm_chunk=8,
                        loss_chunk=16, block_kv=8, remat=False)
    trainer = FusedFLTrainer(cfg, mesh, agg, opts=opts, device=device)
    trainer.init(seed=0)
    loader = CohortTokenLoader(cfg.vocab_size, seq_len=32, n_cohorts=4)
    for r in range(rounds):
        rec = trainer.train_round(loader.round_batch(16, r))
        print(f"  round {r}: loss={rec['loss']:.4f} "
              f"updates={rec['updates_aggregated']:.0f} "
              f"|Δ|={rec['update_norm']:.4f}")


def main(argv=None, *, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where to run: the card unless named (e.g. cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    part1_paper_faithful(rounds=2 if args.fast else 4, device=device,
                         params=params)
    part2_fused_round(rounds=2 if args.fast else 6, device=device)
    print("quickstart OK")


if __name__ == "__main__":
    main()
