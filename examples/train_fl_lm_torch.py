"""End-to-end driver on the PyTorch port: federated training of a
~100M-parameter LM for a few hundred rounds with the full stack —
federated data pipeline, fused LIFL rounds (eager FedAvg of the cohorts'
updates, then the server optimizer, FedAdam by default), in-step sidecar
metrics, async checkpointing, checkpoint/restart.

``examples/train_fl_lm.py`` on ``repro_torch``, on the card unless
``--device`` names another.  A checkpoint is written every 50 rounds,
so a run leaves one only from round 50 on; ``--resume`` restarts from
the latest with the server optimizer's state rebuilt from scratch, as
the JAX package's ``maybe_restore`` does (FedAdam's moments and step
start again at 0).

Without ``params`` the weights come from the port's own seeded init
(``model.init(0)``), not the JAX package's PRNG draw, so the losses
differ from ``train_fl_lm.py``'s by the draw; tests pass the JAX draw
as ``params`` (a numpy tree in the JAX layout).

  PYTHONPATH=src python examples/train_fl_lm_torch.py [--rounds 200] [--resume] [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import dataclasses

from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.loader import CohortTokenLoader
from repro_torch.device import resolve_device
from repro_torch.fl.round import AggregationConfig
from repro_torch.fl.server import init_server_state
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ModelOptions
from repro_torch.runtime import FusedFLTrainer


def build_100m_config():
    """A ~100M-param llama-family config (12L, d=768, 12H/4KV, ff=2048)."""
    base = ARCHS["llama3.2-3b"]
    return dataclasses.replace(
        base,
        name="llama-fl-100m",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=32000,
        dtype="float32",
    )


def main(argv=None, *, params=None):
    """-> the trainer, after its last round."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--cohorts", type=int, default=4)
    ap.add_argument("--ckpt", default="results/fl_lm_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--server-opt", default="fedadam")
    ap.add_argument("--device", default=None,
                    help="where to run: the card unless named (e.g. cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = build_100m_config()
    print(f"model: {cfg.name} params={cfg.param_count()/1e6:.1f}M")
    mesh = make_host_mesh()
    agg = AggregationConfig(
        hierarchy="flat",              # single host 'pod'
        timing="eager",
        num_microbatches=args.cohorts,
        server_opt=args.server_opt,
        server_lr=3e-3 if args.server_opt == "fedadam" else 0.7,
    )
    opts = ModelOptions(attn_impl="chunked", moe_impl="dense",
                        loss_chunk=128, block_kv=128, remat=True)
    trainer = FusedFLTrainer(cfg, mesh, agg, opts=opts, device=device,
                             checkpoint_dir=args.ckpt, checkpoint_every=50)
    if args.resume and trainer.maybe_restore():
        print(f"resumed from round {trainer.round_id}")
    elif params is not None:
        trainer.params = lm_params_from_jax(params, device=device)
        trainer.server_state = init_server_state(agg.server_opt,
                                                 trainer.params)
    else:
        trainer.init(seed=0)

    loader = CohortTokenLoader(cfg.vocab_size, args.seq, args.cohorts)
    t0 = time.time()
    for r in range(trainer.round_id, args.rounds):
        rec = trainer.train_round(loader.round_batch(args.batch, r))
        if r % 10 == 0 or r == args.rounds - 1:
            tok_s = args.batch * args.seq * (r + 1 - trainer.round_id + 1) / max(
                time.time() - t0, 1e-9)
            print(f"round {r:4d} loss={rec['loss']:.4f} "
                  f"|Δ|={rec['update_norm']:.3f} ({tok_s:,.0f} tok/s)",
                  flush=True)
    if trainer.ckpt:
        trainer.ckpt.wait()
    print("final loss:", trainer.history[-1]["loss"])
    return trainer


if __name__ == "__main__":
    main()
