"""Continuous aggregation on the PyTorch port: two jobs sharing one
2-node fleet.

``examples/serve_gateway.py`` on ``repro_torch``, on the card unless
``--device`` names another: the daemons fold through the fedavg
kernels there, and the service's own engines live there.  LIFL's
serving story, end to end.  An
:class:`AggregationService` owns a single fleet (two netd daemons over
loopback TCP), a single rolling :class:`RoundDriver` (two rounds in
flight), and a shared coordinator whose weighted fair-share splits node
capacity 2:1 between the jobs.  Clients push updates whenever they
finish — a thread per job here, plus one real separate OS process over
the wire, which imports ``repro_torch`` alone and pushes its updates
before the threads start (a pusher that fails fails the run) — and the
ingress gateway decides, per submission, admit / busy-with-retry-hint /
duplicate.  The service opens, fills, and closes rounds continuously;
round N+1 spawns while round N's top fold is still in flight.

The jobs' params are zeros unless ``params`` (a numpy tree in the JAX
layout, ``{"w": (1024,)}``) is given; the pushers' updates come from a
seeded numpy generator, as in ``serve_gateway.py``.  Which pusher lands
in which round depends on timing, in both packages.

  PYTHONPATH=src python examples/serve_gateway_torch.py [--fast] [--device cpu]
"""
import argparse
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import numpy as np
import torch

from repro_torch.convert import tree_from_jax
from repro_torch.core import ClientInfo, NodeState, RoundConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.obs import summary_line, to_prometheus
from repro_torch.runtime.netrt import (RemoteRuntime, reap_local_daemon,
                                       spawn_local_daemon)
from repro_torch.serve import (
    AdmissionPolicy, AggregationService, DeadlinePolicy, MinCohortIdleGap,
    SLOTarget,
)

SRC = str(Path(__file__).parent.parent / "src")
N = 1024

#: the external client's whole program: it imports the port alone
PUSHER = (
    "import sys\n"
    "import numpy as np\n"
    "from repro_torch.runtime.netrt import push_update\n"
    "addr, n = sys.argv[1], int(sys.argv[2])\n"
    "for k in range(8):\n"
    "    push_update(addr, f'edge-{k}', np.ones(n, np.float32), "
    "job='mnist', submission_id=f'edge-{k}')\n"
    "print('edge client: 8 updates pushed')\n")


class Model:
    """Jobs here are pure aggregation consumers — updates arrive from
    the outside, the service never runs local training."""

    def loss(self, params, batch):
        return torch.sum(params["w"] ** 2), {}


class _CloseAny:
    def __init__(self, *pols):
        self.pols = pols

    def should_close(self, **kw):
        return any(p.should_close(**kw) for p in self.pols)


def run(fast: bool = False, device=None, params=None):
    rounds = 3 if fast else 6
    print("=== Continuous aggregation: 2 jobs, 2 netd nodes, rolling ===")
    # default spawn = per-daemon log file (proc.lifl_log_path), so an
    # orphaned daemon can never hang this process's pipes
    daemons = []
    svc = None
    try:
        for i in range(2):
            daemons.append(spawn_local_daemon(
                f"node{i}", runtime="inproc", timeout=120.0,
                device=str(device)))
        rt = RemoteRuntime([a for _, a in daemons], agg_engine=EngineConfig(
            name="auto", device=str(device)))
        nodes = {n: NodeState(node=n, max_capacity=cap)
                 for n, cap in rt.node_info().items()}
        svc = AggregationService(
            nodes, runtime=rt,
            admission=AdmissionPolicy(max_queue=64, job_quota=32,
                                      retry_base_s=0.01),
            device=str(device))
        params = ({"w": torch.zeros((N,), dtype=torch.float32,
                                    device=device)}
                  if params is None else tree_from_jax(params, device=device))
        for job, weight in (("mnist", 2.0), ("speech", 1.0)):
            svc.add_job(
                job, Model(), params,
                [ClientInfo(client_id=f"{job}-c{i}", num_samples=10)
                 for i in range(8)],
                weight=weight,
                round_cfg=RoundConfig(aggregation_goal=4),
                slo=SLOTarget(p99_tta_s=30.0, max_shed_frac=0.9))
        for job in svc.jobs:
            print(f"job {job!r}: "
                  f"fair-share={svc.coordinator.job_share(job):.2f}")

        # the live-telemetry loop: scrape both daemons' stats frames on
        # a jittered period, mid-round included, feeding the SLO tracker
        svc.start_monitor(period_s=0.25)

        addr = svc.serve("127.0.0.1:0")
        print(f"serving on {addr} (jobs route by frame meta)")

        # one genuinely external pusher process over the wire, run to its
        # end before the threads start: started beside them, it reaches
        # its job once the fast rounds are over, finds the queue at its
        # quota with no round left to drain it, and gives up
        env = dict(os.environ)
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        subprocess.run([sys.executable, "-c", PUSHER, addr, str(N)],
                       env=env, check=True, timeout=300)

        # one pusher thread per job: push until told to stop, honour
        # busy verdicts by sleeping the server's retry hint
        stop = threading.Event()
        rng = np.random.default_rng(0)
        flats = {}

        def pusher(job):
            k = 0
            while not stop.is_set():
                cid = f"{job}-u{k}"
                flat = flats.setdefault(
                    cid, rng.standard_normal(N).astype(np.float32))
                v = svc.submit(job, cid, flat, 1.0 + k % 3,
                               submission_id=cid)
                if v["admitted"]:
                    k += 1
                    time.sleep(0.002)
                else:
                    time.sleep(v["retry_after_s"])

        threads = [threading.Thread(target=pusher, args=(j,), daemon=True)
                   for j in ("mnist", "speech")]
        for t in threads:
            t.start()

        t0 = time.perf_counter()
        try:
            recs = svc.run_rounds(
                {"mnist": rounds, "speech": rounds},
                policy=_CloseAny(MinCohortIdleGap(min_cohort=2,
                                                  idle_gap_s=0.05),
                                 DeadlinePolicy(deadline_s=20.0)))
            wall = time.perf_counter() - t0
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)

        for rec in recs:
            print(f"  ticket {rec['ticket']}: job={rec['job']} "
                  f"round={rec['round']} cohort={len(rec['cohort'])} "
                  f"wall={rec['t_close'] - rec['t_open']:.2f}s")
        m = svc.ingress_metrics()
        print(f"{2 * rounds} rounds in {wall:.2f}s  "
              f"pipeline_overlap={svc.pipeline_overlap():.2f}")
        print(f"ingress: admitted={m['admitted']} shed={m['shed']} "
              f"duplicates={m['duplicates']} queued_now={m['queued_now']}")
        # one fleet snapshot, rendered both ways
        snap = svc.health()
        print("health:", summary_line(snap))
        prom = to_prometheus(snap)
        print(f"prometheus export: {len(prom.splitlines())} samples, e.g.")
        for line in prom.splitlines():
            if "tta_seconds" in line or "_node_up" in line:
                print("  " + line)
        mon = snap["monitor"]
        print(f"monitor: {mon['scrapes']} scrapes "
              f"({mon['mid_round_scrapes']} mid-round), "
              f"{mon['stale_events']} stale events")
        assert svc.pipeline_overlap() > 0, "rounds never overlapped"
        assert mon["scrapes"] > 0, "monitor never scraped the fleet"
    finally:
        if svc is not None:
            svc.close()
        for proc, _ in daemons:
            reap_local_daemon(proc)
    print("done: two jobs, one fleet, rounds rolling — no silent drops.")


def main(argv=None, *, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where to run: the card unless named (e.g. cpu)")
    args = ap.parse_args(argv)
    run(fast=args.fast, device=resolve_device(args.device), params=params)


if __name__ == "__main__":
    main()
