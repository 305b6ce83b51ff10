"""The dry-run sweep: every (arch × shape × mesh) cell, resumable.

Each cell runs in-process sequentially (``launch/dryrun.py``: rank 0's
step under fake tensors on the CPU); results land in
``results/dryrun_torch/<tag>.json``.  Existing results are skipped, so
the sweep can be re-launched after fixes.  Failures are recorded as
status=error and do not stop the sweep.

  PYTHONPATH=src python -m repro_torch.launch.sweep [--mesh single,multi]
      [--arch a,b,...] [--shape s,...] [--force]
      [--out results/dryrun_torch]
"""
import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.dryrun import run_cell

# riskiest families first so structural failures surface early
ARCH_ORDER = [
    "llama3.2-3b",
    "deepseek-v2-lite-16b",
    "falcon-mamba-7b",
    "hymba-1.5b",
    "seamless-m4t-large-v2",
    "gemma3-4b",
    "internvl2-26b",
    "kimi-k2-1t-a32b",
    "gemma3-12b",
    "h2o-danube-3-4b",
]
SHAPE_ORDER = ["train_4k", "decode_32k", "prefill_32k", "long_500k"]


def tag_for(arch, shape, mesh, hierarchy, timing, compress):
    return f"{arch}_{shape}_{mesh}_{hierarchy}_{timing}_{compress}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--arch", default=",".join(ARCH_ORDER))
    ap.add_argument("--shape", default=",".join(SHAPE_ORDER))
    ap.add_argument("--hierarchy", default="hierarchical")
    ap.add_argument("--timing", default="eager")
    ap.add_argument("--compress", default="none")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    cells = [
        (a, s, m)
        for a in args.arch.split(",")
        for s in args.shape.split(",")
        for m in args.mesh.split(",")
    ]
    print(f"sweep: {len(cells)} cells -> {outdir}", flush=True)
    t_start = time.time()
    n_ok = n_skip = n_err = 0
    for arch, shape, mesh in cells:
        tag = tag_for(arch, shape, mesh, args.hierarchy, args.timing, args.compress)
        path = outdir / f"{tag}.json"
        if path.exists() and not args.force:
            prev = json.loads(path.read_text())
            if prev.get("status") in ("ok", "skipped"):
                n_skip += 1
                continue
        t0 = time.time()
        try:
            rec = run_cell(
                arch, shape, mesh,
                hierarchy=args.hierarchy, timing=args.timing,
                compress=args.compress, verbose=False,
            )
        except Exception as e:
            rec = {
                "arch": arch, "shape": shape, "mesh": mesh,
                "hierarchy": args.hierarchy, "timing": args.timing,
                "compress": args.compress,
                "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-3000:],
            }
        rec["wall_s"] = round(time.time() - t0, 1)
        path.write_text(json.dumps(rec, indent=1))
        st = rec["status"]
        n_ok += st == "ok"
        n_err += st == "error"
        extra = ""
        if st == "ok":
            r = rec["roofline"]
            extra = (f"dom={r['dominant']} frac={r['roofline_fraction']:.3f} "
                     f"mem={rec['memory'].get('peak_bytes_per_device', 0)/1e9:.1f}GB")
        elif st == "error":
            extra = rec["error"][:120]
        print(f"[{time.time()-t_start:7.0f}s] {tag}: {st} "
              f"({rec['wall_s']}s) {extra}", flush=True)
    print(f"done: ok={n_ok} skipped/cached={n_skip} err={n_err}", flush=True)


if __name__ == "__main__":
    main()
