"""The JAX package's hill-climb variants of three cells, dry-run by the
port (``launch/dryrun.py``).

  K-series: kimi-k2-1t-a32b × train_4k  (collective-bound)
  G-series: gemma3-12b × train_4k × multi (the paper's aggregation tier)
  F-series artifacts are produced by the main sweep (ssm defaults).

  PYTHONPATH=src python -m repro_torch.launch.variants [--only K1,G2,...]
      [--out results/variants_torch]
"""
import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.launch.dryrun import run_cell

VARIANTS = {
    # ---- K: kimi collective term --------------------------------------
    # K0 baseline comes from the sweep (hier/eager/none, micro=4, fp32 acc)
    "K1_micro1_bf16acc": dict(
        arch_name="kimi-k2-1t-a32b", shape_name="train_4k", mesh_kind="single",
        micro=1, acc_dtype="bfloat16",
    ),
    "K2_multi_baseline": dict(
        arch_name="kimi-k2-1t-a32b", shape_name="train_4k", mesh_kind="multi", micro=4,
    ),
    "K3_multi_int8": dict(
        arch_name="kimi-k2-1t-a32b", shape_name="train_4k", mesh_kind="multi",
        compress="int8", micro=4,
    ),
    "K4_multi_flat": dict(
        arch_name="kimi-k2-1t-a32b", shape_name="train_4k", mesh_kind="multi",
        hierarchy="flat", micro=4,
    ),
    # ---- G: gemma3-12b, the paper's knobs on the DCN tier --------------
    # G0 multi hier/eager/none baseline from the sweep
    "G1_flat": dict(
        arch_name="gemma3-12b", shape_name="train_4k", mesh_kind="multi", hierarchy="flat",
    ),
    "G2_int8": dict(
        arch_name="gemma3-12b", shape_name="train_4k", mesh_kind="multi", compress="int8",
    ),
    "G3_windowed_kv": dict(
        # same settings as the sweep baseline; the window-limited KV ring
        # (models/flash.py) is active in this process — the delta vs the
        # sweep JSON is the G3 effect
        arch_name="gemma3-12b", shape_name="train_4k", mesh_kind="multi",
    ),
    "G4_lazy": dict(
        arch_name="gemma3-12b", shape_name="train_4k", mesh_kind="multi", timing="lazy",
    ),
    # eager-vs-lazy memory effect on a big-update arch (queue blowup)
    "G5_lazy_single": dict(
        arch_name="gemma3-12b", shape_name="train_4k", mesh_kind="single", timing="lazy",
    ),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    ap.add_argument("--out", default="results/variants_torch")
    args = ap.parse_args()
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    only = set(args.only.split(",")) if args.only else None

    for name, kw in VARIANTS.items():
        if only and name not in only:
            continue
        path = outdir / f"{name}.json"
        if path.exists():
            print(f"{name}: cached", flush=True)
            continue
        t0 = time.time()
        try:
            rec = run_cell(verbose=False, **kw)
            rec["variant"] = name
        except Exception as e:
            rec = {"variant": name, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        rec["wall_s"] = round(time.time() - t0, 1)
        path.write_text(json.dumps(rec, indent=1))
        if rec.get("status") == "ok":
            r = rec["roofline"]
            print(f"{name}: compute={r['compute_s']:.2f}s "
                  f"mem={r['memory_s']:.2f}s coll={r['collective_s']:.2f}s "
                  f"dcn={r['dcn_s']:.2f}s dom={r['dominant']} "
                  f"frac={r['roofline_fraction']:.4f} ({rec['wall_s']}s)",
                  flush=True)
        else:
            print(f"{name}: {rec.get('error', rec.get('status'))}", flush=True)


if __name__ == "__main__":
    main()
