"""Render the dry-run/roofline result JSONs into EXPERIMENTS.md tables.

  PYTHONPATH=src python -m repro_torch.analysis.report results/dryrun
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List

ACTIVE_PARAMS = {}


def _fraction(r, arch):
    """Recompute decode-aware fraction from the record (older records
    lack model_bytes)."""
    ro = r["roofline"]
    if "ideal_s" in ro:
        return ro["roofline_fraction"]
    if r["shape"] in ("decode_32k", "long_500k"):
        try:
            from repro_torch.configs import get_arch

            mb = 2.0 * get_arch(arch).active_param_count()
        except Exception:
            return ro["roofline_fraction"]
        ideal = max(ro["model_flops"] / (r["chips"] * 197e12),
                    mb / (r["chips"] * 819e9))
        return ideal / ro["step_time_s"] if ro["step_time_s"] else 0.0
    return ro["roofline_fraction"]


ARCH_ORDER = [
    "seamless-m4t-large-v2", "h2o-danube-3-4b", "gemma3-4b", "gemma3-12b",
    "llama3.2-3b", "hymba-1.5b", "internvl2-26b", "kimi-k2-1t-a32b",
    "deepseek-v2-lite-16b", "falcon-mamba-7b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

V5E_HBM = 16e9


def load(outdir: Path, variant=("hierarchical", "eager", "none")) -> Dict:
    recs = {}
    for f in outdir.glob("*.json"):
        r = json.loads(f.read_text())
        key = (r["arch"], r["shape"], r["mesh"],
               r.get("hierarchy"), r.get("timing"), r.get("compress"))
        recs[key] = r
    return {
        (a, s, m): r
        for (a, s, m, h, t, c), r in recs.items()
        if (h, t, c) == variant
    }


def _fmt_t(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}µs"


def dryrun_table(recs: Dict, mesh: str) -> List[str]:
    lines = [
        "| arch | shape | status | peak HBM/chip | fits v5e | FLOPs/chip | HBM bytes/chip | coll bytes/chip (DCN) | compile |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, mesh))
            if r is None:
                lines.append(f"| {a} | {s} | MISSING | | | | | | |")
                continue
            if r["status"] == "skipped":
                lines.append(f"| {a} | {s} | skipped ({r['reason'][:40]}…) | | | | | | |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {a} | {s} | ERROR | | | | | | |")
                continue
            mem = r["memory"].get("peak_bytes_per_device", 0)
            c = r["cost"]
            fits = "✓" if mem <= V5E_HBM else f"✗ ({mem/V5E_HBM:.1f}×)"
            lines.append(
                f"| {a} | {s} | ok | {mem/1e9:.1f} GB | {fits} "
                f"| {c['flops']:.2e} | {c['bytes']:.2e} "
                f"| {c['coll_total']:.2e} ({c['coll_dcn']:.1e}) "
                f"| {r['compile_s']:.0f}s |"
            )
    return lines


def roofline_table(recs: Dict, mesh: str) -> List[str]:
    lines = [
        "| arch | shape | compute | memory | collective | dominant | MODEL_FLOPS | useful | roofline frac | bottleneck note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, mesh))
            if r is None or r["status"] != "ok":
                status = "skipped" if (r and r["status"] == "skipped") else "—"
                lines.append(f"| {a} | {s} | {status} | | | | | | | |")
                continue
            ro = r["roofline"]
            note = _note(ro)
            lines.append(
                f"| {a} | {s} | {_fmt_t(ro['compute_s'])} | {_fmt_t(ro['memory_s'])} "
                f"| {_fmt_t(ro['collective_s'])} | **{ro['dominant']}** "
                f"| {ro['model_flops']:.2e} | {ro['useful_ratio']:.2f} "
                f"| {_fraction(r, a):.3f} | {note} |"
            )
    return lines


def _note(ro: Dict) -> str:
    d = ro["dominant"]
    if d == "compute":
        if ro["useful_ratio"] < 0.5:
            return "cut non-model FLOPs (remat/rect. attention/dispatch)"
        return "near compute roof; overlap collectives"
    if d == "memory":
        return "raise arithmetic intensity (fuse flash/loop blocks, bf16 temps)"
    return "cut bytes on the wire (hierarchical schedule, int8, overlap)"


def summary(recs: Dict, mesh: str) -> List[str]:
    oks = [r for (a, s, m), r in recs.items() if m == mesh and r["status"] == "ok"]
    doms = {}
    for r in oks:
        doms[r["roofline"]["dominant"]] = doms.get(r["roofline"]["dominant"], 0) + 1
    worst = sorted(oks, key=lambda r: _fraction(r, r["arch"]))[:3]
    lines = [f"- {len(oks)} cells ok on {mesh}; dominant terms: {doms}"]
    for r in worst:
        lines.append(
            f"- worst roofline: {r['arch']}×{r['shape']} "
            f"frac={_fraction(r, r['arch']):.4f} "
            f"dom={r['roofline']['dominant']}"
        )
    return lines


def main():
    outdir = Path(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun")
    recs = load(outdir)
    for mesh in ("single", "multi"):
        print(f"\n### Dry-run — {mesh} pod\n")
        print("\n".join(dryrun_table(recs, mesh)))
        print(f"\n### Roofline — {mesh} pod\n")
        print("\n".join(roofline_table(recs, mesh)))
        print()
        print("\n".join(summary(recs, mesh)))


if __name__ == "__main__":
    main()
