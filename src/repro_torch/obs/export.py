"""Render a fleet health snapshot for machines and humans.

Input is the structured dict ``AggregationService.health()`` /
``Session.status()`` return; output is either Prometheus text
exposition format (``to_prometheus``) — the lingua franca every
metrics server scrapes, the repro's stand-in for the paper's metrics
server ingest — or a one-line operator summary (``summary_line``).

Pure functions over plain dicts: no service types imported, so the
renderer works on a snapshot that crossed a process boundary as JSON.
"""
from __future__ import annotations

from typing import Any, Dict, List

__all__ = ["summary_line", "to_prometheus"]

_QUANTS = ("p50", "p90", "p99")


def _esc(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _line(out: List[str], name: str, value: Any,
          **labels: Any) -> None:
    try:
        v = float(value)
    except (TypeError, ValueError):
        return
    if labels:
        lab = ",".join(f'{k}="{_esc(labels[k])}"' for k in sorted(labels))
        out.append(f"{name}{{{lab}}} {v:g}")
    else:
        out.append(f"{name} {v:g}")


def to_prometheus(snap: Dict[str, Any], prefix: str = "lifl") -> str:
    """Prometheus text format (one sample per line, sorted label sets,
    trailing newline) from a health snapshot."""
    out: List[str] = []
    for key in ("open_rounds", "gateway_queue_depth",
                "fleet_nodes_alive", "rounds_closed"):
        if key in snap:
            _line(out, f"{prefix}_{key}", snap[key])

    for job, j in sorted(dict(snap.get("jobs") or {}).items()):
        _line(out, f"{prefix}_job_queue_depth", j.get("queue_depth"),
              job=job)
        _line(out, f"{prefix}_job_rounds_total", j.get("rounds"), job=job)
        tta = j.get("tta") or {}
        for q in _QUANTS:
            _line(out, f"{prefix}_job_tta_seconds", tta.get(q),
                  job=job, quantile=q)
        _line(out, f"{prefix}_job_tta_count", tta.get("count"), job=job)
        slo = j.get("slo") or {}
        _line(out, f"{prefix}_job_slo_breached", int(bool(
            slo.get("breached"))), job=job)
        _line(out, f"{prefix}_job_shed_frac", slo.get("shed_frac"),
              job=job)

    gw = snap.get("gateway") or {}
    for k, v in sorted(dict(gw.get("counters") or {}).items()):
        _line(out, f"{prefix}_gateway_{k}_total", v)
    _line(out, f"{prefix}_gateway_queue_depth", gw.get("queue_depth"))
    _line(out, f"{prefix}_gateway_retry_after_seconds",
          gw.get("retry_after_s_now"))
    ing = gw.get("ingest") or {}
    for q in _QUANTS:
        _line(out, f"{prefix}_gateway_ingest_seconds", ing.get(q),
              quantile=q)
    _line(out, f"{prefix}_gateway_ingest_count", ing.get("count"))

    for node, f in sorted(dict(snap.get("fleet") or {}).items()):
        _line(out, f"{prefix}_node_up", 0 if f.get("stale") else 1,
              node=node)
        _line(out, f"{prefix}_node_uptime_seconds", f.get("uptime_s"),
              node=node)
        _line(out, f"{prefix}_node_epoch", f.get("epoch"), node=node)
        for k, v in sorted(dict(f.get("health") or {}).items()):
            _line(out, f"{prefix}_node_{k}", v, node=node)

    for k, v in sorted(dict(snap.get("driver") or {}).items()):
        _line(out, f"{prefix}_driver_{k}_total", v)

    mon = snap.get("monitor") or {}
    _line(out, f"{prefix}_monitor_scrapes_total", mon.get("scrapes"))
    _line(out, f"{prefix}_monitor_mid_round_scrapes_total",
          mon.get("mid_round_scrapes"))
    _line(out, f"{prefix}_monitor_stale_events_total",
          mon.get("stale_events"))
    _line(out, f"{prefix}_monitor_scrape_wall_seconds",
          mon.get("scrape_wall_s"))
    return "\n".join(out) + "\n"


def summary_line(snap: Dict[str, Any]) -> str:
    """One operator-readable line: fleet liveness, rounds, gateway
    pressure, and each job's p99 TTA + SLO state."""
    fleet = dict(snap.get("fleet") or {})
    stale = sorted(n for n, f in fleet.items() if f.get("stale"))
    parts = [
        f"fleet {snap.get('fleet_nodes_alive', '?')}/{len(fleet)} up"
        + (f" (stale: {','.join(stale)})" if stale else ""),
        f"rounds open={snap.get('open_rounds', 0)} "
        f"closed={snap.get('rounds_closed', 0)}",
    ]
    gw = snap.get("gateway") or {}
    counters = gw.get("counters") or {}
    parts.append(
        f"gateway q={gw.get('queue_depth', 0)} "
        f"admitted={counters.get('admitted', 0)} "
        f"shed={counters.get('shed', 0)} "
        f"retry={float(gw.get('retry_after_s_now') or 0.0) * 1e3:.0f}ms")
    for job, j in sorted(dict(snap.get("jobs") or {}).items()):
        tta = j.get("tta") or {}
        slo = j.get("slo") or {}
        flag = " SLO-BREACH" if slo.get("breached") else ""
        parts.append(f"{job or '<job>'}: "
                     f"p99={float(tta.get('p99') or 0.0) * 1e3:.0f}ms"
                     f"{flag}")
    return " | ".join(parts)
