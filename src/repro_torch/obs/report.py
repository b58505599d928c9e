"""Trace-driven reporting: Fig. 12-style phase breakdown + load imbalance.

Port of ``repro/obs/report.py`` (numpy only, copied).  Consumes the JSONL
event log written by :class:`repro_torch.obs.Tracer` and renders:

* a **phase table** — total wall time and share per ``phase`` tag across
  measured spans (the paper's Fig. 12: assembly / inference /
  force-reduction shares; the >90%-inference claim is checked here);
* **calibrated stage fractions** — per-stage probe timings recorded by
  scan-mode runs (``calibrated: true`` spans), the Fig. 9 overhead
  decomposition reportable from the fused path;
* a **per-rank imbalance table** — mean/max local+ghost cost per rank over
  time from the ``rank_cost`` step counters, plus the mesh-wide
  ``cost_ratio`` (max/mean) the paper names as the principal bottleneck;
* a **step-counter summary** — steps recorded, rebuilds, overflows,
  neighbor occupancy.

"""
from __future__ import annotations

import numpy as np

from . import export


def load(path: str) -> list[dict]:
    events = export.read_jsonl(path)
    export.validate_events(events)
    return events


def _spans(events, calibrated: bool):
    for ev in events:
        if ev.get("type") != "span" or "phase" not in ev:
            continue
        if bool(ev.get("calibrated", False)) == calibrated:
            yield ev


def phase_table(events: list[dict]) -> dict:
    """Measured wall time per phase tag: {phase: {time_s, count, share}}."""
    agg: dict[str, dict] = {}
    for ev in _spans(events, calibrated=False):
        a = agg.setdefault(ev["phase"], {"time_s": 0.0, "count": 0})
        a["time_s"] += ev["dur"]
        a["count"] += 1
    total = sum(a["time_s"] for a in agg.values())
    for a in agg.values():
        a["share"] = a["time_s"] / total if total else 0.0
    return agg


def stage_fractions(events: list[dict]) -> dict:
    """Calibrated per-stage probe timings: {phase: {time_s, fraction}}."""
    agg: dict[str, float] = {}
    for ev in _spans(events, calibrated=True):
        agg[ev["phase"]] = agg.get(ev["phase"], 0.0) + ev["dur"]
    total = sum(agg.values())
    return {k: {"time_s": v, "fraction": v / total if total else 0.0}
            for k, v in agg.items()}


def _step_events(events):
    return [ev for ev in events if ev.get("type") == "step"]


def imbalance_table(events: list[dict]) -> dict:
    """Per-rank load statistics from the ``rank_cost`` step counters.

    ``rank_cost`` is (P,) per step — or (R, P) under the replica-batched
    drivers, flattened so every (step, replica) sample counts.  Returns
    per-rank mean/max cost plus the time-averaged and worst-step
    ``cost_ratio`` (max-rank cost over mean-rank cost, the paper's
    imbalance figure).

    The ``rank_occupancy`` counter (per-rank neighbor-slot fill fraction,
    ``nbr_fill / nbr_slots`` gathered across the dd mesh) rides along as a
    capacity-tuning column: a rank pinned near 1.0 is about to overflow its
    ``nbr_capacity``; a mesh-wide low mean means the capacity (and with it
    the padded descriptor width) can shrink.
    """
    def _samples(key):
        rows = []
        for ev in _step_events(events):
            v = ev.get(key)
            if v is None:
                continue
            a = np.asarray(v, np.float64)
            rows.extend(a.reshape(-1, a.shape[-1]) if a.ndim > 1 else [a])
        return np.stack(rows) if rows else None

    costs = _samples("rank_cost")                # (samples, P)
    if costs is None:
        return {"ranks": [], "n_samples": 0}
    occ = _samples("rank_occupancy")             # (samples, P) or None
    mean_r = costs.mean(0)
    ratios = costs.max(1) / np.maximum(costs.mean(1), 1e-12)
    ranks = [{"rank": r, "mean_cost": float(mean_r[r]),
              "max_cost": float(costs[:, r].max())}
             for r in range(costs.shape[1])]
    if occ is not None and occ.shape[1] == costs.shape[1]:
        for r, row in enumerate(ranks):
            row["mean_occupancy"] = float(occ[:, r].mean())
            row["max_occupancy"] = float(occ[:, r].max())
    return {
        "n_samples": int(costs.shape[0]),
        "ranks": ranks,
        "cost_ratio_mean": float(ratios.mean()),
        "cost_ratio_max": float(ratios.max()),
    }


def counter_summary(events: list[dict]) -> dict:
    steps = _step_events(events)
    out = {"n_steps": len(steps)}
    if not steps:
        return out

    def total(key):
        return int(sum(np.asarray(ev.get(key, 0)).sum() for ev in steps))

    out["rebuilds"] = total("rebuild")
    out["sp_rebuilds"] = total("sp_rebuild")
    out["overflows"] = total("nlist_overflow") + total("sp_overflow")
    occ = [float(np.asarray(ev["nbr_occupancy"]).mean()) for ev in steps
           if "nbr_occupancy" in ev]
    if occ:
        out["nbr_occupancy_mean"] = float(np.mean(occ))
    return out


def summarize(events: list[dict]) -> dict:
    return {"phases": phase_table(events),
            "stage_fractions": stage_fractions(events),
            "imbalance": imbalance_table(events),
            "counters": counter_summary(events)}


def _fmt_phase_rows(agg: dict, time_key: str, share_key: str) -> list[str]:
    lines = [f"  {'phase':<14}{'time_ms':>12}{'share':>9}{'spans':>8}"]
    for name, a in sorted(agg.items(), key=lambda kv: -kv[1][time_key]):
        cnt = a.get("count", "")
        lines.append(f"  {name:<14}{a[time_key] * 1e3:>12.3f}"
                     f"{a[share_key] * 100:>8.1f}%{cnt:>8}")
    return lines


def render(events: list[dict]) -> str:
    """Human-readable report (the Fig. 12 table + imbalance table)."""
    parts = []
    meta = [ev for ev in events if ev.get("type") == "meta"]
    if meta:
        kv = {k: v for ev in meta for k, v in ev.items() if k != "type"}
        parts.append("run: " + ", ".join(f"{k}={v}" for k, v in kv.items()))

    phases = phase_table(events)
    if phases:
        parts.append("phase breakdown (measured spans, Fig. 12):")
        parts.extend(_fmt_phase_rows(phases, "time_s", "share"))

    frac = stage_fractions(events)
    if frac:
        parts.append("scan-stage fractions (calibrated probes, Fig. 9):")
        lines = [f"  {'stage':<14}{'time_ms':>12}{'fraction':>10}"]
        for name, a in sorted(frac.items(), key=lambda kv: -kv[1]["time_s"]):
            lines.append(f"  {name:<14}{a['time_s'] * 1e3:>12.3f}"
                         f"{a['fraction'] * 100:>9.1f}%")
        parts.extend(lines)

    imb = imbalance_table(events)
    if imb.get("ranks"):
        parts.append(f"per-rank load imbalance "
                     f"({imb['n_samples']} step samples):")
        has_occ = any("mean_occupancy" in row for row in imb["ranks"])
        hdr = f"  {'rank':<6}{'mean cost':>12}{'max cost':>12}"
        if has_occ:
            hdr += f"{'nbr occ':>10}{'occ max':>10}"
        parts.append(hdr)
        for row in imb["ranks"]:
            line = (f"  {row['rank']:<6}{row['mean_cost']:>12.1f}"
                    f"{row['max_cost']:>12.0f}")
            if has_occ:
                line += (f"{row['mean_occupancy']:>9.1%}"
                         f"{row['max_occupancy']:>9.1%}")
            parts.append(line)
        parts.append(f"  cost_ratio (max/mean): "
                     f"mean {imb['cost_ratio_mean']:.3f}, "
                     f"worst step {imb['cost_ratio_max']:.3f}")

    cs = counter_summary(events)
    if cs.get("n_steps"):
        extra = (f", nbr occupancy {cs['nbr_occupancy_mean']:.1%}"
                 if "nbr_occupancy_mean" in cs else "")
        parts.append(f"steps: {cs['n_steps']} recorded, "
                     f"{cs.get('rebuilds', 0)} nlist rebuilds, "
                     f"{cs.get('sp_rebuilds', 0)} dd rebuilds, "
                     f"{cs.get('overflows', 0)} overflows{extra}")
    if not parts:
        parts.append("(empty trace)")
    return "\n".join(parts)
