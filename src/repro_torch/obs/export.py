"""Trace export: JSONL event log + Chrome-trace (Perfetto) conversion.

Port of ``repro/obs/export.py`` (pure Python, copied): the same schema, so
a trace the port records validates and renders with either package.

The on-disk event schema (one JSON object per line):

==========  ===============================================================
``meta``    free-form run metadata (engine class, atom counts, loop mode)
``span``    host wall-clock interval: ``name``, ``ts`` (s since trace
            epoch), ``dur`` (s), optional ``phase`` attribution tag,
            optional ``tid``; extra keys are attributes
``instant``  point event: ``name``, ``ts``
``step``    device-side per-step counters: ``step`` (absolute MD step) plus
            numeric / bool / (nested) list payload keys straight from the
            dd diag arrays (``local_count``, ``rank_cost`` (P,), ...)
==========  ===============================================================

``write_chrome_trace`` converts the same event list into the Chrome
``traceEvents`` JSON that Perfetto / ``chrome://tracing`` loads directly
(complete "X" events for spans, "i" instants, μs timestamps).
"""
from __future__ import annotations

import json
import os

EVENT_TYPES = ("meta", "span", "instant", "step")


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _valid_payload(v) -> bool:
    """step-event payload values: scalar number/bool or (nested) number
    lists — exactly what stacked diag arrays serialize to."""
    if _is_num(v) or isinstance(v, bool):
        return True
    if isinstance(v, list):
        return all(_valid_payload(x) for x in v)
    return False


def validate_event(ev: dict, i: int = -1) -> None:
    """Raise ``ValueError`` describing the first schema violation."""
    where = f"event {i}" if i >= 0 else "event"
    if not isinstance(ev, dict):
        raise ValueError(f"{where}: not an object: {ev!r}")
    t = ev.get("type")
    if t not in EVENT_TYPES:
        raise ValueError(f"{where}: unknown type {t!r} "
                         f"(expected one of {EVENT_TYPES})")
    if t == "span":
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"{where}: span needs a string 'name'")
        for k in ("ts", "dur"):
            if not _is_num(ev.get(k)) or ev[k] < 0:
                raise ValueError(f"{where}: span needs numeric {k!r} >= 0")
    elif t == "instant":
        if not isinstance(ev.get("name"), str) or not _is_num(ev.get("ts")):
            raise ValueError(f"{where}: instant needs 'name' + numeric 'ts'")
    elif t == "step":
        step = ev.get("step")
        if not isinstance(step, int) or isinstance(step, bool) or step < 0:
            raise ValueError(f"{where}: step event needs int 'step' >= 0")
        for k, v in ev.items():
            if k in ("type", "step"):
                continue
            if not _valid_payload(v):
                raise ValueError(
                    f"{where}: step payload {k!r} is not numeric/bool/"
                    f"nested-number-list: {v!r}")


def validate_events(events: list[dict]) -> None:
    for i, ev in enumerate(events):
        validate_event(ev, i)


def write_jsonl(events: list[dict], path: str) -> str:
    """Validate then write one event per line; returns ``path``."""
    validate_events(events)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return path


def read_jsonl(path: str) -> list[dict]:
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def chrome_trace(events: list[dict]) -> dict:
    """Chrome ``traceEvents`` document for the span/instant subset."""
    out = [{"ph": "M", "name": "process_name", "pid": 0,
            "args": {"name": "repro_torch.obs"}}]
    for ev in events:
        if ev["type"] == "span":
            args = {k: v for k, v in ev.items()
                    if k not in ("type", "name", "ts", "dur", "tid")}
            out.append({"name": ev["name"], "ph": "X", "pid": 0,
                        "tid": ev.get("tid", 0),
                        "ts": ev["ts"] * 1e6, "dur": ev["dur"] * 1e6,
                        "args": args})
        elif ev["type"] == "instant":
            args = {k: v for k, v in ev.items()
                    if k not in ("type", "name", "ts", "tid")}
            out.append({"name": ev["name"], "ph": "i", "pid": 0,
                        "tid": ev.get("tid", 0), "ts": ev["ts"] * 1e6,
                        "s": "g", "args": args})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events: list[dict], path: str) -> str:
    doc = chrome_trace(events)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
