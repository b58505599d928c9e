"""Unified observability subsystem (the paper's profiling methodology).

Port of ``repro/obs``.  One instrumented spine every layer reports into:

* :mod:`repro_torch.obs.registry` — process-wide counters / gauges /
  streaming histograms (p50/p90/p99, not just means).
* :mod:`repro_torch.obs.trace` — :class:`ObsConfig` + :class:`Tracer`:
  host-side wall-clock spans (each also a
  ``torch.profiler.record_function``, so phases show up in a
  ``torch.profiler`` trace) and device-side per-step/per-rank counters
  taken from the DD diagnostics and read once per engine window.
* :mod:`repro_torch.obs.export` — JSONL event log + Chrome-trace (Perfetto)
  span export + schema validation (the reference's schema).
* :mod:`repro_torch.obs.report` — the paper's Fig. 12-style phase breakdown
  and per-rank load-imbalance tables rendered from a recorded trace.

Everything is off by default (``ObsConfig(enabled=False)``): the disabled
tracer returns a shared null span and the engine builds no counter record,
so runs are bitwise-identical with and without the plumbing.
"""
from .registry import Counter, Gauge, Histogram, Registry, get_registry
from .trace import ObsConfig, Tracer, timed_prefix_phases

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "get_registry",
    "ObsConfig", "Tracer", "timed_prefix_phases",
]
