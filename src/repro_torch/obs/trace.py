"""Step-level tracer for the port's engine and pipeline.

Port of ``repro/obs/trace.py``.  Two mechanisms behind one
:class:`ObsConfig`:

* **Host-side wall-clock spans** (:meth:`Tracer.span`) wrap whole phases:
  list builds, the scan windows, the per-step stages.  Every span also
  opens ``torch.profiler.record_function(name)``, so the same phase names
  show up in a ``torch.profiler`` trace captured with
  :meth:`Tracer.start_capture`.

* **Device-side per-step counters**: the engine's steps assemble a small
  dict of scalars and short vectors out of the DD diagnostics (local and
  ghost counts, per-rank ``rank_cost``, neighbour occupancy,
  ``cost_max``/``cost_ratio``, rebuild and overflow flags); a window
  stacks them along the step axis on the device, and the engine reads the
  stacked tensors once per window, in the same host read as the window's
  verdict flags (:meth:`Tracer.record_window` takes the host arrays),
  never once per step.

Zero overhead when disabled: ``span`` returns one shared no-op context
manager (no ``record_function``) and ``wants_counters`` is False, so the
engine builds no counter record at all.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from .registry import Registry, get_registry


@dataclasses.dataclass
class ObsConfig:
    """Observability knobs (the reference's field names).

    ``xla_trace_dir`` keeps the reference's name: here it is the directory
    that :meth:`Tracer.start_capture` writes the ``torch.profiler`` trace
    to (``torch_trace.json``, CPU and CUDA activity)."""

    enabled: bool = False       # master switch; False = hard zero-overhead
    counters: bool = True       # device-side per-step counter records
    spans: bool = True          # host wall-clock spans (+ record_function)
    calibrate: bool = True      # per-stage probe timings for scan-mode runs
    trace_dir: Optional[str] = None      # auto-flush events.jsonl here
    xla_trace_dir: Optional[str] = None  # torch.profiler trace target
    max_events: int = 200_000   # event-buffer bound (drop + count past it)


class _NullSpan:
    """Shared no-op context manager: the disabled hot path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Wall-clock span + ``torch.profiler.record_function``."""

    __slots__ = ("_tracer", "_name", "_attrs", "_t0", "_anno")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._anno = torch.profiler.record_function(self._name)
        self._anno.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        self._anno.__exit__(exc_type, exc, tb)
        tr = self._tracer
        tr._add({"type": "span", "name": self._name,
                 "ts": self._t0 - tr._epoch, "dur": t1 - self._t0,
                 "tid": tr._tid(), **self._attrs})
        return False


def _jsonable(v):
    """numpy or tensor scalar/array -> plain int/float/bool/list."""
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else \
        np.asarray(v)
    if a.ndim == 0:
        if a.dtype == bool:
            return bool(a)
        if np.issubdtype(a.dtype, np.integer):
            return int(a)
        return float(a)
    return a.tolist()


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else \
        np.asarray(v)


def read_host(values: list) -> list:
    """Fetch a list of device tensors (any shapes, bool/int/float) in ONE
    device-to-host read: each is widened to float64 (exact for bool,
    int32 and float32), flattened and concatenated; the host splits the
    vector and casts each part back to its dtype.  Host values (python or
    numpy) pass through as numpy arrays."""
    dev = [i for i, v in enumerate(values) if isinstance(v, torch.Tensor)]
    out = [None if isinstance(v, torch.Tensor) else np.asarray(v)
           for v in values]
    if not dev:
        return out
    flat = torch.cat([values[i].detach().reshape(-1).to(torch.float64)
                      for i in dev]).cpu().numpy()
    off = 0
    for i in dev:
        t = values[i]
        dt = np.dtype(str(t.dtype).removeprefix("torch."))
        out[i] = flat[off:off + t.numel()].reshape(tuple(t.shape)).astype(dt)
        off += t.numel()
    return out


class Tracer:
    """One per engine; all layers report through it.

    Accepts an :class:`ObsConfig` (or another ``Tracer`` to share a buffer,
    or ``None`` for disabled).  Thread-safe.
    """

    def __init__(self, config: Optional[ObsConfig] = None,
                 registry: Optional[Registry] = None):
        self.config = config if config is not None else ObsConfig()
        self.enabled = bool(self.config.enabled)
        self.registry = registry if registry is not None else get_registry()
        self.events: list[dict] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._tids: dict[int, int] = {}
        self._epoch = time.perf_counter()
        self._profiler = None

    @staticmethod
    def ensure(obs) -> "Tracer":
        """Coerce an ``obs`` argument (Tracer | ObsConfig | None)."""
        if isinstance(obs, Tracer):
            return obs
        return Tracer(obs)

    @property
    def wants_counters(self) -> bool:
        """True when the engine's steps should build device counters."""
        return self.enabled and self.config.counters

    def _tid(self) -> int:
        ident = threading.get_ident()
        if ident not in self._tids:
            self._tids[ident] = len(self._tids)
        return self._tids[ident]

    def _add(self, ev: dict) -> None:
        with self._lock:
            if len(self.events) < self.config.max_events:
                self.events.append(ev)
            else:
                self.dropped += 1

    # -- event emission -----------------------------------------------------

    def meta(self, **attrs) -> None:
        if self.enabled:
            self._add({"type": "meta", **attrs})

    def instant(self, name: str, **attrs) -> None:
        if self.enabled:
            self._add({"type": "instant", "name": name,
                       "ts": time.perf_counter() - self._epoch, **attrs})

    def span(self, name: str, **attrs):
        """Context manager timing a host-side phase.  Disabled -> a shared
        null object: nothing allocated, nothing recorded."""
        if not (self.enabled and self.config.spans):
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def add_span(self, name: str, dur_s: float, **attrs) -> None:
        """Record a span with an externally measured duration (derived
        phase attributions, e.g. prefix-probe differences)."""
        if self.enabled and self.config.spans:
            self._add({"type": "span", "name": name,
                       "ts": time.perf_counter() - self._epoch,
                       "dur": float(max(dur_s, 0.0)), "tid": self._tid(),
                       **attrs})

    def record_window(self, step0: int, n_steps: int, recs: dict) -> None:
        """Unpack a window's per-step counters.

        ``recs`` maps counter name -> array whose leading axis is the step
        axis (length ``n_steps``): host arrays the engine fetched with the
        window's verdict (tensors are read here, one read per counter);
        each step becomes one ``step`` event at absolute step
        ``step0 + i``.
        """
        if not self.wants_counters or not recs:
            return
        host = {k: _host(v) for k, v in recs.items()}
        for i in range(n_steps):
            ev = {"type": "step", "step": int(step0) + i}
            for k, v in host.items():
                ev[k] = _jsonable(v[i])
            self._add(ev)

    def record_step(self, step: int, rec: dict) -> None:
        """Single-step counter record (the per-step host loop)."""
        if not self.wants_counters or not rec:
            return
        vals = read_host(list(rec.values()))
        ev = {"type": "step", "step": int(step)}
        for k, v in zip(rec, vals):
            ev[k] = _jsonable(v)
        self._add(ev)

    # -- profiler capture ----------------------------------------------------

    def start_capture(self, trace_dir: Optional[str] = None) -> bool:
        """Start a ``torch.profiler`` capture (CPU, and CUDA when a card is
        present) that :meth:`stop_capture` writes into ``xla_trace_dir``
        (or an explicit override).  Best-effort: never raises into the
        run."""
        d = trace_dir or self.config.xla_trace_dir
        if not (self.enabled and d) or self._profiler is not None:
            return False
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 — profiling must not kill MD
            warnings.warn(f"torch.profiler capture unavailable: {e}",
                          stacklevel=2)
            return False
        self._profiler = (prof, str(d))
        self.instant("profile_capture_start", dir=str(d))
        return True

    def stop_capture(self) -> bool:
        if self._profiler is None:
            return False
        prof, d = self._profiler
        self._profiler = None
        try:
            prof.stop()
            os.makedirs(d, exist_ok=True)
            prof.export_chrome_trace(os.path.join(d, "torch_trace.json"))
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"torch.profiler capture failed to stop: {e}",
                          stacklevel=2)
            return False
        self.instant("profile_capture_stop")
        return True

    # -- output -------------------------------------------------------------

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        """Write the JSONL event log (validates the schema first)."""
        from . import export
        if path is None:
            if not self.config.trace_dir:
                return None
            path = os.path.join(self.config.trace_dir, "events.jsonl")
        with self._lock:
            events = list(self.events)
            if self.dropped:
                events.append({"type": "meta", "dropped_events": self.dropped})
        return export.write_jsonl(events, path)

    def chrome_trace(self, path: str) -> str:
        """Write the Perfetto-loadable Chrome-trace view of the spans."""
        from . import export
        with self._lock:
            events = list(self.events)
        return export.write_chrome_trace(events, path)

    def clear_steps(self) -> None:
        """Drop buffered per-step device-counter events (``type == "step"``).

        Step counters are per-run state, like the engine's ``timings``: a
        new ``run()`` clears them, so the previous trajectory's counters do
        not leak into the next trace (and a restart from step 0 does not
        duplicate absolute step numbers).  Spans, meta and instant events
        survive."""
        with self._lock:
            self.events[:] = [e for e in self.events
                              if e.get("type") != "step"]

    def reset(self) -> None:
        with self._lock:
            self.events.clear()
            self.dropped = 0
        self._epoch = time.perf_counter()


def _block() -> None:
    """Wait for the card (``jax.block_until_ready`` in the reference)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_prefix_phases(tracer: Tracer, probes: dict, iters: int = 3,
                        warmup: int = 1) -> dict:
    """Phase attribution of a pipeline by nested prefix probes.

    ``probes`` maps phase name -> zero-arg thunk running the pipeline
    *through* that phase (each probe a strict superset of the previous one,
    e.g. gather ⊂ assembly ⊂ inference ⊂ force_reduce — see
    :meth:`repro_torch.core.pipeline.ForcePipeline.build_phase_probes`).
    Each probe's median wall time over ``iters`` runs (the card
    synchronised before and after each) is measured after ``warmup``
    calls; successive differences are the per-phase costs, recorded as
    ``calibrated`` spans on ``tracer`` and returned as {phase: seconds}.
    Measured, not modeled: the last probe is the real force function.
    """
    cumul = {}
    for name, thunk in probes.items():
        for _ in range(warmup):
            thunk()
            _block()
        ts = []
        for _ in range(iters):
            _block()
            t0 = time.perf_counter()
            thunk()
            _block()
            ts.append(time.perf_counter() - t0)
        cumul[name] = float(np.median(ts))
    phases = {}
    prev = 0.0
    for name in probes:
        phases[name] = max(cumul[name] - prev, 0.0)
        prev = max(cumul[name], prev)
        tracer.add_span(name, phases[name], phase=name, calibrated=True,
                        cumulative_s=cumul[name])
    return phases
