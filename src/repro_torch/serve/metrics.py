"""Per-tenant serving metrics: queue depth, latency quantiles, rps.

Port of ``repro/serve/metrics.py``, host-side bookkeeping only: the server
worker updates these under a lock as requests move through submit -> batch
-> complete.  A tenant is any client stream sharing one accounting id; the
registry keeps one :class:`TenantMetrics` per id.  Latencies go to a
streaming log-binned :class:`repro_torch.obs.Histogram` registered in the
observability registry under ``serve.latency_s.<tenant>`` (p50/p90/p99 in
every snapshot), and a ``serve.queue_depth`` gauge holds the total queued
requests across tenants.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional

from ..obs import Histogram, Registry, get_registry


class TenantMetrics:
    """Counters + latency/rate stats for one tenant."""

    def __init__(self, window_s: float = 5.0,
                 latency: Optional[Histogram] = None):
        self.window_s = window_s
        self.submitted = 0
        self.completed = 0
        self.timeouts = 0          # dropped past deadline / client gave up
        self.errors = 0            # evaluator failures, overflow rejections
        self.rejected = 0          # backpressure: queue-full rejections
        self.queue_depth = 0       # currently queued (submitted, not done)
        self.max_queue_depth = 0
        self.latency = latency if latency is not None else Histogram(lo=1e-6)
        self._done_times = collections.deque()   # completion stamps (rps)

    # -- transitions (caller holds the registry lock) -----------------------

    def on_submit(self) -> None:
        self.submitted += 1
        self.queue_depth += 1
        self.max_queue_depth = max(self.max_queue_depth, self.queue_depth)

    def on_reject(self) -> None:
        self.rejected += 1

    def _settle(self, latency_s: float) -> None:
        self.queue_depth = max(0, self.queue_depth - 1)
        self.latency.observe(latency_s)

    def on_complete(self, latency_s: float) -> None:
        self.completed += 1
        self._settle(latency_s)
        now = time.monotonic()
        self._done_times.append(now)
        cutoff = now - self.window_s
        while self._done_times and self._done_times[0] < cutoff:
            self._done_times.popleft()

    def on_timeout(self, latency_s: float) -> None:
        self.timeouts += 1
        self._settle(latency_s)

    def on_error(self, latency_s: float) -> None:
        self.errors += 1
        self._settle(latency_s)

    # -- views --------------------------------------------------------------

    def rps(self) -> float:
        """Completions per second over the trailing window."""
        cutoff = time.monotonic() - self.window_s
        done = sum(1 for t in self._done_times if t >= cutoff)
        return done / self.window_s

    def mean_latency_s(self) -> float:
        return self.latency.mean()

    def snapshot(self) -> dict:
        lat = self.latency
        return {
            "submitted": self.submitted, "completed": self.completed,
            "timeouts": self.timeouts, "errors": self.errors,
            "rejected": self.rejected, "queue_depth": self.queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "mean_latency_s": lat.mean(),
            "max_latency_s": lat.max if lat.count else 0.0,
            "p50_latency_s": lat.quantile(0.50),
            "p90_latency_s": lat.quantile(0.90),
            "p99_latency_s": lat.quantile(0.99),
            "rps": self.rps(),
        }


class MetricsRegistry:
    """Thread-safe per-tenant metrics table."""

    def __init__(self, window_s: float = 5.0,
                 obs_registry: Optional[Registry] = None):
        self.window_s = window_s
        self.obs = obs_registry if obs_registry is not None else get_registry()
        self._depth_gauge = self.obs.gauge("serve.queue_depth")
        self._lock = threading.Lock()
        self._tenants: dict[str, TenantMetrics] = {}

    def _new_tenant(self, tenant: str) -> TenantMetrics:
        hist = self.obs.histogram(f"serve.latency_s.{tenant}", lo=1e-6)
        return TenantMetrics(self.window_s, latency=hist)

    def tenant(self, tenant: str) -> TenantMetrics:
        with self._lock:
            if tenant not in self._tenants:
                self._tenants[tenant] = self._new_tenant(tenant)
            return self._tenants[tenant]

    def update(self, tenant: str, event: str, *args) -> None:
        with self._lock:
            if tenant not in self._tenants:
                self._tenants[tenant] = self._new_tenant(tenant)
            getattr(self._tenants[tenant], "on_" + event)(*args)
            self._depth_gauge.set(sum(m.queue_depth
                                      for m in self._tenants.values()))

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {t: m.snapshot() for t, m in self._tenants.items()}

    def totals(self) -> dict:
        snap = self.snapshot()
        keys = ("submitted", "completed", "timeouts", "errors", "rejected",
                "queue_depth")
        return {k: sum(s[k] for s in snap.values()) for k in keys}
