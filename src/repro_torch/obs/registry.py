"""Process-wide metrics registry: counters, gauges, streaming histograms.

Port of ``repro/obs/registry.py`` (pure Python, copied: the port imports
nothing of ``repro``).

Host-side bookkeeping only (never traced).  The histogram is the piece the
rest of the subsystem leans on: latency distributions are heavy-tailed, so
serving metrics must report quantiles, not means — :class:`Histogram` keeps
a fixed set of geometrically spaced bins (a streaming log-linear sketch in
the HdrHistogram / DDSketch family) so p50/p90/p99 come out of O(bins)
memory with a bounded *relative* error, no sample buffer, no sorting.

One module-level :func:`get_registry` instance is the default sink: the
engine publishes its guard counters there (``guard.trips``,
``guard.recoveries``), and tests can swap in a fresh :class:`Registry`.
"""
from __future__ import annotations

import math
import threading


class Counter:
    """Monotonic counter."""

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-value gauge with a running peak (e.g. server queue depth)."""

    def __init__(self):
        self.value = 0.0
        self.peak = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v
            self.peak = max(self.peak, v)


class Histogram:
    """Streaming log-binned histogram with quantiles.

    Observations land in geometrically spaced bins spanning ``[lo, hi]``
    (``bins_per_octave`` bins per doubling; the default 8 gives a bin width
    of 2**(1/8) ~ 9%, i.e. quantiles exact to ~4.4% relative error), with
    one underflow and one overflow bin.  Exact count/sum/min/max ride along,
    so the mean is exact and single-observation quantiles are clamped to
    the true extremes.
    """

    def __init__(self, lo: float = 1e-7, hi: float = 1e4,
                 bins_per_octave: int = 8):
        if lo <= 0 or hi <= lo:
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        self.lo = float(lo)
        self._scale = bins_per_octave / math.log(2.0)
        self.n_bins = int(math.ceil(math.log(hi / lo) * self._scale)) + 2
        self._counts = [0] * self.n_bins
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def _bin(self, v: float) -> int:
        if v <= self.lo:
            return 0
        b = int(math.log(v / self.lo) * self._scale) + 1
        return min(b, self.n_bins - 1)

    def _bin_value(self, b: int) -> float:
        # geometric bin midpoint (bin 0 = underflow -> lo)
        if b == 0:
            return self.lo
        return self.lo * math.exp((b - 0.5) / self._scale)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self._counts[self._bin(v)] += 1

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile (1-based ``ceil(q*n)``) from the bin
        cumulative; clamped to the exact observed [min, max] so degenerate
        histograms stay exact and p99-of-few-samples reports the tail
        observation, not an interior one."""
        with self._lock:
            if not self.count:
                return 0.0
            rank = min(max(math.ceil(q * self.count), 1), self.count)
            seen = 0
            for b, n in enumerate(self._counts):
                if not n:
                    continue
                seen += n
                if seen >= rank:
                    return min(max(self._bin_value(b), self.min), self.max)
            return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count, "sum": self.sum, "mean": self.mean(),
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.50), "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


class Registry:
    """Thread-safe name -> instrument table (create-on-first-use)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, **kwargs) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(**kwargs)
            return self._histograms[name]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: {"value": g.value, "peak": g.peak}
                           for k, g in self._gauges.items()},
                "histograms": {k: h.snapshot()
                               for k, h in self._histograms.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_GLOBAL = Registry()


def get_registry() -> Registry:
    """The process-wide default registry (tests may build their own)."""
    return _GLOBAL
