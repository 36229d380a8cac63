"""Metrics registry: counters / gauges / histograms (DESIGN.md §12).

The registry is the home for numbers that are *not* discrete runtime
events — cumulative protocol counters (retransmits, ACK trains,
generation-fence drops), instantaneous state (trunk queue depth), and
sampled distributions (queue-depth histograms). The §9 hot-path
discipline applies: instruments are pre-bound by their owner (an
attribute holding the ``Counter``; never a name lookup per event), a
``Counter.inc`` is one integer add, and anything that walks topology
state is sampled on the runtime's ``Sim.every`` wall grid, never per
packet/event.

``Histogram`` keeps a bounded reservoir (Vitter's Algorithm R, seeded
— same stream of observations, same reservoir) so quantiles over
millions of samples cost O(reservoir) memory and the sampling itself
stays O(1) amortized.

``MetricsRegistry.snapshot()`` flattens everything into plain floats —
the dict ``Tracker.log_summary`` ships at end of run.

``Span`` is the one instrument that reads the wall clock: a
``torch.profiler.record_function`` span that also adds its duration in
``time.perf_counter_ns`` to two counters, so a host phase is timed both
in a profiler trace and, with no profiler running, in the registry. The
runtime keeps such readings in a registry of their own
(``ClusterRuntime.host_metrics``), never in the simulated-time one.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
from torch.profiler import record_function


class Counter:
    """Monotone cumulative count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    # replint: hotpath
    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    # replint: hotpath
    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Reservoir-sampled distribution (Algorithm R, seeded).

    ``observe`` is O(1): the first ``reservoir`` observations fill the
    buffer; afterwards observation ``i`` replaces a uniform slot with
    probability ``reservoir / i``. Count/sum/min/max are exact; the
    quantiles come from the reservoir.
    """

    __slots__ = ("name", "reservoir", "samples", "count", "total",
                 "vmin", "vmax", "_rng")

    def __init__(self, name: str, reservoir: int = 1024,
                 seed: int = 0) -> None:
        if reservoir < 1:
            raise ValueError("reservoir must be >= 1")
        self.name = name
        self.reservoir = reservoir
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        # stdlib RNG: ~3x cheaper than a numpy Generator for scalar draws
        self._rng = random.Random(seed)

    # replint: hotpath
    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if len(self.samples) < self.reservoir:
            self.samples.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.reservoir:
                self.samples[j] = v

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(self.samples, q))

    def snapshot(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.total / self.count,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class Span:
    """A named wall-clock span: entered, it opens ``record_function(name)``
    (a no-op but for the call itself when no profiler runs); left, it adds
    the ``perf_counter_ns`` time between the two to counter
    ``span/<name>/ns`` and 1 to ``span/<name>/calls``. The timed interval
    lies inside the profiler's span. A span is not entered again while it
    is open; spans of different names nest."""

    __slots__ = ("name", "ns", "calls", "_rf", "_t0")

    def __init__(self, name: str, ns: Counter, calls: Counter) -> None:
        self.name = name
        self.ns = ns
        self.calls = calls
        self._rf = None
        self._t0 = 0

    # replint: hotpath
    def __enter__(self) -> "Span":
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    # replint: hotpath
    def __exit__(self, *exc) -> None:
        self.ns.inc(time.perf_counter_ns() - self._t0)
        self.calls.inc()
        self._rf.__exit__(*exc)


class MetricsRegistry:
    """Named instrument registry. ``counter``/``gauge``/``histogram``
    are get-or-create (same name -> same instrument), so independent
    subsystems can contribute to shared totals; ``absorb`` folds an
    external stats dict (``AggSwitch.stats()``, ``PERF.snapshot()``,
    transport flow stats) into counters/gauges in one call."""

    def __init__(self, reservoir: int = 1024, seed: int = 0) -> None:
        self._reservoir = reservoir
        self._seed = seed
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  reservoir: Optional[int] = None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(
                name, reservoir or self._reservoir, seed=self._seed)
        return h

    def span(self, name: str) -> Span:
        """A ``Span`` over this registry's counters ``span/<name>/ns`` and
        ``span/<name>/calls``; bind it once, as any instrument."""
        return Span(name, self.counter(f"span/{name}/ns"),
                    self.counter(f"span/{name}/calls"))

    def absorb(self, prefix: str, stats: Mapping[str, float],
               as_gauges: bool = False) -> None:
        """Fold a ``{name: number}`` stats dict in under ``prefix/``.
        Counters are *set* to the given cumulative value (the sources —
        pipe/sender/switch counters — are already cumulative); pass
        ``as_gauges=True`` for instantaneous values."""
        for k, v in stats.items():
            if not isinstance(v, (int, float)):
                continue
            if as_gauges:
                self.gauge(f"{prefix}/{k}").set(float(v))
            else:
                self.counter(f"{prefix}/{k}").value = int(v)

    def snapshot(self) -> Dict[str, float]:
        """Flatten every instrument to ``name -> float`` (histograms
        expand to ``name/count|mean|min|max|p50|p99``)."""
        out: Dict[str, float] = {}
        for name, c in self.counters.items():
            out[name] = c.value
        for name, g in self.gauges.items():
            out[name] = g.value
        for name, h in self.histograms.items():
            for k, v in h.snapshot().items():
                out[f"{name}/{k}"] = v
        return out
