"""Host-side metrics: counters, gauges, fixed-bucket histograms, events
(port of `repro.obs.metrics`, standard library only, line for line JAX's
behaviour).

  * Cheap on the hot path: every instrument is a plain Python object with
    `__slots__`; recording is an attribute bump or a `bisect` into a fixed
    bucket layout - no locks, no string formatting, no timestamping.
  * Disabled is free: `MetricsRegistry(enabled=False)` hands out shared
    null instruments whose methods do nothing, so call sites never branch.
  * Labels are first-class: instruments are keyed by (name,
    sorted(labels)), so per-tenant and per-scheduler series coexist
    (`serve_ttft_s{sched=paged, tenant=task0}`).
  * Quantiles come from fixed-bucket histograms, not samples: p50/p95/p99
    are order-statistic estimates that land inside the bucket holding the
    exact quantile, with O(num_buckets) memory.

Events (`registry.event(kind, ...)`) are the structured side channel for
what should never pass silently - a retrace mid-serve, a bank eviction
storm, a degradation step. They go to a bounded buffer and to every
attached sink (`repro_torch.obs.export.JsonlSink` writes them as JSONL).
"""
from __future__ import annotations

import math
import time
from bisect import bisect_left
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import RequestTracer

# latency buckets (seconds): ~geometric from 0.1ms to 60s. Serving TTFT/
# TPOT on anything from a smoke config to a sharded 27B lands inside.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar (bytes resident, blocks live, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = float(v)

    def add(self, n=1) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram with order-statistic quantile estimates.

    Bucket i covers (edge[i-1], edge[i]]; one implicit overflow bucket
    covers (edge[-1], +inf). `percentile(q)` finds the bucket holding the
    rank-ceil(q*n) order statistic and returns its midpoint clamped to
    the observed [min, max] - by construction the estimate lies inside
    the same bucket as the exact quantile, so the error is bounded by
    that bucket's width whatever the layout.
    """

    __slots__ = ("buckets", "counts", "count", "sum", "_min", "_max")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("buckets must be non-empty, strictly increasing")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)  # +1: the (top, +inf) overflow
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    @property
    def min(self) -> float:
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        return self._max if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimate of the q-quantile (q in [0, 1]); 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))  # 1-indexed order stat
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                lo = self.buckets[i - 1] if i else self._min
                hi = self.buckets[i] if i < len(self.buckets) else self._max
                # clamp to observed range: stays inside the bucket, and
                # degenerate cases (all mass at one point) return exactly it
                lo = max(lo, self._min)
                hi = min(hi, self._max)
                if lo > hi:
                    return hi
                return 0.5 * (lo + hi)
        return self._max  # unreachable: cum ends at self.count >= rank

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class _Null:
    """Shared no-op instrument for disabled registries: every recording
    method exists and does nothing; reads are zero."""

    __slots__ = ()
    value = 0
    count = 0
    sum = 0.0
    min = 0.0
    max = 0.0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def add(self, n=1) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def summary(self) -> Dict[str, float]:
        return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                "p50": 0.0, "p95": 0.0, "p99": 0.0}


_NULL = _Null()


def _key(name: str, labels: dict) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def format_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    """Stable flat series name: `name` or `name{k=v,k2=v2}` (sorted)."""
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class MetricsRegistry:
    """One registry per serving/training process (or per scheduler in
    tests): hands out labeled instruments, collects structured events,
    carries the per-request tracer, and snapshots everything
    machine-readably.

    enabled=False turns every instrument into a shared no-op and disables
    event collection and request tracing - the metrics-off leg of a
    cost comparison, and the zero-cost default for code paths that build
    a registry nobody reads.
    """

    def __init__(self, enabled: bool = True, *, keep_events: int = 4096,
                 keep_traces: int = 1024):
        self.enabled = enabled
        self._metrics: Dict[tuple, Tuple[str, object]] = {}
        self._derived: Dict[str, Callable[[], float]] = {}
        self.events: deque = deque(maxlen=keep_events)
        self._sinks: List[Callable[[dict], None]] = []
        self.tracer = RequestTracer(enabled=enabled, keep=keep_traces)

    # -- instruments ---------------------------------------------------------

    def _get(self, kind: str, name: str, labels: dict, factory):
        if not self.enabled:
            return _NULL
        key = _key(name, labels)
        ent = self._metrics.get(key)
        if ent is None:
            ent = self._metrics[key] = (kind, factory())
        elif ent[0] != kind:
            raise ValueError(
                f"metric {format_key(*key)} already registered as {ent[0]}, "
                f"not {kind}")
        return ent[1]

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        """`buckets` applies on first registration of the series only."""
        return self._get("histogram", name, labels,
                         lambda: Histogram(buckets or DEFAULT_BUCKETS))

    def add_derived(self, name: str, fn: Callable[[], float]) -> None:
        """Register a quantity computed at snapshot time from live state
        (hit ratios, acceptance rates - things that are a quotient of two
        counters and would go stale if stored)."""
        if self.enabled:
            self._derived[name] = fn

    # -- events --------------------------------------------------------------

    def event(self, kind: str, **fields) -> None:
        """Record one structured event and fan it out to attached sinks."""
        if not self.enabled:
            return
        ev = {"event": kind, "t_unix": time.time(), **fields}
        self.events.append(ev)
        for sink in self._sinks:
            sink(ev)

    def add_sink(self, sink: Callable[[dict], None]) -> None:
        """Attach an event sink (e.g. `repro_torch.obs.export.JsonlSink`)."""
        self._sinks.append(sink)

    def events_of(self, kind: str) -> List[dict]:
        return [e for e in self.events if e["event"] == kind]

    # -- snapshot ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Machine-readable state of every series: counters/gauges flat,
        histograms as count/sum/min/max/p50/p95/p99, derived quantities
        evaluated now, plus per-kind event counts and tracer occupancy."""
        counters, gauges, hists = {}, {}, {}
        for (name, labels), (kind, inst) in sorted(self._metrics.items()):
            fk = format_key(name, labels)
            if kind == "counter":
                counters[fk] = inst.value
            elif kind == "gauge":
                gauges[fk] = inst.value
            else:
                hists[fk] = inst.summary()
        by_kind: Dict[str, int] = {}
        for e in self.events:
            by_kind[e["event"]] = by_kind.get(e["event"], 0) + 1
        return {
            "schema": "repro-obs-v1",
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "derived": {k: float(fn()) for k, fn in self._derived.items()},
            "events_by_kind": by_kind,
            "traces": {"active": len(self.tracer.active),
                       "finished": len(self.tracer.done)},
        }

    def reset(self) -> None:
        """Drop every series, event, derived hook, and trace (sinks stay)."""
        self._metrics.clear()
        self._derived.clear()
        self.events.clear()
        self.tracer.reset()
