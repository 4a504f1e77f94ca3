"""Cross-replica metric aggregation: mergeable snapshots and fleet views
(port of `repro.obs.aggregate`, standard library only).

`registry.snapshot()` collapses histograms to p50/p95/p99, which cannot
be combined across processes. A fleet of scheduler replicas needs the raw
mergeable state instead:

  * `mergeable_snapshot(registry, replica=...)` - a versioned, JSON-able
    dict of every series in additive form: counter values, gauge values,
    and histograms as raw bucket counts plus count/sum/min/max.
  * `merge_snapshots([replica_0, ..., replica_n])` - one fleet view:
    counters sum, gauges stay per replica (with min/max/sum/mean), and
    histograms add bucket-wise, their quantiles derived again from the
    merged counts. Merging N replicas' snapshots equals one registry that
    observed all N streams.
  * `merged_histogram(state)` - a live `Histogram` rebuilt from a (merged
    or single-replica) histogram state, for percentile queries.

Merging needs one bucket layout per series and one schema version; both
are validated loudly, and a merged view is terminal (merging it again is
refused).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence

from repro_torch.obs.metrics import Histogram, MetricsRegistry, format_key

SCHEMA = "repro-obs-agg-v1"


def mergeable_snapshot(registry: MetricsRegistry, replica: str) -> dict:
    """Every series in additive form, tagged with a replica id.

    Unlike `registry.snapshot()` this keeps raw histogram bucket counts
    (quantiles are derived at merge time, not here) and skips derived
    quantities (quotients don't merge; recompute them from the merged
    counters instead).
    """
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, dict] = {}
    for (name, labels), (kind, inst) in sorted(registry._metrics.items()):
        fk = format_key(name, labels)
        if kind == "counter":
            counters[fk] = inst.value
        elif kind == "gauge":
            gauges[fk] = inst.value
        else:
            hists[fk] = {
                "buckets": list(inst.buckets),
                "counts": list(inst.counts),
                "count": inst.count,
                "sum": inst.sum,
                "min": inst.min,
                "max": inst.max,
            }
    by_kind: Dict[str, int] = {}
    for e in registry.events:
        by_kind[e["event"]] = by_kind.get(e["event"], 0) + 1
    return {
        "schema": SCHEMA,
        "replica": str(replica),
        "t_unix": time.time(),
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
        "events_by_kind": by_kind,
    }


def merged_histogram(state: dict) -> Histogram:
    """Rebuild a live `Histogram` from a snapshot's histogram state (raw
    bucket counts), e.g. to query percentiles over a merged series."""
    h = Histogram(state["buckets"])
    counts = list(state["counts"])
    if len(counts) != len(h.buckets) + 1:
        raise ValueError(
            f"histogram state has {len(counts)} bucket counts for "
            f"{len(h.buckets)} edges (want edges + 1 overflow)")
    h.counts = counts
    h.count = int(state["count"])
    h.sum = float(state["sum"])
    h._min = float(state["min"]) if h.count else math.inf
    h._max = float(state["max"]) if h.count else -math.inf
    return h


def merge_snapshots(snaps: Sequence[dict]) -> dict:
    """Merge per-replica `mergeable_snapshot` dicts into one fleet view.

    Counters sum. Gauges keep each replica's last value labeled by
    replica id plus min/max/sum/mean aggregates. Histograms add
    bucket-wise (layouts must match) with p50/p95/p99 re-derived from
    the merged counts. Event counts sum.
    """
    snaps = list(snaps)
    if not snaps:
        raise ValueError("merge_snapshots needs at least one snapshot")
    replicas: List[str] = []
    for s in snaps:
        if s.get("schema") != SCHEMA:
            raise ValueError(
                f"cannot merge snapshot with schema {s.get('schema')!r} "
                f"(want {SCHEMA})")
        if "replicas" in s:
            raise ValueError(
                "snapshot is already a merged fleet view; merge the "
                "original per-replica snapshots instead")
        replicas.append(str(s.get("replica", f"replica{len(replicas)}")))
    if len(set(replicas)) != len(replicas):
        raise ValueError(f"duplicate replica ids in merge: {replicas}")

    counters: Dict[str, float] = {}
    for s in snaps:
        for k, v in s["counters"].items():
            counters[k] = counters.get(k, 0) + v

    gauges: Dict[str, dict] = {}
    for rid, s in zip(replicas, snaps):
        for k, v in s["gauges"].items():
            gauges.setdefault(k, {"replicas": {}})["replicas"][rid] = v
    for g in gauges.values():
        vals = list(g["replicas"].values())
        g["min"] = min(vals)
        g["max"] = max(vals)
        g["sum"] = sum(vals)
        g["mean"] = g["sum"] / len(vals)

    hists: Dict[str, dict] = {}
    for rid, s in zip(replicas, snaps):
        for k, h in s["histograms"].items():
            m = hists.get(k)
            if m is None:
                hists[k] = {
                    "buckets": list(h["buckets"]),
                    "counts": list(h["counts"]),
                    "count": int(h["count"]),
                    "sum": float(h["sum"]),
                    "min": float(h["min"]) if h["count"] else math.inf,
                    "max": float(h["max"]) if h["count"] else -math.inf,
                }
                continue
            if list(h["buckets"]) != m["buckets"]:
                raise ValueError(
                    f"{k}: bucket layout differs between replicas - "
                    "histograms only add bucket-wise over one layout")
            m["counts"] = [a + b for a, b in zip(m["counts"], h["counts"])]
            m["count"] += int(h["count"])
            m["sum"] += float(h["sum"])
            if h["count"]:
                m["min"] = min(m["min"], float(h["min"]))
                m["max"] = max(m["max"], float(h["max"]))
    for m in hists.values():
        if m["count"] == 0:
            m["min"] = m["max"] = 0.0
        hh = merged_histogram(m)
        m["p50"] = hh.percentile(0.50)
        m["p95"] = hh.percentile(0.95)
        m["p99"] = hh.percentile(0.99)

    by_kind: Dict[str, int] = {}
    for s in snaps:
        for k, v in s.get("events_by_kind", {}).items():
            by_kind[k] = by_kind.get(k, 0) + v

    return {
        "schema": SCHEMA,
        "replicas": replicas,
        "t_unix": time.time(),
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
        "events_by_kind": by_kind,
    }


__all__ = ["SCHEMA", "merge_snapshots", "mergeable_snapshot",
           "merged_histogram"]
