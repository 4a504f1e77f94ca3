"""Exporters: JSONL event sink, Prometheus text exposition, JSON snapshot
(port of `repro.obs.export`, standard library only).

  * `JsonlSink` - `registry.add_sink(JsonlSink(path))`; every
    `registry.event(...)` appends one JSON object per line (the event's
    fields plus `event` and `t_unix`). Line-buffered, so a crashed serve
    leaves the events up to the crash on disk.
  * `render_prometheus(registry)` - the text exposition format (v0.0.4):
    counters and gauges as they are, histograms as cumulative
    `_bucket{le=...}` series plus `_sum`/`_count`.
  * `write_snapshot(registry, path)` - `registry.snapshot()` as indented
    JSON; a `.prom` path gets the Prometheus rendering instead.
    `launch/serve --metrics-file` writes through this.
"""
from __future__ import annotations

import json
import os
from typing import IO, Optional

from repro_torch.obs.metrics import MetricsRegistry, format_key


class JsonlSink:
    """Append structured events to a JSONL file (one object per line)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f: Optional[IO] = open(path, "a", buffering=1)

    def __call__(self, event: dict) -> None:
        if self._f is not None:
            self._f.write(json.dumps(event, default=str) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def _prom_escape(v: str) -> str:
    """Label-value escaping per the text exposition format: backslash
    first (escaping the escapes the other two introduce), then quote and
    newline. A tenant name containing `"` must not corrupt the scrape."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(labels) -> str:
    if not labels:
        return ""
    return "{" + ",".join(
        f'{k}="{_prom_escape(str(v))}"' for k, v in labels) + "}"


def render_prometheus(registry: MetricsRegistry) -> str:
    """Prometheus text exposition of every registered series."""
    typed = {}  # name -> kind (TYPE lines emitted once per name)
    lines = []
    for (name, labels), (kind, inst) in sorted(registry._metrics.items()):
        if name not in typed:
            typed[name] = kind
            lines.append(f"# TYPE {name} "
                         f"{'histogram' if kind == 'histogram' else kind}")
        lab = _prom_labels(labels)
        if kind in ("counter", "gauge"):
            lines.append(f"{name}{lab} {inst.value}")
            continue
        cum = 0
        for edge, c in zip(inst.buckets, inst.counts):
            cum += c
            le = dict(labels, le=f"{edge:g}")
            lines.append(f"{name}_bucket{_prom_labels(sorted(le.items()))} "
                         f"{cum}")
        inf = dict(labels, le="+Inf")
        lines.append(f"{name}_bucket{_prom_labels(sorted(inf.items()))} "
                     f"{inst.count}")
        lines.append(f"{name}_sum{lab} {inst.sum}")
        lines.append(f"{name}_count{lab} {inst.count}")
    for dname, fn in registry._derived.items():
        lines.append(f"# TYPE {dname} gauge")
        lines.append(f"{dname} {float(fn())}")
    return "\n".join(lines) + "\n"


def write_snapshot(registry: MetricsRegistry, path: str) -> dict:
    """Dump the registry snapshot to `path` (JSON; `.prom` -> Prometheus
    text). Returns the snapshot dict either way."""
    snap = registry.snapshot()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        if path.endswith(".prom"):
            f.write(render_prometheus(registry))
        else:
            json.dump(snap, f, indent=2, default=str)
    return snap


__all__ = ["JsonlSink", "render_prometheus", "write_snapshot", "format_key"]
