"""repro_torch.obs: metrics, per-request tracing, SLOs and profiling hooks
(port of `repro.obs`).

The serving stack (continuous batching, paged KV with prefix sharing,
speculative decoding, multi-tenant adapter banks) and the training loop
report through one `MetricsRegistry`: labeled counters, gauges and
histograms with p50/p95/p99, structured events (retraces, bank pressure,
degradation steps), per-request lifecycle traces, JSONL/Prometheus/JSON
exporters, SLO burn-rate monitors, and `torch.profiler` capture with named
kernel ranges. Every module but `profile` is the standard library alone,
with JAX's behaviour line for line; the README's observability section
has the metric catalog.
"""
from repro_torch.obs.aggregate import (merge_snapshots, mergeable_snapshot,
                                       merged_histogram)
from repro_torch.obs.export import (JsonlSink, render_prometheus,
                                    write_snapshot)
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry, format_key)
from repro_torch.obs.profile import (ProfiledTicks, annotate, profiler_trace,
                                     scope)
from repro_torch.obs.slo import (Objective, SLOMonitor, SLOSpec, SLOVerdict,
                                 accept_floor, kv_free_floor, queue_depth_max,
                                 tpot_target, ttft_target)
from repro_torch.obs.trace import NULL_TRACE, RequestTrace, RequestTracer

__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "JsonlSink",
    "MetricsRegistry", "NULL_TRACE", "Objective", "ProfiledTicks",
    "RequestTrace", "RequestTracer", "SLOMonitor", "SLOSpec", "SLOVerdict",
    "accept_floor", "annotate", "format_key", "kv_free_floor",
    "merge_snapshots", "mergeable_snapshot", "merged_histogram",
    "profiler_trace", "queue_depth_max", "render_prometheus", "scope",
    "tpot_target", "ttft_target", "write_snapshot",
]
