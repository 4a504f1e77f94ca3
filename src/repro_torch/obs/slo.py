"""Declarative SLOs evaluated as multi-window burn rates over the registry
(port of `repro.obs.slo`, standard library only, line for line JAX's
behaviour).

  * An `Objective` states what good means for one series - "p-mass of
    TTFT above 250 ms stays under 5 %", "queue depth <= 64", "KV free
    blocks >= 16", "speculative acceptance >= 0.4". Each evaluation
    reduces to a cumulative (total, bad) pair, so every kind shares one
    burn-rate formula.
  * Burn rate = (bad fraction in window) / (error budget), the budget
    being `1 - target`. Burn 1.0 spends the budget exactly at the
    sustainable rate.
  * `SLOSpec.windows` holds (seconds, burn_threshold) pairs; an objective
    breaches only when EVERY window agrees: the short window reacts fast,
    the long one keeps one bad tick from tripping the ladder.

`SLOMonitor` is pull-based and host-side only: it samples cumulative
instrument state on its own clock (injectable for tests), never touches
the device, and emits `SLOVerdict`s plus `slo_breach` / `slo_recovered`
registry events on transitions. What acts on the verdicts is
`repro_torch.serving.admission.AdmissionController`.
"""
from __future__ import annotations

import time
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import MetricsRegistry

# (window_seconds, burn_threshold): breach requires every window to burn
# at or above its threshold. Short window reacts within a couple of
# seconds of serve time; long window forbids flapping on a single spike.
DEFAULT_WINDOWS: Tuple[Tuple[float, float], ...] = ((2.0, 1.0), (10.0, 1.0))

_KINDS = ("latency", "gauge_max", "gauge_min", "ratio_min")


@dataclass(frozen=True)
class Objective:
    """One thing that must stay true, reduced to a burn-rate series.

    kind:
      latency   - `metric` is a histogram of seconds; an observation is
                  bad when it exceeds `threshold`. `target` is the good
                  fraction (0.95 -> 5% error budget).
      gauge_max - `metric` is a gauge; a sample is bad when value >
                  `threshold` (queue depth cap).
      gauge_min - bad when value < `threshold` (KV free-block floor).
      ratio_min - `metric` is "num_counter/den_counter"; bad fraction is
                  1 - num/den over the window and `target` is the floor
                  the ratio must hold (speculative acceptance).

    scheduler_scoped objectives are filtered by the monitor's base
    labels (one scheduler's series); unscoped ones match by name alone -
    needed for series published without a `sched` label
    (`kv_free_blocks`, the spec draft/accept counters).
    """

    name: str
    kind: str
    metric: str
    threshold: float
    target: float = 0.95
    tenant: Optional[str] = None
    scheduler_scoped: bool = True

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown objective kind {self.kind!r}; "
                             f"want one of {_KINDS}")
        if not (0.0 <= self.target < 1.0):
            raise ValueError(
                f"{self.name}: target must be in [0, 1) - a target of 1.0 "
                "leaves a zero error budget and an infinite burn rate")


def ttft_target(ms: float, *, target: float = 0.95,
                tenant: Optional[str] = None) -> Objective:
    """Time-to-first-token: `target` of requests under `ms` milliseconds."""
    tag = f"ttft_{tenant}" if tenant else "ttft"
    return Objective(name=f"{tag}_p{int(target * 100)}_{ms:g}ms",
                     kind="latency", metric="serve_ttft_s",
                     threshold=ms / 1e3, target=target, tenant=tenant)


def tpot_target(ms: float, *, target: float = 0.95,
                tenant: Optional[str] = None) -> Objective:
    """Time-per-output-token: `target` of ticks under `ms` milliseconds."""
    tag = f"tpot_{tenant}" if tenant else "tpot"
    return Objective(name=f"{tag}_p{int(target * 100)}_{ms:g}ms",
                     kind="latency", metric="serve_tpot_s",
                     threshold=ms / 1e3, target=target, tenant=tenant)


def queue_depth_max(depth: int, *, target: float = 0.9) -> Objective:
    """Admission queue stays at or under `depth` waiting requests."""
    return Objective(name=f"queue_le_{depth}", kind="gauge_max",
                     metric="serve_queue_depth", threshold=float(depth),
                     target=target)


def kv_free_floor(blocks: int, *, target: float = 0.9) -> Objective:
    """Paged KV pool keeps at least `blocks` free blocks (headroom for
    in-flight growth). The gauge is published unlabeled by the block
    allocator, hence scheduler_scoped=False."""
    return Objective(name=f"kv_free_ge_{blocks}", kind="gauge_min",
                     metric="kv_free_blocks", threshold=float(blocks),
                     target=target, scheduler_scoped=False)


def accept_floor(rate: float) -> Objective:
    """Speculative acceptance holds at or above `rate` - below it the
    draft lane is burning compute for nothing. target=rate makes the
    generic burn formula read "reject fraction over the reject budget"."""
    if not (0.0 < rate < 1.0):
        raise ValueError("accept_floor rate must be in (0, 1)")
    return Objective(
        name=f"spec_accept_ge_{rate:g}", kind="ratio_min",
        metric="serve_spec_accepted_total/serve_spec_drafted_total",
        threshold=rate, target=rate, scheduler_scoped=False)


@dataclass(frozen=True)
class SLOSpec:
    """A named bundle of objectives sharing one window policy."""

    objectives: Tuple[Objective, ...]
    windows: Tuple[Tuple[float, float], ...] = DEFAULT_WINDOWS
    name: str = "serve"

    def __post_init__(self):
        object.__setattr__(self, "objectives", tuple(self.objectives))
        object.__setattr__(
            self, "windows",
            tuple((float(w), float(b)) for w, b in self.windows))
        if not self.objectives:
            raise ValueError("SLOSpec needs at least one objective")
        if not self.windows:
            raise ValueError("SLOSpec needs at least one window")
        ws = [w for w, _ in self.windows]
        if any(w <= 0 for w in ws) or sorted(ws) != ws:
            raise ValueError("windows must be positive and ascending")
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")


@dataclass(frozen=True)
class SLOVerdict:
    """One objective's evaluation: per-window burn rates and the verdict."""

    objective: str
    breaching: bool
    burn_rates: Tuple[float, ...]
    windows: Tuple[Tuple[float, float], ...]
    fraction_bad: float  # over the longest window
    value: Optional[float] = None  # latest raw value, gauge kinds only


class _ObjectiveState:
    """Cumulative (t, total, bad, value) samples for one objective."""

    __slots__ = ("samples", "total", "bad", "breaching")

    def __init__(self):
        self.samples: deque = deque()
        self.total = 0.0
        self.bad = 0.0
        self.breaching = False


class SLOMonitor:
    """Evaluates an `SLOSpec` against one registry on demand.

    Every objective kind is sampled as a cumulative (total, bad) pair;
    windowed deltas between the current sample and the youngest sample
    old enough for each window give the bad fraction, divided by the
    error budget to get the burn rate. No data in a window means no
    evidence of burn - an idle scheduler is healthy, not breaching.

    `base_labels` scope scheduler_scoped objectives to one scheduler's
    series (e.g. {"sched": "spec_paged"}); tenant-qualified objectives
    additionally require the tenant label, and a global latency
    objective sums across every matching tenant series. `clock` is
    injectable so tests drive windows deterministically.
    """

    def __init__(self, registry: MetricsRegistry, spec: SLOSpec, *,
                 base_labels: Optional[Dict[str, str]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.spec = spec
        self.base_labels = dict(base_labels or {})
        self.clock = clock
        self._state: Dict[str, _ObjectiveState] = {
            o.name: _ObjectiveState() for o in spec.objectives}

    # -- series lookup -------------------------------------------------------

    def _matching(self, metric: str, obj: Objective) -> List[object]:
        """Instruments whose labels contain every required label."""
        required = dict(self.base_labels) if obj.scheduler_scoped else {}
        if obj.tenant is not None:
            required["tenant"] = str(obj.tenant)
        out = []
        for (name, labels), (_kind, inst) in self.registry._metrics.items():
            if name != metric:
                continue
            have = dict(labels)
            if all(have.get(k) == v for k, v in required.items()):
                out.append(inst)
        return out

    def _sample(self, obj: Objective) -> Tuple[float, float, Optional[float]]:
        """Current cumulative (total, bad, latest_value) for an objective."""
        if obj.kind == "latency":
            total = bad = 0.0
            for h in self._matching(obj.metric, obj):
                good = sum(h.counts[:bisect_right(h.buckets, obj.threshold)])
                total += h.count
                bad += h.count - good
            return total, bad, None
        if obj.kind == "ratio_min":
            num_name, den_name = obj.metric.split("/", 1)
            num = sum(c.value for c in self._matching(num_name, obj))
            den = sum(c.value for c in self._matching(den_name, obj))
            return float(den), float(max(0.0, den - num)), None
        # gauge kinds: each evaluation is one observation of the gauge
        insts = self._matching(obj.metric, obj)
        if not insts:
            return 0.0, 0.0, None
        value = max(i.value for i in insts) if obj.kind == "gauge_max" \
            else min(i.value for i in insts)
        st = self._state[obj.name]
        violated = (value > obj.threshold if obj.kind == "gauge_max"
                    else value < obj.threshold)
        return st.total + 1, st.bad + (1.0 if violated else 0.0), value

    # -- evaluation ----------------------------------------------------------

    def evaluate(self) -> List[SLOVerdict]:
        now = self.clock()
        maxw = self.spec.windows[-1][0]
        verdicts = []
        for obj in self.spec.objectives:
            st = self._state[obj.name]
            total, bad, value = self._sample(obj)
            st.total, st.bad = total, bad
            st.samples.append((now, total, bad))
            # keep exactly one sample at or older than the longest window
            while len(st.samples) > 1 and st.samples[1][0] <= now - maxw:
                st.samples.popleft()

            budget = 1.0 - obj.target
            burns, fracs = [], []
            for w, _thr in self.spec.windows:
                ref = st.samples[0]
                for s in st.samples:
                    if s[0] <= now - w:
                        ref = s
                    else:
                        break
                d_total = total - ref[1]
                d_bad = bad - ref[2]
                frac = (d_bad / d_total) if d_total > 0 else 0.0
                fracs.append(frac)
                burns.append(frac / budget)
            breaching = all(
                b >= thr for b, (_w, thr) in zip(burns, self.spec.windows))
            v = SLOVerdict(objective=obj.name, breaching=breaching,
                           burn_rates=tuple(burns),
                           windows=self.spec.windows,
                           fraction_bad=fracs[-1], value=value)
            verdicts.append(v)
            if breaching != st.breaching:
                st.breaching = breaching
                if breaching:
                    self.registry.counter(
                        "slo_breaches_total", objective=obj.name).inc()
                    self.registry.event(
                        "slo_breach", spec=self.spec.name,
                        objective=obj.name, burn=max(burns),
                        fraction_bad=fracs[-1], value=value)
                else:
                    self.registry.event(
                        "slo_recovered", spec=self.spec.name,
                        objective=obj.name)
        return verdicts

    @property
    def breaching(self) -> bool:
        """True while any objective is in the breaching state (as of the
        last `evaluate` call)."""
        return any(st.breaching for st in self._state.values())


__all__ = ["DEFAULT_WINDOWS", "Objective", "SLOMonitor", "SLOSpec",
           "SLOVerdict", "accept_floor", "kv_free_floor", "queue_depth_max",
           "tpot_target", "ttft_target"]
