"""Perf-regression trajectory gate over a bench history (port of
`repro.obs.regress`, standard library only).

  * `history_entry(payload)` flattens one bench payload (the JSON schema
    of `benchmarks/run.py`) into an append-only JSONL record: git SHA,
    UTC timestamp, schema version, backend/fast flags, and a flat
    ``suite:row`` -> us map.
  * `append_history` / `load_history` keep that history, one line per
    bench run, newest last.
  * `check_regression(history, current)` compares the current payload
    against a **median-of-history** baseline: the median absorbs noisy
    outlier runs without letting a slow drift redefine "normal". A metric
    regresses when it exceeds the baseline by more than its tolerance in
    its bad direction (us per call: higher is worse, by default).

The module is the standard library alone, so the gate does not depend on
the harness it judges: ``python -m repro_torch.obs.regress --history H
--current C`` exits non-zero on a regression.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

HISTORY_SCHEMA = "repro-bench-hist-v1"

# payload schemas this module knows how to flatten
_KNOWN_PAYLOADS = ("repro-bench-v1", "repro-bench-v2")

# how much worse than the baseline a metric may be before it counts as a
# regression. Bench timings on shared CI runners are noisy; 50% headroom
# catches the 2x cliffs that matter without paging on scheduler jitter.
DEFAULT_TOLERANCE = 0.5


def bench_metrics(payload: dict) -> Dict[str, float]:
    """Flatten a bench payload to ``{"suite:row": us_per_call}``.

    Rows with us <= 0 are dropped: suites use 0.0 for pass/fail gate
    rows whose signal lives in `derived`, not in the timing.
    """
    out: Dict[str, float] = {}
    for suite, rows in payload.get("suites", {}).items():
        for r in rows:
            us = float(r["us_per_call"])
            if us > 0:
                out[f"{suite}:{r['name']}"] = us
    return out


def history_entry(payload: dict) -> dict:
    """One self-contained JSONL record for a bench run."""
    if payload.get("schema") not in _KNOWN_PAYLOADS:
        raise ValueError(
            f"unknown bench payload schema {payload.get('schema')!r} "
            f"(known: {_KNOWN_PAYLOADS})")
    return {
        "schema": HISTORY_SCHEMA,
        "payload_schema": payload["schema"],
        "git_sha": payload.get("git_sha", "unknown"),
        "created_utc": payload.get("created_utc", ""),
        "created_unix": payload.get("created_unix", 0.0),
        "backend": payload.get("backend", "unknown"),
        "fast": bool(payload.get("fast", True)),
        "failures": list(payload.get("failures", [])),
        "metrics": bench_metrics(payload),
    }


def append_history(path: str, entry: dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry, sort_keys=True) + "\n")


def load_history(path: str) -> List[dict]:
    """History entries, oldest first; missing file is an empty history."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            if entry.get("schema") != HISTORY_SCHEMA:
                raise ValueError(
                    f"{path}:{i + 1}: schema {entry.get('schema')!r} "
                    f"(want {HISTORY_SCHEMA})")
            out.append(entry)
    return out


@dataclass(frozen=True)
class MetricVerdict:
    """One metric's comparison against its median-of-history baseline."""

    metric: str
    status: str  # ok | regression | improved | new | missing
    baseline: Optional[float]  # median over comparable history, None if new
    current: Optional[float]   # None when missing from the current run
    ratio: Optional[float]     # current / baseline where both exist


@dataclass(frozen=True)
class RegressionReport:
    verdicts: List[MetricVerdict]
    comparable_runs: int  # history entries matching this run's backend+fast

    @property
    def regressions(self) -> List[MetricVerdict]:
        return [v for v in self.verdicts if v.status == "regression"]

    @property
    def missing(self) -> List[MetricVerdict]:
        return [v for v in self.verdicts if v.status == "missing"]

    @property
    def ok(self) -> bool:
        return not self.regressions

    def summary_lines(self) -> List[str]:
        lines = [f"# regression check: {len(self.verdicts)} metrics vs "
                 f"{self.comparable_runs} comparable history runs"]
        for v in self.verdicts:
            if v.status == "ok":
                continue
            detail = ""
            if v.baseline is not None and v.current is not None:
                detail = (f": {v.current:.1f}us vs baseline "
                          f"{v.baseline:.1f}us ({v.ratio:.2f}x)")
            lines.append(f"#   {v.status.upper()} {v.metric}{detail}")
        if self.ok:
            lines.append("# no regressions")
        return lines


def check_regression(history: Sequence[dict], current_payload: dict, *,
                     tolerance: float = DEFAULT_TOLERANCE,
                     min_runs: int = 1,
                     tolerances: Optional[Dict[str, float]] = None,
                     higher_is_better: Sequence[str] = ()) -> RegressionReport:
    """Compare a current bench payload against the history baseline.

    Baselines are per-metric medians over history entries comparable to
    this run (same backend and same fast/full setting - a CPU fast run
    must never be judged against a GPU full-budget baseline). A metric
    regresses when it is worse than baseline * (1 + tolerance) in its
    bad direction; per-metric overrides go in `tolerances`, and metrics
    named in `higher_is_better` invert the direction. New metrics and
    metrics missing from the current run are reported but never fail the
    gate (a missing suite is the harness's own failure). Fewer
    than `min_runs` comparable history entries means everything passes
    as "new" - the seeding run that starts a trajectory.
    """
    current = history_entry(current_payload)
    cur_metrics = current["metrics"]
    comparable = [h for h in history
                  if h.get("backend") == current["backend"]
                  and bool(h.get("fast", True)) == current["fast"]]
    hib = set(higher_is_better)
    tolerances = tolerances or {}

    baselines: Dict[str, float] = {}
    if len(comparable) >= min_runs:
        for name in {m for h in comparable for m in h["metrics"]}:
            vals = [h["metrics"][name] for h in comparable
                    if name in h["metrics"]]
            if vals:
                baselines[name] = statistics.median(vals)

    verdicts: List[MetricVerdict] = []
    for name in sorted(set(cur_metrics) | set(baselines)):
        base = baselines.get(name)
        cur = cur_metrics.get(name)
        if cur is None:
            verdicts.append(MetricVerdict(name, "missing", base, None, None))
            continue
        if base is None:
            verdicts.append(MetricVerdict(name, "new", None, cur, None))
            continue
        ratio = cur / base if base > 0 else 1.0
        tol = tolerances.get(name, tolerance)
        if name in hib:
            worse = cur < base / (1.0 + tol)
            better = cur > base
        else:
            worse = cur > base * (1.0 + tol)
            better = cur < base
        status = "regression" if worse else ("improved" if better else "ok")
        verdicts.append(MetricVerdict(name, status, base, cur, ratio))
    return RegressionReport(verdicts=verdicts,
                            comparable_runs=len(comparable))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="gate a bench payload against BENCH_history.jsonl")
    ap.add_argument("--history", required=True,
                    help="path to BENCH_history.jsonl (missing = empty)")
    ap.add_argument("--current", required=True,
                    help="path to a bench payload (benchmarks/run.py's JSON schema)")
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE)
    ap.add_argument("--append", action="store_true",
                    help="append the current run to the history after "
                         "checking (regardless of verdict: the trajectory "
                         "should record bad runs too)")
    args = ap.parse_args(argv)

    with open(args.current) as f:
        payload = json.load(f)
    history = load_history(args.history)
    report = check_regression(history, payload, tolerance=args.tolerance)
    for line in report.summary_lines():
        print(line)
    if args.append:
        append_history(args.history, history_entry(payload))
        print(f"# appended run to {args.history} "
              f"({len(history) + 1} entries)")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["DEFAULT_TOLERANCE", "HISTORY_SCHEMA", "MetricVerdict",
           "RegressionReport", "append_history", "bench_metrics",
           "check_regression", "history_entry", "load_history", "main"]
