"""The port's observability layer (`repro_torch.obs`) against the JAX
package's `repro.obs`.

On the CPU, fp32, the tiny config with JAX-made weights carried over by
`convert.from_jax_params` and near-identity task rows (perturbed by 0.01):
  * the instruments: the same values through both packages' `Histogram`
    give equal p50/p95/p99; registries fed alike render equal Prometheus
    text, equal JSON and .prom snapshots and equal fleet merges; the
    regression gate gives equal verdicts on equal payloads;
  * the schedulers: JAX's and the port's contiguous, paged, spec and
    spec_paged schedulers run one stream each (tolerance: exact) and give
    equal tokens, equal trace event names per request, equal counters and
    gauges (tokens, ticks, prefix hits by tier, free KV blocks, the
    speculation counters; bank counters over a hot-swap bank), and
    `report()` with JAX's keys;
  * the port alone: one registry across a mixed serve snapshots every
    series, its Prometheus text parses with cumulative buckets, the trace
    lifecycle is complete under fuzzed arrivals, the retrace watch fires
    once on an engine whose `trace_counts` grows mid-serve, `scope` is
    transparent and records nothing outside a capture, `ProfiledTicks`
    writes a Chrome trace, `run_train(obs=)` reports JAX's optimizer
    bytes, and the serve launcher's obs and SLO flags print JAX's lines.
"""
import contextlib
import io
import json
import math
import os
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_smoke as jget_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.launch import pretrain as jlaunch_pretrain
from repro.launch import serve as jlauncher
from repro.models import model as JM
from repro.obs import regress as jregress
from repro.serving import AdapterBank as JAdapterBank
from repro.serving import AdapterRegistry as JAdapterRegistry
from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro.common.types import OptimCfg as JOptimCfg
from repro.train import loop as jloop
from repro.train import steps as jsteps
from repro_torch import convert, obs
from repro_torch.common import types as T
from repro_torch.core import peft
from repro_torch.kernels import ops
from repro_torch.launch import serve as launcher
from repro_torch.obs import (DEFAULT_BUCKETS, Histogram, JsonlSink,
                             MetricsRegistry, NULL_TRACE, format_key,
                             render_prometheus, write_snapshot)
from repro_torch.obs import profile as oprof
from repro_torch.obs import regress
from repro_torch.serving import (AdapterBank, AdapterRegistry,
                                 MultiTaskEngine, Request, ServeEngine,
                                 ServingConfig, make_scheduler)
from repro_torch.train import loop, steps
from test_torch_model import KEY, jax_cfg, np_tree, port_cfg

KINDS = {
    "contiguous": dict(num_slots=2, max_len=32),
    "paged": dict(num_slots=2, max_len=32, paged=True, page_size=8),
    "spec": dict(num_slots=2, max_len=32, spec_k=2),
    "spec_paged": dict(num_slots=2, max_len=32, paged=True, page_size=8,
                       spec_k=2),
}
# JAX's report keys; the port's adds its host-time split
JAX_REPORT_KEYS = {
    "requests", "tokens", "elapsed_s", "ticks", "requests_per_s",
    "tokens_per_s", "mean_ttft_s", "mean_latency_s", "ttft_p50_s",
    "ttft_p95_s", "ttft_p99_s", "tpot_p50_s", "tpot_p95_s", "tpot_p99_s",
    "shed", "deferred_ticks", "degrade_steps", "degrade_level"}


@pytest.fixture(scope="module")
def world():
    """The tiny config with two near-identity task rows, in both
    packages."""
    jcfg = jax_cfg("tiny")
    pcfg = port_cfg(jcfg)
    jbase = JM.init_params(KEY, jcfg)
    jtasks = [jhad.perturb_adapters(jbase, jax.random.fold_in(KEY, 60 + t),
                                    scale=0.01) for t in range(2)]
    port = lambda t: convert.from_jax_params(np_tree(t), pcfg, "cpu")  # noqa
    return dict(jcfg=jcfg, pcfg=pcfg, jbase=jbase, pbase=port(jbase),
                jtasks=jtasks, ptasks=[port(t) for t in jtasks],
                jeng=JMultiTaskEngine(jcfg, jtasks),
                peng=MultiTaskEngine(pcfg, [port(t) for t in jtasks],
                                     device="cpu"))


def shared_prefix_stream(seed=3):
    """8 greedy requests over two 16-token prompts (two pages of 8), task
    rows alternating, and one more sharing prompt 0's first page: the
    paged schedulers see cold, whole-prompt and prefix admissions."""
    rs = np.random.RandomState(seed)
    pool = [rs.randint(0, 97, size=(16,)) for _ in range(2)]
    partial = pool[0].copy()
    partial[8:] = rs.randint(0, 97, size=(8,))
    reqs = [dict(prompt=pool[i % 2], max_new_tokens=6, task_id=i % 2)
            for i in range(7)]
    return reqs + [dict(prompt=partial, max_new_tokens=6, task_id=0)]


def trace_names(reg, ids):
    return [reg.tracer.find(i).names() for i in ids]


def timeless(snap):
    """A snapshot's series that do not depend on the host's clock: the
    counters, gauges, derived values, event counts, and each histogram's
    count (its values are host seconds)."""
    return dict(counters=snap["counters"], gauges=snap["gauges"],
                derived=snap["derived"], events=snap["events_by_kind"],
                traces=snap["traces"],
                hist_counts={k: h["count"]
                             for k, h in snap["histograms"].items()})


# ---------------------------------------------------------------------------
# the instruments against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("n", [1, 7, 60, 400])
def test_histogram_percentiles_equal_jaxs(seed, n):
    """Log-uniform values across (and past) the bucket layout, underflow
    and overflow buckets included: JAX's and the port's order-statistic
    estimates are equal, and inside the exact quantile's bucket."""
    rs = np.random.RandomState(seed)
    vals = np.exp(rs.uniform(np.log(1e-5), np.log(200.0), size=n))
    jh, ph = jobs.Histogram(), Histogram()
    for v in vals:
        jh.observe(float(v))
        ph.observe(float(v))
    assert ph.buckets == jh.buckets == DEFAULT_BUCKETS
    for q in (0.5, 0.95, 0.99):
        assert ph.percentile(q) == jh.percentile(q)
        exact = float(np.sort(vals)[max(1, math.ceil(q * n)) - 1])
        from bisect import bisect_left
        assert bisect_left(DEFAULT_BUCKETS, ph.percentile(q)) == \
            bisect_left(DEFAULT_BUCKETS, exact)
    assert ph.summary() == jh.summary()


def test_histogram_degenerate_and_refusals_as_jaxs():
    for mod in (jobs, obs):
        h = mod.Histogram()
        assert h.percentile(0.5) == 0.0 and h.summary()["count"] == 0
        for _ in range(9):
            h.observe(0.42)
        assert h.percentile(0.5) == h.percentile(0.99) == pytest.approx(0.42)
        with pytest.raises(ValueError, match="strictly increasing"):
            mod.Histogram(buckets=(1.0, 1.0))


def test_registry_labels_kinds_disabled_and_derived():
    reg = MetricsRegistry()
    a = reg.counter("hits_total", tenant="a")
    assert a is reg.counter("hits_total", tenant="a")
    assert reg.counter("x_total", b="2", a="1") is \
        reg.counter("x_total", a="1", b="2")
    a.inc(3)
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.histogram("hits_total", tenant="a")
    hits = reg.counter("h_total")
    reg.add_derived("ratio", lambda: hits.value / 10)
    hits.inc(4)
    snap = reg.snapshot()
    assert snap["counters"]["hits_total{tenant=a}"] == 3
    assert snap["derived"]["ratio"] == pytest.approx(0.4)
    off = MetricsRegistry(enabled=False)
    c = off.counter("a_total")
    assert c is off.gauge("b") is off.histogram("c_s")
    c.inc(5)
    off.event("retrace", fn="decode")
    assert c.value == 0 and not off.events
    assert off.tracer.start(1) is NULL_TRACE
    assert off.snapshot()["counters"] == {}


def _feed(mod, reg):
    """The same series, events and a nasty label value, into a registry
    of either package."""
    reg.counter("serve_tokens_total", sched="paged").inc(7)
    reg.counter("bank_hits_total", tenant='ten\\ant "a"\nx').inc(3)
    reg.gauge("kv_free_blocks").set(11)
    h = reg.histogram("serve_ttft_s", sched="paged")
    for v in (0.00005, 0.004, 0.12, 3.5, 70.0):
        h.observe(v)
    reg.histogram("custom_s", buckets=(0.1, 1.0)).observe(0.5)
    hits = reg.counter("serve_prefix_hits_total", tier="full")
    hits.inc(2)
    reg.add_derived("hit_ratio", lambda: hits.value / 8)
    reg.event("shed", sched="paged", level=5)


def test_exporters_equal_jaxs(tmp_path):
    """Registries fed alike: equal Prometheus text, equal JSON and .prom
    snapshots (every field but the events' wall times), equal fleet
    merges, and JSONL events with JAX's fields."""
    jreg, preg = jobs.MetricsRegistry(), MetricsRegistry()
    jsink = jobs.JsonlSink(str(tmp_path / "j" / "e.jsonl"))
    psink = JsonlSink(str(tmp_path / "p" / "e.jsonl"))
    jreg.add_sink(jsink)
    preg.add_sink(psink)
    _feed(jobs, jreg)
    _feed(obs, preg)
    jsink.close()
    psink.close()
    assert render_prometheus(preg) == jobs.render_prometheus(jreg)
    for name in ("m.json", "m.prom"):
        jsnap = jobs.write_snapshot(jreg, str(tmp_path / "j" / name))
        psnap = write_snapshot(preg, str(tmp_path / "p" / name))
        assert psnap == jsnap
        assert (tmp_path / "p" / name).read_text() == \
            (tmp_path / "j" / name).read_text()
    je = [json.loads(x) for x in
          (tmp_path / "j" / "e.jsonl").read_text().splitlines()]
    pe = [json.loads(x) for x in
          (tmp_path / "p" / "e.jsonl").read_text().splitlines()]
    for e in je + pe:
        e.pop("t_unix")
    assert pe == je == [{"event": "shed", "sched": "paged", "level": 5}]
    # two replicas each, merged: the same fleet view
    j2, p2 = jobs.MetricsRegistry(), MetricsRegistry()
    j2.histogram("serve_ttft_s", sched="paged").observe(0.3)
    p2.histogram("serve_ttft_s", sched="paged").observe(0.3)
    j2.gauge("kv_free_blocks").set(2)
    p2.gauge("kv_free_blocks").set(2)
    jf = jobs.merge_snapshots([jobs.mergeable_snapshot(jreg, "r0"),
                               jobs.mergeable_snapshot(j2, "r1")])
    pf = obs.merge_snapshots([obs.mergeable_snapshot(preg, "r0"),
                              obs.mergeable_snapshot(p2, "r1")])
    jf.pop("t_unix")
    pf.pop("t_unix")
    assert pf == jf
    hk = "serve_ttft_s{sched=paged}"
    assert obs.merged_histogram(pf["histograms"][hk]).percentile(0.5) == \
        jobs.merged_histogram(jf["histograms"][hk]).percentile(0.5)


def _payload(metrics, backend="cpu", fast=True, sha="cafe"):
    return {"schema": "repro-bench-v2", "git_sha": sha,
            "created_unix": 1.7e9, "created_utc": "2026-08-08T00:00:00",
            "backend": backend, "fast": fast, "failures": [],
            "suites": {"kernels": [{"name": n, "us_per_call": us,
                                    "derived": ""}
                                   for n, us in metrics.items()]}}


@pytest.mark.parametrize("current,kw", [
    ({"decode": 120.0, "prefill": 50.0}, {}),
    ({"decode": 300.0, "prefill": 50.0}, {}),
    ({"decode": 300.0, "prefill": 50.0},
     dict(tolerances={"kernels:decode": 3.0})),
    ({"decode": 40.0, "prefill": 50.0},
     dict(higher_is_better=("kernels:decode",))),
    ({"decode": 100.0, "attn": 5.0}, {}),
    ({"decode": 900.0}, dict(backend="gpu")),
])
def test_regression_gate_verdicts_equal_jaxs(current, kw, tmp_path):
    history = [jregress.history_entry(_payload({"decode": us,
                                                "prefill": 50.0}))
               for us in (90.0, 100.0, 400.0)]
    assert [regress.history_entry(_payload({"decode": us, "prefill": 50.0}))
            for us in (90.0, 100.0, 400.0)] == history
    backend = kw.pop("backend", "cpu")
    cur = _payload(current, backend=backend)
    got = regress.check_regression(history, cur, **kw)
    want = jregress.check_regression(history, cur, **kw)
    assert [tuple(vars(v).values()) for v in got.verdicts] == \
        [tuple(vars(v).values()) for v in want.verdicts]
    assert got.ok == want.ok
    assert got.summary_lines() == want.summary_lines()
    path = str(tmp_path / "hist.jsonl")
    regress.append_history(path, regress.history_entry(cur))
    assert jregress.load_history(path) == regress.load_history(path)


# ---------------------------------------------------------------------------
# the schedulers against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_scheduler_metrics_and_traces_equal_jaxs(world, kind):
    """One stream through each package's scheduler of `kind`: equal
    tokens, equal trace event names per request, equal counters, gauges,
    derived values, event counts and histogram counts, and JAX's report
    keys (plus the port's prefill_s/decode_s)."""
    stream = shared_prefix_stream()
    jreg, preg = jobs.MetricsRegistry(), MetricsRegistry()
    jsched = jmake_scheduler(world["jeng"], JServingConfig(**KINDS[kind]),
                             obs=jreg)
    psched = make_scheduler(world["peng"], ServingConfig(**KINDS[kind]),
                            obs=preg)
    assert psched._sched_kind == jsched._sched_kind == kind
    jdone, jrep = jsched.run([JRequest(**t) for t in stream])
    pdone, prep = psched.run([Request(**t) for t in stream])
    for j, p in zip(jdone, pdone):
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens))
        assert p.finish_reason == j.finish_reason
    ids = [c.request_id for c in pdone]
    assert trace_names(preg, ids) == trace_names(jreg, ids)
    assert timeless(preg.snapshot()) == timeless(jreg.snapshot())
    assert set(prep) == JAX_REPORT_KEYS | {"prefill_s", "decode_s"}
    assert set(jrep) == JAX_REPORT_KEYS
    for k in ("requests", "tokens", "ticks", "shed", "deferred_ticks",
              "degrade_steps", "degrade_level"):
        assert prep[k] == jrep[k], k
    c = preg.snapshot()["counters"]
    assert c[f"serve_tokens_total{{sched={kind}}}"] == prep["tokens"]
    assert c[f"serve_ticks_total{{sched={kind}}}"] == prep["ticks"]
    if "paged" in kind:
        assert c["serve_prefix_hits_total{tier=full}"] > 0
        assert c["serve_prefix_hits_total{tier=partial}"] > 0
        assert psched.stats == jsched.stats
    if "spec" in kind:
        assert psched.spec_stats == jsched.spec_stats
        assert c["serve_spec_drafted_total"] == \
            psched.spec_stats["drafted"] > 0


def test_bank_counters_and_events_equal_jaxs(world):
    """A 1-row hot-swap bank over two tenants (published by the port into
    each package's registry): equal tokens, bank_*_total counters and
    bank_evict events, the counters moved onto the scheduler's registry
    with the counts made before."""
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 97, size=(6,)) for _ in range(4)]
    with tempfile.TemporaryDirectory() as td:
        banks = {}
        for pkg, reg_cls, bank_cls, base in (
                ("jax", JAdapterRegistry, JAdapterBank, world["jbase"]),
                ("port", AdapterRegistry, AdapterBank, world["pbase"])):
            pub = AdapterRegistry(os.path.join(td, pkg))
            for t, v in enumerate(world["ptasks"]):
                pub.publish(f"tenant{t}",
                            launcher.task_delta(v, world["pcfg"]))
            cfg = world["jcfg"] if pkg == "jax" else world["pcfg"]
            banks[pkg] = bank_cls(cfg, base, 1,
                                  reg_cls(os.path.join(td, pkg)))
        banks["jax"].lookup("tenant1")  # a load before any scheduler
        banks["port"].lookup("tenant1")
        jreg, preg = jobs.MetricsRegistry(), MetricsRegistry()
        jsched = jmake_scheduler(JMultiTaskEngine(world["jcfg"],
                                                  banks["jax"]),
                                 JServingConfig(num_slots=1, max_len=32),
                                 obs=jreg)
        psched = make_scheduler(MultiTaskEngine(world["pcfg"], banks["port"],
                                                device="cpu"),
                                ServingConfig(num_slots=1, max_len=32),
                                obs=preg)
        jdone, _ = jsched.run([JRequest(prompt=p, max_new_tokens=3,
                                        adapter=f"tenant{i % 2}")
                               for i, p in enumerate(prompts)])
        pdone, _ = psched.run([Request(prompt=p, max_new_tokens=3,
                                       adapter=f"tenant{i % 2}")
                               for i, p in enumerate(prompts)])
    for j, p in zip(jdone, pdone):
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens))
    jc, pc = jreg.snapshot()["counters"], preg.snapshot()["counters"]
    bank_keys = [k for k in jc if k.startswith("bank_")]
    assert sorted(bank_keys) == ["bank_evictions_total", "bank_hits_total",
                                 "bank_loads_total", "bank_pin_stalls_total"]
    assert {k: pc[k] for k in bank_keys} == {k: jc[k] for k in bank_keys}
    assert pc["bank_loads_total"] == 5 and pc["bank_evictions_total"] == 4
    assert len(preg.events_of("bank_evict")) == \
        len(jreg.events_of("bank_evict")) == 4
    assert banks["port"].stats()["loads"] == pc["bank_loads_total"]
    assert timeless(preg.snapshot()) == timeless(jreg.snapshot())


# ---------------------------------------------------------------------------
# the port's own: one registry across the stack, exporters under a serve
# ---------------------------------------------------------------------------


def test_mixed_serve_snapshot_has_every_series(world, tmp_path):
    """A spec+paged serve and a hot-swap serve feeding ONE registry:
    TTFT/TPOT p50/p95/p99, prefix hit ratios, spec acceptance, bank
    evictions and zero retraces, in the JSON snapshot; the report carries
    the histograms' quantiles."""
    reg = MetricsRegistry()
    sched = make_scheduler(world["peng"], ServingConfig(**KINDS[
        "spec_paged"]), obs=reg)
    done, report = sched.run([Request(**t) for t in shared_prefix_stream()])
    assert len(done) == 8
    with tempfile.TemporaryDirectory() as adir:
        registry = AdapterRegistry(adir)
        for t, v in enumerate(world["ptasks"]):
            registry.publish(f"tenant{t}", launcher.task_delta(
                v, world["pcfg"]))
        bank = AdapterBank(world["pcfg"], world["pbase"], 1, registry)
        bsched = make_scheduler(MultiTaskEngine(world["pcfg"], bank,
                                                device="cpu"),
                                ServingConfig(num_slots=1, max_len=32),
                                obs=reg)
        bdone, _ = bsched.run([Request(prompt=np.arange(5), max_new_tokens=3,
                                       adapter=f"tenant{i % 2}")
                               for i in range(4)])
        assert len(bdone) == 4
    snap = write_snapshot(reg, str(tmp_path / "serve_metrics.json"))
    assert json.loads((tmp_path / "serve_metrics.json").read_text()) == snap
    ttft = snap["histograms"]["serve_ttft_s{sched=spec_paged}"]
    tpot = snap["histograms"]["serve_tpot_s{sched=spec_paged}"]
    for s in (ttft, tpot):
        assert s["count"] > 0 and 0 <= s["p50"] <= s["p95"] <= s["p99"]
    assert report["ttft_p50_s"] == pytest.approx(ttft["p50"])
    assert report["tpot_p99_s"] == pytest.approx(tpot["p99"])
    c = snap["counters"]
    assert c["serve_prefix_hits_total{tier=full}"] > 0
    assert c["serve_prefix_hits_total{tier=partial}"] > 0
    assert 0.0 < snap["derived"]["prefix_hit_ratio_full"] < 1.0
    assert snap["derived"]["spec_acceptance_rate"] == \
        pytest.approx(sched.acceptance_rate)
    assert c["bank_evictions_total"] > 0
    assert c["bank_loads_total"] > c["bank_hits_total"] >= 0
    assert snap["events_by_kind"].get("retrace", 0) == 0
    assert c["serve_retrace_events_total{sched=spec_paged}"] == 0
    assert snap["events_by_kind"]["bank_evict"] == c["bank_evictions_total"]
    assert any(k.startswith("serve_ttft_s{") and "tenant=" in k
               for k in snap["histograms"])
    assert sched.stats["full_hits"] == c["serve_prefix_hits_total{tier=full}"]
    assert sched.spec_stats["drafted"] == c["serve_spec_drafted_total"]
    assert bank.evictions == c["bank_evictions_total"]


def _parse_prom(text):
    """A strict reading of the v0.0.4 exposition: ({name: kind},
    [(name, labels, value)]), one TYPE line per name."""
    typed, samples = {}, []
    assert text.endswith("\n")
    for line in text[:-1].split("\n"):
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            assert kind in ("counter", "gauge", "histogram")
            assert name not in typed
            typed[name] = kind
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            body, val = rest.rsplit("} ", 1)
            labels = dict(kv.split("=", 1) for kv in body.split('",'))
            labels = {k: v.strip('"') for k, v in labels.items()}
        else:
            name, val = line.rsplit(" ", 1)
            labels = {}
        samples.append((name, labels, float(val)))
    return typed, samples


def test_prometheus_round_trip_under_a_real_serve(world):
    """Every sample has a TYPE line, histogram buckets are cumulative and
    end at +Inf == _count, and each counter's value is the snapshot's."""
    reg = MetricsRegistry()
    sched = make_scheduler(world["peng"], ServingConfig(**KINDS[
        "spec_paged"]), obs=reg)
    rs = np.random.RandomState(5)
    sched.run([Request(prompt=rs.randint(0, 97, size=(8,)),
                       max_new_tokens=4, task_id=i % 2) for i in range(5)])
    typed, samples = _parse_prom(render_prometheus(reg))
    groups = {}
    for name, labels, value in samples:
        base = name
        for suf in ("_bucket", "_sum", "_count"):
            if name.endswith(suf) and name[:-len(suf)] in typed:
                base = name[:-len(suf)]
        assert base in typed, name
        if typed[base] != "histogram":
            continue
        key = (base, tuple(sorted((k, v) for k, v in labels.items()
                                  if k != "le")))
        g = groups.setdefault(key, {"buckets": []})
        if name.endswith("_bucket"):
            g["buckets"].append((float(labels["le"]), value))
        else:
            g[name[len(base) + 1:]] = value
    assert any(b == "serve_ttft_s" for b, _ in groups)
    for g in groups.values():
        les = [le for le, _ in g["buckets"]]
        cums = [c for _, c in g["buckets"]]
        assert les == sorted(les) and les[-1] == math.inf
        assert all(a <= b for a, b in zip(cums, cums[1:]))
        assert cums[-1] == g["count"]
    snap = reg.snapshot()
    rendered = {format_key(n, tuple(sorted(lab.items()))): v
                for n, lab, v in samples if typed.get(n) == "counter"}
    for k, v in snap["counters"].items():
        assert rendered[k] == v, k


@pytest.mark.parametrize("kind", ["contiguous", "spec_paged"])
def test_trace_lifecycle_complete_under_fuzz(world, kind):
    """Requests submitted at random ticks: every completed trace starts
    with submit, admits once, has one prefill of a known kind, a
    first_token, one token mark per emitted token, and ends with retire
    (its completion's reason); mark times are monotone."""
    reg = MetricsRegistry()
    sched = make_scheduler(world["peng"], ServingConfig(**KINDS[kind]),
                           obs=reg)
    rs = np.random.RandomState(7)
    reqs = [Request(prompt=rs.randint(0, 97, size=(int(rs.randint(2, 9)),)),
                    max_new_tokens=int(rs.randint(1, 7)), task_id=i % 2)
            for i in range(9)]
    ids, t = [None] * len(reqs), 0
    while None in ids or sched.pending or sched.active:
        for i, r in enumerate(reqs):
            if ids[i] is None and int(rs.randint(0, 2)):
                ids[i] = sched.submit(r)
        sched.step()
        t += 1
        assert t < 500
    for rid in ids:
        c = sched.completions.pop(rid)
        tr = reg.tracer.find(rid)
        names = tr.names()
        assert names[0] == "submit" and names[-1] == "retire"
        assert tr.count("admit") == tr.count("prefill") == 1
        assert tr.count("first_token") == 1
        assert tr.count("token") == len(c.tokens)
        assert tr.attrs_of("retire")["reason"] == c.finish_reason
        assert tr.attrs_of("prefill")["kind"] in ("cold", "full_hit",
                                                  "partial_hit")
        dts = [dt for _, dt, _ in tr.events]
        assert dts == sorted(dts)
    assert not reg.tracer.active
    if kind == "spec_paged":
        assert any(reg.tracer.find(r).count("verify") for r in ids)


def test_retrace_watch_fires_once_on_a_growing_trace_count(world, capsys):
    """The port's engines keep no `trace_counts`, so the watch is empty
    and the counter reads 0; an engine that keeps one, bumped mid-serve
    past its allowance, gives one event, the counter 1 and a warning, and
    fires no more."""
    reg = MetricsRegistry()
    make_scheduler(world["peng"], ServingConfig(num_slots=2, max_len=32),
                   obs=reg)
    assert reg.snapshot()["counters"][
        "serve_retrace_events_total{sched=contiguous}"] == 0
    eng = ServeEngine(world["pcfg"], world["ptasks"][0], device="cpu")
    eng.trace_counts = {"decode": 1, "prefill": 3}
    reg = MetricsRegistry()
    sched = make_scheduler(eng, ServingConfig(num_slots=2, max_len=32),
                           obs=reg)
    sched.submit(Request(prompt=np.arange(4), max_new_tokens=8))
    sched.step()
    eng.trace_counts["decode"] = 2  # within the allowance (one compile)
    eng.trace_counts["prefill"] = 9  # not a watched call
    sched.step()
    assert reg.events_of("retrace") == []
    eng.trace_counts["decode"] = 3
    sched.step()
    (ev,) = reg.events_of("retrace")
    assert ev["fn"] == "decode" and ev["count"] == 1
    assert reg.snapshot()["counters"][
        "serve_retrace_events_total{sched=contiguous}"] == 1
    assert "recompiled mid-serve" in capsys.readouterr().err
    sched.step()
    assert len(reg.events_of("retrace")) == 1
    while sched.pending or sched.active:
        sched.step()


# ---------------------------------------------------------------------------
# profiling and training
# ---------------------------------------------------------------------------


def test_scope_is_transparent_and_records_nothing_outside_a_capture(
        monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def spy(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)

    @obs.scope("repro.test_op")
    def f(x):
        return x + 1

    assert f(1) == 2 and f.__name__ == "f"
    with obs.scope("repro.block") as s:
        pass
    assert s.name == "repro.block"
    x = torch.randn(3, 8)
    w, b = torch.randn(8), torch.randn(8)
    torch.testing.assert_close(ops.hadamard(x, w, b), x * w + b)
    assert calls == []
    with tempfile.TemporaryDirectory() as td:
        with obs.profiler_trace(td):
            assert f(1) == 2
            ops.hadamard(x, w, b)
            with obs.scope("repro.block"):
                pass
        assert calls == ["repro.test_op", "repro.hadamard", "repro.block"]
        names = {e.get("name") for e in json.load(open(
            os.path.join(td, oprof.TRACE_FILE)))["traceEvents"]}
    assert {"repro.test_op", "repro.hadamard", "repro.block"} <= names
    assert not oprof._capturing
    f(1)
    assert len(calls) == 3


def test_profiled_ticks_writes_a_trace_and_stops_once(tmp_path):
    pt = obs.ProfiledTicks(str(tmp_path / "prof"), n=2)
    assert oprof._capturing
    x = torch.randn(2, 8)
    for i in range(4):
        ops.hadamard(x, torch.ones(8), torch.zeros(8))
        pt.tick()
        assert oprof._capturing == (i == 0)
    pt.stop()  # already stopped after 2 ticks: nothing happens
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert sum(e.get("name") == "repro.hadamard"
               for e in trace["traceEvents"]) == 2
    with obs.annotate("tick"):  # records nothing outside a capture
        pass


@pytest.mark.parametrize("preset", ["", "bf16+int8"])
def test_run_train_reports_jaxs_opt_state_bytes(preset, monkeypatch):
    """qwen3 smoke under 'hadamard': `train_opt_state_bytes` equals JAX's
    for the same model and moments; under a watchdog every step lands in
    `train_step_s`, and a planted straggler is counted with its event."""
    m, v = jlaunch_pretrain.QUANT_PRESETS[preset]
    kw = dict(m_dtype=m, v_dtype=v)
    qcfg = jpeft.attach(jget_smoke("qwen3-0.6b"), jpeft.strategy("hadamard"))
    qparams = JM.init_params(KEY, qcfg)
    jstate = jsteps.make_state(KEY, qcfg, jpeft.strategy("hadamard"),
                               JOptimCfg(**kw), params=qparams)
    state = steps.make_state(None, port_cfg(qcfg), peft.strategy("hadamard"),
                             T.OptimCfg(**kw), params=convert.from_jax_params(
                                 np_tree(qparams), port_cfg(qcfg), "cpu"))
    jreg, preg = jobs.MetricsRegistry(), MetricsRegistry()

    def jstep(st, batch):
        return st, {"loss": jnp.float32(0.0), "grad_norm": jnp.float32(0.0)}

    jloop.run_train(jstate, jstep, iter([{"x": jnp.zeros((1,))}] * 2),
                    steps=2, obs=jreg, log=lambda s: s)
    # the loop reads a scripted clock that each step advances by its
    # length: 20 ms steps and a 0.5 s one, so the count of stragglers at
    # factor 10 does not depend on the host
    lengths = iter([0.02, 0.02, 0.02, 0.5, 0.02])
    now = [0.0]
    monkeypatch.setattr(loop, "time",
                        types.SimpleNamespace(perf_counter=lambda: now[0]))

    def pstep(st, batch):
        now[0] += next(lengths)
        return st, {"loss": torch.tensor(0.0), "grad_norm": torch.tensor(0.0)}

    logs = []
    loop.run_train(state, pstep, iter([{"x": np.zeros(1)}] * 5), steps=5,
                   obs=preg, watchdog=loop.StepWatchdog(factor=10.0),
                   log=logs.append)
    got = preg.snapshot()
    assert got["gauges"]["train_opt_state_bytes"] == \
        jreg.snapshot()["gauges"]["train_opt_state_bytes"] > 0
    assert got["histograms"]["train_step_s"]["count"] == 5
    assert got["histograms"]["train_step_s"]["sum"] == pytest.approx(0.58)
    assert got["counters"]["train_straggler_steps_total"] == 1
    (ev,) = preg.events_of("straggler")
    assert ev["step"] == 3 and any("straggler step 3" in s for s in logs)


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------


def _run_launcher(main_fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main_fn(argv)
    return out.getvalue()


def _jax_main(argv):
    old = sys.argv
    sys.argv = ["serve", *argv]
    try:
        jlauncher.main()
    finally:
        sys.argv = old


FLAGS = ["--arch", "qwen3-0.6b", "--smoke", "--page-size", "16",
         "--spec-k", "4", "--slo-queue-depth", "2", "--admission",
         "--metrics-every", "2"]


def test_launcher_obs_and_slo_flags_print_jaxs_lines(tmp_path):
    """Both launchers over the same flags: the SLO header and closing
    lines' shape, the [obs] digest, the snapshot and profile lines, and
    JSON snapshots with the same series; the port's .prom parses and its
    profile holds the kernel ranges."""
    texts, snaps = {}, {}
    for pkg, fn, extra in (("jax", _jax_main, []),
                           ("port", launcher.main, ["--device", "cpu"])):
        d = tmp_path / pkg
        texts[pkg] = _run_launcher(fn, [
            *FLAGS, *extra, "--metrics-file", str(d / "m.json"),
            "--events-file", str(d / "e.jsonl"),
            "--profile-dir", str(d / "prof"), "--profile-ticks", "2"])
        snaps[pkg] = json.loads((d / "m.json").read_text())
        for line in (d / "e.jsonl").read_text().splitlines():
            json.loads(line)
    for pkg, text in texts.items():
        d = tmp_path / pkg
        assert "SLOs: queue_le_2 (admission ladder armed)" in text
        assert any(line.startswith("SLO: ") and "ladder level" in line
                   for line in text.splitlines()), text
        assert "[obs] tick 2: " in text
        assert f"metrics snapshot -> {d / 'm.json'}" in text
        assert f"profiler trace -> {d / 'prof'}" in text
        assert "WARNING" not in text
    # the series (but a breach counter, which exists once an objective
    # breached on the host's clock)
    for part in ("counters", "gauges", "histograms", "derived"):
        assert ({k for k in snaps["port"][part]
                 if not k.startswith("slo_breaches_total")}
                == {k for k in snaps["jax"][part]
                    if not k.startswith("slo_breaches_total")}), part
    # (JAX's launcher staggers prompt lengths and budgets, the port's
    # does not: the requests agree, not their tokens)
    k = "serve_requests_submitted_total{sched=spec_paged}"
    assert snaps["port"]["counters"][k] == snaps["jax"]["counters"][k] == 8
    assert snaps["port"]["counters"]["serve_tokens_total{sched=spec_paged}"] \
        == 64
    trace = json.loads((tmp_path / "port" / "prof" / "trace.json")
                       .read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"repro.paged_attention", "repro.fused_adapter_norm"} <= names
    prom = tmp_path / "port" / "m.prom"
    with contextlib.redirect_stdout(io.StringIO()):
        reg = launcher.main([*FLAGS, "--device", "cpu",
                             "--metrics-file", str(prom)])
    typed, samples = _parse_prom(prom.read_text())
    assert typed["serve_ttft_s"] == "histogram" and samples
    # main returns the serve's registry: the .prom file is its text
    assert render_prometheus(reg) == prom.read_text()


@pytest.mark.parametrize("flags,msg", [
    (["--slo-kv-free", "4"], "--slo-kv-free needs paged KV (--page-size)"),
    (["--slo-accept", "0.5"], "--slo-accept needs speculation (--spec-k)"),
    (["--admission"], "--admission needs at least one --slo-* objective"),
])
def test_launcher_refuses_what_jax_refuses(flags, msg):
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--requests", "1", *flags]
    with pytest.raises(SystemExit) as jerr:
        _jax_main(argv)
    with pytest.raises(SystemExit) as perr:
        launcher.main([*argv, "--device", "cpu"])
    assert str(perr.value) == str(jerr.value) == msg
