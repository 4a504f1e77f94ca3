"""The port's SLO engine, admission ladder, fleet merge and regression gate
against the JAX package's.

Monitors of both packages read registries fed alike on one injected clock
and give the same verdicts, burn rates and breach/recovery events; the
objectives and specs refuse what JAX refuses; merging replicas equals one
registry that saw both streams. Then JAX's overload test
(`tests/test_slo.py`) on both packages in lockstep, on the tiny config
with JAX-made weights carried over by `convert.from_jax_params`: a
spec+paged scheduler driven past a queue-depth SLO walks prefix_fill_stop
-> spec_k=1 -> spec_k=0 -> defer -> shed, raises the typed shed error,
recovers by hysteresis, and gives the same `degrade` events (rung,
direction, level, tick), the same shed/deferred/degrade counts and the
same tokens as JAX and as an unloaded run (tolerance: exact). Last the
monitor-only attachment, `ServingConfig`'s wiring and refusals, and the
gate's command line.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import obs as jobs
from repro.serving import AdmissionConfig as JAdmissionConfig
from repro.serving import AdmissionShedError as JAdmissionShedError
from repro.serving import Request as JRequest
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro_torch import obs
from repro_torch.obs import (MetricsRegistry, SLOSpec, merge_snapshots,
                             mergeable_snapshot, merged_histogram,
                             queue_depth_max)
from repro_torch.serving import (AdmissionConfig, AdmissionController,
                                 AdmissionShedError, Request, ServingConfig,
                                 make_scheduler)
from test_torch_obs import world  # noqa: F401 (the module fixture)

ROOT = Path(__file__).resolve().parents[1]
WINDOWS = ((2.0, 1.0), (10.0, 1.0))
OVERLOAD = dict(num_slots=2, max_len=32, paged=True, page_size=8, spec_k=2)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _pair(objectives, windows=WINDOWS, base=None):
    """A registry, a clock and a monitor of each package over the same
    spec: {pkg: (module, registry, clock, monitor)}."""
    out = {}
    for pkg, mod in (("jax", jobs), ("port", obs)):
        reg, clk = mod.MetricsRegistry(), _Clock()
        spec = mod.SLOSpec(objectives=objectives(mod), windows=windows)
        out[pkg] = (mod, reg, clk, mod.SLOMonitor(
            reg, spec, base_labels=base, clock=clk))
    return out


def _verdicts(mon):
    return [(v.objective, v.breaching, v.burn_rates, v.fraction_bad,
             v.value) for v in mon.evaluate()]


def _events(reg):
    return [{k: v for k, v in e.items() if k != "t_unix"}
            for e in reg.events]


# ---------------------------------------------------------------------------
# burn-rate semantics against JAX's
# ---------------------------------------------------------------------------


def test_latency_burn_rate_multi_window_equals_jaxs():
    """Good traffic, one bad second (the long window vetoes), sustained
    badness (breach), silence (recovery): the same verdict at every
    evaluation, the same events and breach counter."""
    p = _pair(lambda m: (m.ttft_target(100.0, target=0.5),),
              base={"sched": "contiguous"})
    hs = {k: reg.histogram("serve_ttft_s", sched="contiguous")
          for k, (_, reg, _, _) in p.items()}
    script = [(1.0, [0.010] * 10)] * 10 + [(1.0, [0.500] * 10)] * 12 + \
        [(11.0, [])]
    seen = []
    for dt, vals in [(0.0, [])] + script:
        got = {}
        for k, (_, reg, clk, mon) in p.items():
            clk.advance(dt)
            for v in vals:
                hs[k].observe(v)
            got[k] = _verdicts(mon)
        assert got["port"] == got["jax"]
        seen.append(got["port"][0][1])
    assert True in seen and seen[-1] is False
    assert _events(p["port"][1]) == _events(p["jax"][1])
    assert [e["event"] for e in _events(p["port"][1])] == \
        ["slo_breach", "slo_recovered"]
    assert p["port"][1].snapshot()["counters"] == \
        p["jax"][1].snapshot()["counters"]


def test_gauge_and_ratio_objectives_equal_jaxs():
    p = _pair(lambda m: (m.queue_depth_max(4, target=0.5),
                         m.kv_free_floor(8, target=0.5),
                         m.accept_floor(0.5)), base={"sched": "paged"})

    def drive(q, free, drafted, accepted, dt=1.0):
        out = {}
        for k, (_, reg, clk, mon) in p.items():
            reg.gauge("serve_queue_depth", sched="paged").set(q)
            reg.gauge("kv_free_blocks").set(free)
            reg.counter("serve_spec_drafted_total").inc(drafted)
            reg.counter("serve_spec_accepted_total").inc(accepted)
            clk.advance(dt)
            out[k] = _verdicts(mon)
        assert out["port"] == out["jax"]
        return {v[0]: v[1] for v in out["port"]}

    for _ in range(5):
        assert not any(drive(2, 32, 20, 16).values())
    for _ in range(12):
        bad = drive(10, 2, 50, 0)
    assert all(bad.values())
    drive(1, 32, 0, 0, dt=11.0)
    for _ in range(3):
        good = drive(1, 32, 50, 50)
    assert not any(good.values())
    assert _events(p["port"][1]) == _events(p["jax"][1])


def test_tenant_scoped_latency_objective_equals_jaxs():
    p = _pair(lambda m: (m.ttft_target(100.0, target=0.5, tenant="good"),),
              windows=((2.0, 1.0),), base={"sched": "paged"})
    for good_v, bad_v in ((0.010, 9.0), (9.0, 9.0)):
        got = {}
        for k, (_, reg, clk, mon) in p.items():
            if not mon._state[mon.spec.objectives[0].name].samples:
                mon.evaluate()
            for _ in range(20):
                reg.histogram("serve_ttft_s", sched="paged",
                              tenant="good").observe(good_v)
                reg.histogram("serve_ttft_s", sched="paged",
                              tenant="bad").observe(bad_v)
            clk.advance(1.0)
            got[k] = _verdicts(mon)
        assert got["port"] == got["jax"]
    assert got["port"][0][1] is True


@pytest.mark.parametrize("case", ["target1", "kind", "accept", "empty",
                                  "windows", "dup"])
def test_objective_and_spec_refusals_equal_jaxs(case):
    def build(m):
        return {
            "target1": lambda: m.ttft_target(250.0, target=1.0),
            "kind": lambda: m.Objective(name="x", kind="latency_p99",
                                        metric="m", threshold=1.0),
            "accept": lambda: m.accept_floor(1.5),
            "empty": lambda: m.SLOSpec(objectives=()),
            "windows": lambda: m.SLOSpec(
                objectives=(m.queue_depth_max(4),),
                windows=((10.0, 1.0), (2.0, 1.0))),
            "dup": lambda: m.SLOSpec(objectives=(m.queue_depth_max(4),
                                                 m.queue_depth_max(4))),
        }[case]

    with pytest.raises(ValueError) as jerr:
        build(jobs)()
    with pytest.raises(ValueError) as perr:
        build(obs)()
    assert str(perr.value) == str(jerr.value)


def test_objective_helpers_name_what_jaxs_name():
    for name, args, kw in (("ttft_target", (250.0,), {}),
                           ("ttft_target", (80.0,), dict(target=0.99,
                                                         tenant="t0")),
                           ("tpot_target", (12.5,), {}),
                           ("queue_depth_max", (64,), {}),
                           ("kv_free_floor", (16,), {}),
                           ("accept_floor", (0.4,), {})):
        got = getattr(obs, name)(*args, **kw)
        want = getattr(jobs, name)(*args, **kw)
        assert vars(got) == vars(want)
    assert obs.slo.DEFAULT_WINDOWS == jobs.slo.DEFAULT_WINDOWS


# ---------------------------------------------------------------------------
# fleet merge
# ---------------------------------------------------------------------------


def _feed(reg, ttfts, tokens, free_blocks):
    reg.counter("serve_tokens_total", sched="paged").inc(tokens)
    h = reg.histogram("serve_ttft_s", sched="paged")
    for v in ttfts:
        h.observe(v)
    reg.gauge("kv_free_blocks").set(free_blocks)
    reg.event("shed", sched="paged")


def test_merge_is_a_combined_run_and_refuses_as_jaxs():
    ra, rb, rc = MetricsRegistry(), MetricsRegistry(), MetricsRegistry()
    a = ([0.004, 0.120, 3.500], 37, 5.0)
    b = ([0.0009, 0.050, 0.050, 7.000], 13, 11.0)
    _feed(ra, *a)
    _feed(rb, *b)
    _feed(rc, a[0] + b[0], a[1] + b[1], 0.0)
    fleet = merge_snapshots([mergeable_snapshot(ra, "r0"),
                             mergeable_snapshot(rb, "r1")])
    combined = mergeable_snapshot(rc, "all")
    assert fleet["counters"] == combined["counters"]
    hk = "serve_ttft_s{sched=paged}"
    for field in ("buckets", "counts", "count", "sum", "min", "max"):
        assert fleet["histograms"][hk][field] == \
            combined["histograms"][hk][field]
    assert fleet["histograms"][hk]["p95"] == \
        merged_histogram(combined["histograms"][hk]).percentile(0.95)
    g = fleet["gauges"]["kv_free_blocks"]
    assert (g["min"], g["max"], g["sum"], g["mean"]) == (5.0, 11.0, 16.0, 8.0)
    assert fleet["events_by_kind"]["shed"] == 2
    sa, sb = mergeable_snapshot(ra, "r0"), mergeable_snapshot(rb, "r1")
    rd = MetricsRegistry()
    rd.histogram("serve_ttft_s", buckets=(1.0, 2.0), sched="paged") \
        .observe(0.5)
    jr = jobs.MetricsRegistry()
    jr.histogram("serve_ttft_s", buckets=(1.0, 2.0), sched="paged") \
        .observe(0.5)
    for bad, jbad in (([], []),
                      ([sa, mergeable_snapshot(rb, "r0")],
                       [sa, jobs.mergeable_snapshot(jobs.MetricsRegistry(),
                                                    "r0")]),
                      ([sa, dict(sb, schema="x")], [sa, dict(sb,
                                                             schema="x")]),
                      ([fleet, sa], [fleet, sa]),
                      ([sa, mergeable_snapshot(rd, "r2")],
                       [sa, jobs.mergeable_snapshot(jr, "r2")])):
        with pytest.raises(ValueError) as perr:
            merge_snapshots(bad)
        with pytest.raises(ValueError) as jerr:
            jobs.merge_snapshots(jbad)
        assert str(perr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the overload ladder, both packages in lockstep
# ---------------------------------------------------------------------------


def _burst(n, max_new):
    rs = np.random.RandomState(7)
    return [dict(prompt=rs.randint(0, 97, size=(6,)), max_new_tokens=max_new,
                 task_id=i % 2) for i in range(n)]


def test_overload_walks_the_ladder_as_jax_and_recovers_token_identical(
        world):  # noqa: F811
    """JAX's acceptance test on both packages, tick by tick on one
    injected clock: the ladder's rungs, each `degrade` event's rung,
    direction, level and tick, the typed shed error's level and
    objectives, the report's shed/deferred/degrade counts and the tokens
    equal JAX's; the tokens equal an unloaded run's; recovery walks back
    to level 0 with spec_k and prefix fill restored."""
    spec = {pkg: mod.SLOSpec(objectives=(mod.queue_depth_max(2, target=0.5),),
                             windows=WINDOWS)
            for pkg, mod in (("jax", jobs), ("port", obs))}
    sched = {
        "jax": jmake_scheduler(world["jeng"], JServingConfig(**OVERLOAD),
                               obs=jobs.MetricsRegistry()),
        "port": make_scheduler(world["peng"], ServingConfig(**OVERLOAD),
                               obs=MetricsRegistry())}
    adm = {"jax": JAdmissionConfig(check_every=1, degrade_after=1,
                                   recover_after=2),
           "port": AdmissionConfig(check_every=1, degrade_after=1,
                                   recover_after=2)}
    clk = {k: _Clock() for k in sched}
    mon = {k: s.attach_slo(spec[k], admission=adm[k], clock=clk[k])
           for k, s in sched.items()}
    ctrl = {k: s._admission for k, s in sched.items()}
    assert isinstance(ctrl["port"], AdmissionController)
    assert ctrl["port"].rung_names() == ctrl["jax"].rung_names() == [
        "prefix_fill_stop", "spec_k=1", "spec_k=0", "defer", "shed"]
    req = {"jax": JRequest, "port": Request}
    ids = {k: [s.submit(req[k](**t)) for t in _burst(12, 6)]
           for k, s in sched.items()}
    degrade = {k: [] for k in sched}
    shed_err = {}
    ticks = 0

    def tick():
        for k, s in sched.items():
            n = len(s.obs.events_of("degrade"))
            clk[k].advance(1.0)
            s.step()
            degrade[k] += [(e["rung"], e["direction"], e["level"], ticks)
                           for e in s.obs.events_of("degrade")[n:]]

    while any(s.pending or s.active for s in sched.values()):
        ticks += 1
        assert ticks < 400
        tick()
        assert degrade["port"] == degrade["jax"]
        assert ctrl["port"].level == ctrl["jax"].level
        if ctrl["port"].shedding and not shed_err:
            for k, err in (("jax", JAdmissionShedError),
                           ("port", AdmissionShedError)):
                with pytest.raises(err) as ei:
                    sched[k].submit(req[k](prompt=np.arange(4),
                                           max_new_tokens=2))
                shed_err[k] = (ei.value.level, ei.value.objectives,
                               str(ei.value))
        assert ctrl["port"].shedding == ctrl["jax"].shedding
    assert shed_err["port"] == shed_err["jax"]
    assert shed_err["port"][:2] == (5, ("queue_le_2",))
    down = [r for r, d, _, _ in degrade["port"] if d == "down"]
    assert down[:5] == ctrl["port"].rung_names()
    rep = {k: s.report(elapsed_s=1.0) for k, s in sched.items()}
    for key in ("shed", "deferred_ticks", "degrade_steps", "degrade_level"):
        assert rep["port"][key] == rep["jax"][key], key
    assert rep["port"]["shed"] == 1 and rep["port"]["deferred_ticks"] >= 1
    for _ in range(20):
        ticks += 1
        for k in sched:
            clk[k].advance(11.0 if _ == 0 else 0.0)
        tick()
    assert degrade["port"] == degrade["jax"]
    assert ctrl["port"].level == 0 and not ctrl["port"].deferring
    assert sched["port"].spec_k_eff == sched["port"].spec_k == 2
    assert sched["port"]._prefix_fill is True and not mon["port"].breaching
    assert [e["rung"] for e in sched["port"].obs.events_of("degrade")
            if e["direction"] == "up"].count("prefix_fill_stop") >= 1
    for kind in ("spec_depth", "prefix_fill", "slo_breach", "slo_recovered",
                 "shed"):
        assert len(sched["port"].obs.events_of(kind)) == \
            len(sched["jax"].obs.events_of(kind)), kind
    done = {k: [s.completions.pop(i) for i in ids[k]]
            for k, s in sched.items()}
    unloaded, _ = make_scheduler(world["peng"], ServingConfig(
        **OVERLOAD)).run([Request(**t) for t in _burst(12, 6)])
    for p, j, u in zip(done["port"], done["jax"], unloaded):
        assert p.finish_reason == j.finish_reason == u.finish_reason
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens))
        np.testing.assert_array_equal(p.tokens, u.tokens)
    assert sched["port"].obs.events_of("retrace") == []


def test_monitor_only_attach_observes_without_acting(world):  # noqa: F811
    reg = MetricsRegistry()
    sched = make_scheduler(world["peng"], ServingConfig(num_slots=1,
                                                        max_len=32), obs=reg)
    clk = _Clock()
    sched.attach_slo(SLOSpec(objectives=(queue_depth_max(0, target=0.5),),
                             windows=((1.0, 1.0), (2.0, 1.0))),
                     check_every=1, clock=clk)
    assert sched._admission is None
    ids = [sched.submit(Request(**t)) for t in _burst(4, 3)]
    while sched.pending or sched.active:
        clk.advance(1.0)
        sched.step()
    assert reg.events_of("slo_breach")
    assert not reg.events_of("degrade") and not reg.events_of("shed")
    rep = sched.report(elapsed_s=1.0)
    assert rep["shed"] == 0 and rep["degrade_level"] == 0
    assert len([sched.completions.pop(i) for i in ids]) == 4


@pytest.mark.parametrize("kw,rungs", [
    (dict(), ["defer", "shed"]),
    (dict(paged=True, page_size=8), ["prefix_fill_stop", "defer", "shed"]),
    (dict(spec_k=4), ["spec_k=2", "spec_k=1", "spec_k=0", "defer", "shed"]),
    (dict(paged=True, page_size=8, spec_k=4, prefix_cache=False),
     ["spec_k=2", "spec_k=1", "spec_k=0", "defer", "shed"]),
])
def test_serving_config_wires_the_ladder_as_jax(world, kw, rungs):  # noqa
    """make_scheduler attaches the monitor and a ladder built from what
    the scheduler can do, rung for rung JAX's; spec_floor and the
    terminal switches trim it alike."""
    kw = dict(num_slots=2, max_len=32, **kw)
    sched = make_scheduler(world["peng"], ServingConfig(
        **kw, slo=SLOSpec(objectives=(queue_depth_max(64),)),
        admission=AdmissionConfig()), obs=MetricsRegistry())
    jsched = jmake_scheduler(world["jeng"], JServingConfig(
        **kw, slo=jobs.SLOSpec(objectives=(jobs.queue_depth_max(64),)),
        admission=JAdmissionConfig()), obs=jobs.MetricsRegistry())
    assert sched._slo_monitor is not None
    assert sched._admission.rung_names() == \
        jsched._admission.rung_names() == rungs
    if "spec_k" in kw:
        for floor, shed in ((1, False), (3, True)):
            got = AdmissionController(sched, sched._slo_monitor,
                                      AdmissionConfig(spec_floor=floor,
                                                      shed=shed))
            from repro.serving.admission import AdmissionController as JAC
            want = JAC(jsched, jsched._slo_monitor,
                       JAdmissionConfig(spec_floor=floor, shed=shed))
            assert got.rung_names() == want.rung_names()


@pytest.mark.parametrize("kw", [dict(check_every=0), dict(degrade_after=0),
                                dict(recover_after=0), dict(spec_floor=-1)])
def test_admission_config_refuses_what_jaxs_refuses(kw):
    with pytest.raises(ValueError) as jerr:
        JAdmissionConfig(**kw)
    with pytest.raises(ValueError) as perr:
        AdmissionConfig(**kw)
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="needs objectives"):
        ServingConfig(admission=AdmissionConfig())


# ---------------------------------------------------------------------------
# the regression gate's command line
# ---------------------------------------------------------------------------


def _payload(us):
    return {"schema": "repro-bench-v2", "git_sha": "cafe",
            "created_unix": 1.7e9, "created_utc": "2026-08-08T00:00:00",
            "backend": "cpu", "fast": True, "failures": [],
            "suites": {"kernels": [{"name": "decode", "us_per_call": us,
                                    "derived": ""}]}}


def test_regress_cli_exit_codes(tmp_path):
    """`python -m repro_torch.obs.regress`: zero on the seeding run (which
    it appends), non-zero once a metric degrades past the tolerance."""
    hist = str(tmp_path / "BENCH_history.jsonl")
    cur = tmp_path / "current.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmd = [sys.executable, "-m", "repro_torch.obs.regress",
           "--history", hist, "--current", str(cur)]
    cur.write_text(json.dumps(_payload(100.0)))
    r = subprocess.run(cmd + ["--append"], capture_output=True, text=True,
                       cwd=ROOT / "src", env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "no regressions" in r.stdout and "appended run" in r.stdout
    cur.write_text(json.dumps(_payload(1000.0)))
    r = subprocess.run(cmd, capture_output=True, text=True,
                       cwd=ROOT / "src", env=env, timeout=120)
    assert r.returncode == 1
    assert "REGRESSION kernels:decode" in r.stdout
