"""Continuous-batching scheduler over a slot-based KV cache (port of
`repro.serving.scheduler`).

  * The scheduler owns `num_slots` cache slots: rows of one pooled decode
    cache of length `max_len` (`engine.init_slot_caches`); an RWKV6
    layer's row is its recurrent state, of no length.
  * Admission is prefill-on-admit: a queued request is prefilled alone
    (B=1, cache_len=max_len) and its fresh cache row is copied into the
    free slot's row, mid-decode, without touching other slots.
  * Every tick runs ONE decode step across all slots with per-slot
    positions; each row attends over its own valid prefix. Slots of a
    MultiTaskEngine pass their task ids, so different tasks share a tick.
  * A slot retires the moment its request finishes (EOS or budget) and is
    reusable at once; a free row still flows through the step, its logits
    are ignored and its cache row is overwritten at the next admission.
  * A request may name its adapter (`Request.adapter`) instead of a bank
    row: a hot-swap engine resolves the name at admission, loading the
    tenant into its `AdapterBank` on a miss, and keeps the row pinned
    until the request retires. With every row pinned the admission waits
    for a retirement (the queue keeps its order); a tenant removed between
    submit and admission gives its request an 'error' completion.

Greedy decoding gives the tokens `ServeEngine.generate` gives for the
same prompts: every per-row op is independent of the batch.

Every scheduler reports into a `repro_torch.obs.MetricsRegistry` (its
own, or the one passed as `obs`) with JAX's series and labels
(`sched=contiguous|paged|spec|spec_paged`), traces each request's
lifecycle, and can carry an SLO monitor and the admission ladder
(`attach_slo`), which act between ticks on host-side state only.
"""
from __future__ import annotations

import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry
from repro_torch.obs.slo import SLOMonitor, SLOSpec
from repro_torch.serving.admission import (AdmissionConfig,
                                           AdmissionController,
                                           AdmissionShedError)
from repro_torch.serving.engine import check_temperature, sample_topk
from repro_torch.serving.registry import BankFullError


@dataclass
class Request:
    """One generation request with its own budget, sampling and adapter:
    a static bank row (`task_id`) or, for a hot-swap engine, an adapter
    name resolved to a row at admission (`adapter`)."""

    prompt: np.ndarray  # (S,) int prompt tokens
    max_new_tokens: int
    top_k: int = 0  # 0 -> greedy
    temperature: float = 1.0
    seed: Optional[int] = None  # generator seed for top-k sampling
    task_id: int = 0  # adapter-bank row (MultiTaskEngine)
    eos_id: Optional[int] = None  # stop early on this token
    adapter: Optional[str] = None  # adapter name (hot-swap MultiTaskEngine)


@dataclass
class Completion:
    request_id: int
    tokens: np.ndarray  # generated tokens (includes the EOS token, if any)
    prompt_len: int
    task_id: int  # bank row the request ran under (resolved, for named)
    finish_reason: str  # 'eos' | 'length' | 'error' (adapter vanished)
    ttft_s: float  # submit -> first token (includes queueing)
    latency_s: float  # submit -> finished
    adapter: Optional[str] = None


@dataclass
class _Slot:
    request_id: int
    req: Request
    generator: Optional[torch.Generator]
    submit_t: float
    tokens: List[int] = field(default_factory=list)
    pos: int = 0  # absolute position of the next decode write
    row: int = 0  # resolved adapter-bank row (pinned while in flight)
    first_tok_t: float = 0.0
    trace: object = None  # RequestTrace (null when tracing is off)


class Scheduler:
    """Continuous batching around a ServeEngine or MultiTaskEngine.

    prefill_bucket: right-pad prompts to a multiple of this before prefill;
    token-exact only for full-attention configs, and refused for others
    (`supports_bucketing`).

    stream: an optional callback `(request_id, token)`, called for every
    token the moment it is sampled.

    obs: the MetricsRegistry to report into (None: a private one, as
    `sched.obs`)."""

    _sched_kind = "contiguous"  # `sched=` label on every metric series
    # engine calls that must never compile again once serving started, in
    # an engine that keeps a `trace_counts` dict (JAX's jitted engines do;
    # the port's run eagerly and keep none, so the watch stays empty)
    _RETRACE_KEYS = ("decode", "decode_paged", "verify", "verify_paged",
                     "draft")

    def __init__(self, engine, *, num_slots: int, max_len: int,
                 stream: Optional[Callable[[int, int], None]] = None,
                 prefill_bucket: Optional[int] = None,
                 obs: Optional[MetricsRegistry] = None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if prefill_bucket is not None and not self.supports_bucketing(
                engine.cfg):
            raise ValueError(
                "prefill_bucket requires full-attention slots (windowed "
                "ring caches and recurrent/rwkv state would fold the pad "
                "tokens in)")
        self._init_slots(engine, num_slots, max_len, prefill_bucket, stream)
        self._init_obs(obs)
        self.caches = engine.init_slot_caches(num_slots, max_len)

    def _init_slots(self, engine, num_slots: int, max_len: int,
                    prefill_bucket: Optional[int],
                    stream: Optional[Callable[[int, int], None]]) -> None:
        """The request bookkeeping every scheduler keeps, whatever holds
        its KV."""
        self.engine = engine
        self.num_slots = num_slots
        self.max_len = max_len
        self.stream = stream
        self.prefill_bucket = prefill_bucket
        self.slots: List[Optional[_Slot]] = [None] * num_slots
        self.queue: deque = deque()
        self.completions: Dict[int, Completion] = {}
        self._next_id = 0
        self._ticks = 0
        # host seconds in prefill (admissions) and in decode ticks, each
        # ending in a device sync when the sampled tokens are read back
        self._prefill_s = 0.0
        self._decode_s = 0.0
        # per-slot vectors fed to the decode step every tick
        self._tok = np.zeros((num_slots,), np.int64)
        self._pos = np.zeros((num_slots,), np.int64)
        self._task = np.zeros((num_slots,), np.int64)

    # -- observability ------------------------------------------------------

    def _init_obs(self, obs: Optional[MetricsRegistry]) -> None:
        """This scheduler's instruments on `obs` (or a private registry),
        JAX's series and labels."""
        self.obs = obs if obs is not None else MetricsRegistry()
        kind = self._sched_kind
        self._m_submitted = self.obs.counter(
            "serve_requests_submitted_total", sched=kind)
        self._m_tokens = self.obs.counter("serve_tokens_total", sched=kind)
        self._m_ticks = self.obs.counter("serve_ticks_total", sched=kind)
        self._m_tick_s = self.obs.histogram("serve_tick_s", sched=kind)
        self._m_queue_s = self.obs.histogram("serve_queue_wait_s", sched=kind)
        self._m_ttft = self.obs.histogram("serve_ttft_s", sched=kind)
        self._m_tpot = self.obs.histogram("serve_tpot_s", sched=kind)
        self._m_latency = self.obs.histogram("serve_latency_s", sched=kind)
        self._m_retrace = self.obs.counter(
            "serve_retrace_events_total", sched=kind)
        # the admission instruments exist (at zero) without a controller,
        # so report()'s keys are the same either way
        self._m_shed = self.obs.counter(
            "serve_admission_shed_total", sched=kind)
        self._m_deferred = self.obs.counter(
            "serve_admission_deferred_ticks_total", sched=kind)
        self._m_degrade_down = self.obs.counter(
            "serve_degrade_steps_total", sched=kind, direction="down")
        self._g_degrade_level = self.obs.gauge(
            "serve_degrade_level", sched=kind)
        self._g_queue_depth = self.obs.gauge("serve_queue_depth", sched=kind)
        self._slo_monitor: Optional[SLOMonitor] = None
        self._admission: Optional[AdmissionController] = None
        self._slo_check_every = 4
        self._pre_ticks = 0
        # the retrace watch: each watched call's compile count at start
        self._trace_watch: List[tuple] = []
        self._trace_allow: Dict[tuple, int] = {}
        tc = getattr(self.engine, "trace_counts", None)
        if tc is not None:
            self._watch_traces("engine", tc)
        bank = getattr(self.engine, "adapter_bank", None)
        if bank is not None:
            bank.bind_obs(self.obs)

    def _watch_traces(self, src: str, trace_counts: dict) -> None:
        """Watch a trace-count dict for compiles mid-serve. The allowance
        is the current count + 1: a call's first compile (possibly in this
        serve) is legitimate, anything beyond it is a retrace."""
        self._trace_watch.append((src, trace_counts))
        for k in self._RETRACE_KEYS:
            if k in trace_counts:
                self._trace_allow[(src, k)] = trace_counts.get(k, 0) + 1

    def _check_retraces(self) -> None:
        for src, tc in self._trace_watch:
            for k in self._RETRACE_KEYS:
                allow = self._trace_allow.get((src, k))
                if allow is None:
                    continue
                n = tc.get(k, 0)
                if n > allow:
                    extra = n - allow
                    self._m_retrace.inc(extra)
                    self.obs.event("retrace", source=src, fn=k, count=extra,
                                   message="recompiled mid-serve")
                    print(f"[repro.obs] WARNING: {src}.{k} recompiled "
                          f"mid-serve (x{extra}) - shapes are leaking into "
                          "the steady-state serving path", file=sys.stderr)
                    self._trace_allow[(src, k)] = n

    def _pre_tick(self) -> None:
        """Once per `step()`, before admissions, idle ticks included: what
        lets an attached controller see recovery and step back up while
        traffic pauses."""
        self._g_queue_depth.set(len(self.queue))
        self._pre_ticks += 1
        if self._admission is not None:
            self._admission.on_step(self)
        elif (self._slo_monitor is not None
                and self._pre_ticks % self._slo_check_every == 0):
            self._slo_monitor.evaluate()

    def _post_tick(self, t0: float) -> None:
        """After a tick that decoded: its host seconds from t0 (the tick's
        admissions included), the tick count, the retrace watch."""
        self._m_tick_s.observe(time.perf_counter() - t0)
        self._m_ticks.inc()
        self._check_retraces()

    def attach_slo(self, spec: SLOSpec, *,
                   admission: Optional[AdmissionConfig] = None,
                   check_every: int = 4,
                   clock: Optional[Callable[[], float]] = None) -> SLOMonitor:
        """Evaluate `spec` over this scheduler's metrics every
        `check_every` ticks, breaches landing as registry events; with an
        `AdmissionConfig`, the degradation ladder
        (`repro_torch.serving.admission`) acts on them at its own
        check_every. `clock` injects a time source for deterministic
        windows. `make_scheduler` wires this from `ServingConfig(slo=,
        admission=)`."""
        kwargs = {"base_labels": {"sched": self._sched_kind}}
        if clock is not None:
            kwargs["clock"] = clock
        self._slo_monitor = SLOMonitor(self.obs, spec, **kwargs)
        self._slo_check_every = check_every
        if admission is not None:
            self._admission = AdmissionController(
                self, self._slo_monitor, admission)
        return self._slo_monitor

    @staticmethod
    def _tenant(st: _Slot) -> str:
        return st.req.adapter if st.req.adapter is not None else \
            f"task{st.row}"

    @staticmethod
    def supports_bucketing(cfg) -> bool:
        """Whether right-padding prompts is token-exact for this config,
        JAX's predicate: every layer attention with a full-range cache,
        where the pad is causally invisible at prefill and decode
        overwrites each position before its row's kv_len reaches it. A
        ring cache folds the pad into its layout; a recurrent state takes
        it in."""
        return all(s.kind == "attn" and s.window is None
                   for s in cfg.layer_slots())

    # -- request lifecycle --------------------------------------------------

    def submit(self, req: Request) -> int:
        """Queue a request; returns its id. It is admitted on the next tick
        with a free slot. A named adapter is checked here (the engine takes
        names, and the name is bank-resident or published) so the queue
        never holds a request that can never be admitted.

        Raises `AdmissionShedError` while an attached controller sheds:
        the front door closes before any validation, and the typed error
        says backpressure (retry later, reroute), not a caller's error."""
        if self._admission is not None and self._admission.shedding:
            objectives = self._admission.breaching_objectives
            self._m_shed.inc()
            self.obs.event("shed", sched=self._sched_kind,
                           level=self._admission.level,
                           objectives=list(objectives))
            raise AdmissionShedError(
                f"admissions shed at degrade level {self._admission.level}"
                f" (breaching: {', '.join(objectives) or 'recovering'})",
                level=self._admission.level, objectives=objectives)
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        check_temperature(req.temperature)
        S = int(np.asarray(req.prompt).shape[-1])
        if S < 1:
            raise ValueError("empty prompt")
        if S + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt_len {S} + max_new_tokens {req.max_new_tokens} "
                f"exceeds slot cache length {self.max_len}")
        if req.adapter is not None:
            if getattr(self.engine, "adapter_bank", None) is None:
                raise ValueError(
                    "request names an adapter but the engine has no "
                    "AdapterBank (hot-swap MultiTaskEngine required)")
            if not self.engine.has_adapter(req.adapter):
                raise KeyError(
                    f"adapter {req.adapter!r} is neither bank-resident nor "
                    "published in the registry")
        rid = self._next_id
        self._next_id += 1
        self._m_submitted.inc()
        self.obs.tracer.start(rid).mark("submit", prompt_len=S)
        self.queue.append((rid, req, time.perf_counter()))
        return rid

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def pending(self) -> int:
        return len(self.queue)

    def _sample_one(self, logits_row: torch.Tensor, st: _Slot) -> int:
        """One request's token from its (1, 1, V) logits."""
        if st.req.top_k and st.generator is not None:
            return int(sample_topk(logits_row, st.generator, k=st.req.top_k,
                                   temperature=st.req.temperature)[0])
        return int(logits_row[0, -1].argmax())

    def _generator(self, req: Request, rid: int) -> Optional[torch.Generator]:
        """A top-k request's sampling generator on the engine's device,
        seeded by its seed (else its id); None for a greedy one."""
        if not req.top_k:
            return None
        return torch.Generator(device=self.engine.device).manual_seed(
            req.seed if req.seed is not None else rid)

    def _emit(self, slot_idx: int, st: _Slot, tok: int) -> bool:
        """Record one token; True when the request is done."""
        if not st.tokens:
            st.first_tok_t = time.perf_counter()
            st.trace.mark("first_token")
        st.trace.mark("token")
        self._m_tokens.inc()
        st.tokens.append(tok)
        if self.stream is not None:
            self.stream(st.request_id, tok)
        if st.req.eos_id is not None and tok == st.req.eos_id:
            self._retire(slot_idx, st, "eos")
            return True
        if len(st.tokens) >= st.req.max_new_tokens:
            self._retire(slot_idx, st, "length")
            return True
        return False

    def _retire(self, slot_idx: int, st: _Slot, reason: str) -> None:
        now = time.perf_counter()
        ttft = st.first_tok_t - st.submit_t
        latency = now - st.submit_t
        n_tok = len(st.tokens)
        self.completions[st.request_id] = Completion(
            request_id=st.request_id,
            tokens=np.asarray(st.tokens, np.int64),
            prompt_len=int(np.asarray(st.req.prompt).shape[-1]),
            task_id=st.row,
            finish_reason=reason,
            ttft_s=ttft,
            latency_s=latency,
            adapter=st.req.adapter,
        )
        kind, tenant = self._sched_kind, self._tenant(st)
        self.obs.counter("serve_requests_completed_total", sched=kind,
                         reason=reason).inc()
        self._m_ttft.observe(ttft)
        self.obs.histogram("serve_ttft_s", sched=kind,
                           tenant=tenant).observe(ttft)
        self._m_latency.observe(latency)
        if n_tok > 1:
            tpot = (latency - ttft) / (n_tok - 1)
            self._m_tpot.observe(tpot)
            self.obs.histogram("serve_tpot_s", sched=kind,
                               tenant=tenant).observe(tpot)
        st.trace.mark("retire", reason=reason, tokens=n_tok)
        self.obs.tracer.finish(st.request_id)
        if st.req.adapter is not None:
            self.engine.release_adapter(st.req.adapter)  # unpin its row
        self.slots[slot_idx] = None

    # admission failures that defer the queue to a later tick instead of
    # failing the request (the paged scheduler adds BlockPoolFullError)
    _defer_errors = (BankFullError,)

    def _admit_one(self, slot_idx: int, rid: int, req: Request,
                   submit_t: float) -> None:
        """Admit one request. Raises BankFullError (before any state is
        touched) when it names an adapter and every bank row is pinned,
        and KeyError when its adapter is no longer published."""
        t0 = time.perf_counter()
        row = req.task_id
        if req.adapter is not None:
            row = self.engine.acquire_adapter(req.adapter)  # pins the row
        tr = self.obs.tracer.get(rid)
        queue_s = time.perf_counter() - submit_t
        self._m_queue_s.observe(queue_s)
        tr.mark("admit", slot=slot_idx, row=row, adapter=req.adapter,
                queue_s=queue_s)
        prompt = np.asarray(req.prompt, np.int64).reshape(1, -1)
        S = prompt.shape[1]
        last_pos = None
        if self.prefill_bucket is not None:
            padded = min(self.max_len,
                         -(-S // self.prefill_bucket) * self.prefill_bucket)
            if padded > S:
                prompt = np.pad(prompt, ((0, 0), (0, padded - S)))
            last_pos = S - 1
        logits, fresh = self.engine.prefill(
            prompt, self.max_len, task_ids=np.asarray([row]),
            last_pos=last_pos)
        tr.mark("prefill", kind="cold", prompt_len=S)
        for pool, new in zip(self.caches, fresh):
            for name, leaf in pool.items():  # k, v; or S, tm_prev, cm_prev
                leaf[slot_idx].copy_(new[name][0])
        st = _Slot(request_id=rid, req=req,
                   generator=self._generator(req, rid), submit_t=submit_t,
                   pos=S, row=row, trace=tr)
        self.slots[slot_idx] = st
        self._task[slot_idx] = row
        tok = self._sample_one(logits, st)
        self._prefill_s += time.perf_counter() - t0
        if not self._emit(slot_idx, st, tok):
            self._tok[slot_idx] = tok
            self._pos[slot_idx] = st.pos

    def _do_admissions(self) -> None:
        """Admit queued requests into free slots; a request that finishes
        at its first token frees its slot again at once."""
        if (self._admission is not None and self._admission.deferring
                and self.queue and self.active):
            # degraded: the queue waits while in-flight work drains. With
            # nothing in flight nothing can retire to bring recovery, so
            # an empty scheduler always admits (run() cannot hang)
            self._m_deferred.inc()
            return
        free = [i for i, s in enumerate(self.slots) if s is None]
        while free and self.queue:
            idx = free.pop()
            rid, req, submit_t = self.queue.popleft()
            try:
                self._admit_one(idx, rid, req, submit_t)
            except KeyError:
                # the adapter was removed after submit: this request fails,
                # the stream goes on
                self.completions[rid] = Completion(
                    request_id=rid, tokens=np.zeros((0,), np.int64),
                    prompt_len=int(np.asarray(req.prompt).shape[-1]),
                    task_id=-1, finish_reason="error", ttft_s=0.0,
                    latency_s=time.perf_counter() - submit_t,
                    adapter=req.adapter)
                self.obs.counter("serve_requests_completed_total",
                                 sched=self._sched_kind, reason="error").inc()
                self.obs.tracer.get(rid).mark("retire", reason="error",
                                              tokens=0)
                self.obs.tracer.finish(rid)
                free.append(idx)
                continue
            except self._defer_errors:
                # a shared resource (bank rows, pool blocks) is held by
                # requests in flight: wait for one to retire, keeping the
                # queue's order (skipping ahead would starve the blocked
                # request)
                self.obs.tracer.get(rid).mark("defer")
                self.queue.appendleft((rid, req, submit_t))
                break
            if self.slots[idx] is None:
                free.append(idx)

    # -- the tick -----------------------------------------------------------

    def step(self) -> int:
        """One tick: the pre-tick hooks (queue gauge, SLO and admission
        evaluation), admissions into free slots, then one decode step
        across all slots. Returns the number of tokens generated."""
        self._pre_tick()
        return self._step_impl()

    def _step_impl(self) -> int:
        """The tick without its pre-tick hooks, which a speculative
        scheduler stepped down to spec_k 0 runs as its own."""
        t0 = time.perf_counter()
        self._do_admissions()
        occupied = [i for i, s in enumerate(self.slots) if s is not None]
        if not occupied:
            return 0
        t_dec = time.perf_counter()
        logits = self._decode_tick(occupied)
        self._ticks += 1
        greedy = logits[:, -1].argmax(dim=-1).cpu().numpy()
        self._decode_s += time.perf_counter() - t_dec
        for i in occupied:
            st = self.slots[i]
            st.pos += 1
            if st.req.top_k and st.generator is not None:
                tok = self._sample_one(logits[i:i + 1], st)
            else:
                tok = int(greedy[i])
            if not self._emit(i, st, tok):
                self._tok[i] = tok
                self._pos[i] = st.pos
        self._post_tick(t0)
        return len(occupied)

    def _decode_tick(self, occupied: List[int]) -> torch.Tensor:
        """One decode step across every slot (B, 1) -> its logits (B, 1,
        V); the slot caches are written in place."""
        logits, self.caches = self.engine.decode_step(
            self.caches, self._tok[:, None], self._pos,
            task_ids=self._task.copy())
        return logits

    # -- batch driver -------------------------------------------------------

    def run(self, requests: List[Request],
            on_tick: Optional[Callable[[], Optional[List[int]]]] = None):
        """Submit `requests`, tick until drained; returns (completions in
        submit order, report). `on_tick()`, when given, runs after every
        tick and returns the ids of any requests it submitted, which join
        the run."""
        t0 = time.perf_counter()
        ticks0, pre0, dec0 = self._ticks, self._prefill_s, self._decode_s
        ids = [self.submit(r) for r in requests]
        while self.queue or self.active:
            self.step()
            if on_tick is not None:
                ids += on_tick() or []
        elapsed = time.perf_counter() - t0
        done = [self.completions.pop(i) for i in ids]
        return done, self.report(done, elapsed, ticks=self._ticks - ticks0,
                                 prefill_s=self._prefill_s - pre0,
                                 decode_s=self._decode_s - dec0)

    def report(self, done=(), elapsed_s: float = 0.0,
               ticks: Optional[int] = None, prefill_s: Optional[float] = None,
               decode_s: Optional[float] = None) -> dict:
        """JAX's report: counts and means over `done` (this call's
        completions), timed on the host clock around work that ends in a
        device sync (every tick reads its tokens back); the p50/p95/p99
        TTFT (queueing included) and token gap (a request's mean gap
        between output tokens) come from this scheduler's histograms, so
        they cover every request retired since construction; the
        admission ladder's activity since construction (all zero without
        a controller). Beside JAX's keys, prefill_s/decode_s split the
        host time between admissions and decode ticks (default: since
        construction)."""
        done = list(done)
        n_tok = sum(len(c.tokens) for c in done)
        return {
            "requests": len(done),
            "tokens": n_tok,
            "elapsed_s": elapsed_s,
            "ticks": self._ticks if ticks is None else ticks,
            "requests_per_s": len(done) / elapsed_s if elapsed_s else 0.0,
            "tokens_per_s": n_tok / elapsed_s if elapsed_s else 0.0,
            "mean_ttft_s": (sum(c.ttft_s for c in done) / len(done)
                            if done else 0.0),
            "mean_latency_s": (sum(c.latency_s for c in done) / len(done)
                               if done else 0.0),
            "ttft_p50_s": self._m_ttft.percentile(0.50),
            "ttft_p95_s": self._m_ttft.percentile(0.95),
            "ttft_p99_s": self._m_ttft.percentile(0.99),
            "tpot_p50_s": self._m_tpot.percentile(0.50),
            "tpot_p95_s": self._m_tpot.percentile(0.95),
            "tpot_p99_s": self._m_tpot.percentile(0.99),
            "shed": self._m_shed.value,
            "deferred_ticks": self._m_deferred.value,
            "degrade_steps": self._m_degrade_down.value,
            "degrade_level": (self._admission.level
                              if self._admission is not None else 0),
            "prefill_s": self._prefill_s if prefill_s is None else prefill_s,
            "decode_s": self._decode_s if decode_s is None else decode_s,
        }


def format_report(report: dict) -> str:
    return "\n".join(f"  {k:<16} {v:.4f}" if isinstance(v, float)
                     else f"  {k:<16} {v}" for k, v in report.items())
