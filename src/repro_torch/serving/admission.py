"""Metrics-driven admission control: a degradation ladder with hysteresis
(port of `repro.serving.admission`, standard library only, line for line
JAX's behaviour).

The SLO monitor (`repro_torch.obs.slo`) says *that* the scheduler is
burning its error budget; this module decides *what to give up*, in a
fixed order that never touches in-flight requests:

  1. ``prefix_fill_stop`` - stop publishing retired prompts into the
     prefix cache (hits still serve; the pool stops spending blocks on
     speculative reuse). Paged schedulers only.
  2. ``spec_k=n`` rungs - halve the effective speculation depth, down to
     the configured floor. The draft and the verify keep the static k+1
     shapes; a lowered ``spec_k_eff`` only caps how many drafts
     acceptance may take, and ``spec_k_eff=0`` routes the whole tick
     through plain decode. Greedy output stays token-identical at every
     rung.
  3. ``defer`` - stop admitting queued requests while anything is in
     flight (they wait, FIFO order kept; nothing is dropped).
  4. ``shed`` - reject NEW submissions with a typed `AdmissionShedError`,
     the only rung that refuses work.

Escalation needs `degrade_after` consecutive breaching evaluations, and
each step resets the streak (one step, then observe again); recovery
needs `recover_after` consecutive healthy evaluations per rung stepped
back up. The asymmetry is the hysteresis: flapping between rungs would
thrash the prefix cache and the draft lane for nothing.

Every transition is observable: ``serve_degrade_steps_total{direction=}``
counters, a ``serve_degrade_level`` gauge, ``degrade``/``shed`` registry
events, and shed/defer counters that `Scheduler.report` surfaces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from repro_torch.obs.slo import SLOMonitor


class AdmissionShedError(RuntimeError):
    """submit() rejected: the scheduler is shedding load to protect its
    SLOs. Typed so callers can distinguish backpressure (retry later,
    route to another replica) from caller error (never retry)."""

    def __init__(self, message: str, *, level: int = 0,
                 objectives: Tuple[str, ...] = ()):
        super().__init__(message)
        self.level = level
        self.objectives = objectives


@dataclass(frozen=True)
class AdmissionConfig:
    """Ladder policy knobs.

    check_every: evaluate the SLO monitor every N scheduler ticks (every
        tick is accurate but resamples gauges N times faster than they
        change; 4 amortizes the host-side walk).
    degrade_after: consecutive breaching evaluations required per step
        down; each step resets the streak (cooldown between rungs).
    recover_after: consecutive healthy evaluations per step back up -
        larger than degrade_after by default, recovery should be shy.
    spec_floor: lowest spec_k rung the ladder may reach (0 = plain
        decode). Floors above 0 keep some speculation under overload.
    defer / shed: include those terminal rungs. Shedding without defer
        is allowed (reject new, drain the queue); neither means the
        ladder only degrades quality-of-service knobs.
    """

    check_every: int = 4
    degrade_after: int = 2
    recover_after: int = 4
    spec_floor: int = 0
    defer: bool = True
    shed: bool = True

    def __post_init__(self):
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if self.degrade_after < 1 or self.recover_after < 1:
            raise ValueError("degrade_after/recover_after must be >= 1")
        if self.spec_floor < 0:
            raise ValueError("spec_floor must be >= 0")


class _Rung:
    __slots__ = ("name", "apply", "revert")

    def __init__(self, name: str, apply: Callable[[], None],
                 revert: Callable[[], None]):
        self.name = name
        self.apply = apply
        self.revert = revert


class AdmissionController:
    """Owns the ladder state for one scheduler.

    Built by `Scheduler.attach_slo` from the scheduler's actual
    capabilities: a contiguous scheduler gets no prefix rung, a
    non-speculative one no spec rungs. The controller never calls into
    device code - every rung flips host-side scheduler state.
    """

    def __init__(self, sched, monitor: SLOMonitor, config: AdmissionConfig):
        self.monitor = monitor
        self.config = config
        self._sched = sched
        self.level = 0
        self._breach_streak = 0
        self._healthy_streak = 0
        self._deferring = False
        self._shedding = False
        self._ticks = 0
        obs, kind = sched.obs, sched._sched_kind
        self._c_down = obs.counter("serve_degrade_steps_total", sched=kind,
                                   direction="down")
        self._c_up = obs.counter("serve_degrade_steps_total", sched=kind,
                                 direction="up")
        self._g_level = obs.gauge("serve_degrade_level", sched=kind)
        self._ladder = self._build_ladder(sched, config)

    def _build_ladder(self, sched, cfg: AdmissionConfig) -> List[_Rung]:
        rungs: List[_Rung] = []
        if getattr(sched, "prefix", None) is not None:
            rungs.append(_Rung("prefix_fill_stop",
                               lambda: sched.set_prefix_fill(False),
                               lambda: sched.set_prefix_fill(True)))
        spec_k = getattr(sched, "spec_k", None)
        if spec_k is not None:
            ks: List[int] = []
            k = spec_k // 2
            while k > cfg.spec_floor:
                ks.append(k)
                k //= 2
            if cfg.spec_floor < spec_k:
                ks.append(cfg.spec_floor)
            prev = [spec_k] + ks[:-1]
            for k_to, k_from in zip(ks, prev):
                rungs.append(_Rung(
                    f"spec_k={k_to}",
                    lambda k=k_to: sched.set_spec_k(k),
                    lambda k=k_from: sched.set_spec_k(k)))
        if cfg.defer:
            rungs.append(_Rung("defer",
                               lambda: self._set_defer(True),
                               lambda: self._set_defer(False)))
        if cfg.shed:
            rungs.append(_Rung("shed",
                               lambda: self._set_shed(True),
                               lambda: self._set_shed(False)))
        return rungs

    def _set_defer(self, on: bool) -> None:
        self._deferring = on

    def _set_shed(self, on: bool) -> None:
        self._shedding = on

    # -- state read by the scheduler hooks -----------------------------------

    @property
    def deferring(self) -> bool:
        """Queued requests wait instead of admitting (shed implies defer:
        rejecting new work while pumping the backlog into a breaching
        engine would be backwards)."""
        return self._deferring or self._shedding

    @property
    def shedding(self) -> bool:
        return self._shedding

    @property
    def breaching_objectives(self) -> Tuple[str, ...]:
        return tuple(name for name, st in self.monitor._state.items()
                     if st.breaching)

    def rung_names(self) -> List[str]:
        return [r.name for r in self._ladder]

    # -- the per-tick hook ---------------------------------------------------

    def on_step(self, sched) -> None:
        """Called once per scheduler tick (from `_pre_tick`, before
        admissions). Evaluates on its cadence and moves at most one rung
        per evaluation."""
        self._ticks += 1
        if self._ticks % self.config.check_every:
            return
        self.monitor.evaluate()
        obs, kind = sched.obs, sched._sched_kind
        if self.monitor.breaching:
            self._healthy_streak = 0
            self._breach_streak += 1
            if (self._breach_streak >= self.config.degrade_after
                    and self.level < len(self._ladder)):
                rung = self._ladder[self.level]
                rung.apply()
                self.level += 1
                self._breach_streak = 0
                self._c_down.inc()
                self._g_level.set(self.level)
                obs.event("degrade", sched=kind, direction="down",
                          rung=rung.name, level=self.level,
                          objectives=list(self.breaching_objectives))
        else:
            self._breach_streak = 0
            if self.level == 0:
                return
            self._healthy_streak += 1
            if self._healthy_streak >= self.config.recover_after:
                self.level -= 1
                rung = self._ladder[self.level]
                rung.revert()
                self._healthy_streak = 0
                self._c_up.inc()
                self._g_level.set(self.level)
                obs.event("degrade", sched=kind, direction="up",
                          rung=rung.name, level=self.level)


__all__ = ["AdmissionConfig", "AdmissionController", "AdmissionShedError"]
