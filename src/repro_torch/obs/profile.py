"""Profiling hooks: named kernel ranges and whole-program trace capture
(the port's counterpart of `repro.obs.profile`, in PyTorch's idiom).

  * `scope(name)` names a region in a captured trace. JAX's is
    `jax.named_scope`, applied at trace time and free at run time; the
    port's runs at every call, so it costs one check of a module-level
    flag when no capture is running, and enters
    `torch.profiler.record_function(name)` only while `profiler_trace` or
    `ProfiledTicks` captures. The dispatch functions of
    `repro_torch.kernels.ops` carry it (`repro.hadamard`,
    `repro.paged_attention`, ...), so a trace attributes each kernel's
    device time to the range that launched it. It works as a context
    manager and as a decorator.
  * `annotate(name)` is a host-side region for Python-level phases (a
    scheduler tick, an admission): `record_function` too, which records
    nothing outside a capture.
  * `profiler_trace(log_dir)` and `ProfiledTicks(log_dir, n)` capture:
    `torch.profiler.profile` over the CPU and, where there is one, the
    CUDA device, written as one Chrome trace, `log_dir/trace.json`
    (Perfetto and chrome://tracing read it), when the capture stops.
    `ProfiledTicks` is `launch/serve --profile-dir`'s hook: start now,
    stop after n scheduler ticks, tolerate the serve draining first.

A profiler that cannot start warns and the run goes on: serving must
never fail because profiling could not start.
"""
from __future__ import annotations

import contextlib
import functools
import os
import warnings

import torch

TRACE_FILE = "trace.json"

# True while a capture runs: set and cleared by `_Capture` alone, read by
# every `scope` at every call
_capturing = False


class _Scope:
    """One named range; see `scope`."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if _capturing:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            if not _capturing:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return scoped


def scope(name: str) -> _Scope:
    """A named range in a captured trace, as `with scope(name):` or as
    `@scope(name)`; outside a capture one flag check and nothing else."""
    return _Scope(name)


def annotate(name: str):
    """Host-side profiler region (records nothing outside a capture)."""
    return torch.profiler.record_function(name)


class _Capture:
    """One `torch.profiler.profile` over CPU and CUDA activity, written to
    `log_dir/trace.json` when it stops; `scope` records while it runs."""

    def __init__(self, log_dir: str):
        global _capturing
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, TRACE_FILE)
        self._prof = None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            os.makedirs(log_dir, exist_ok=True)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except (RuntimeError, OSError) as e:
            warnings.warn(f"profiler trace not started: {e}")
            return
        self._prof = prof
        _capturing = True

    @property
    def running(self) -> bool:
        return self._prof is not None

    def stop(self) -> None:
        """Stop and write the trace; a second call does nothing."""
        global _capturing
        prof, self._prof = self._prof, None
        if prof is None:
            return
        _capturing = False
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(self.path)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Capture a trace of the enclosed region into `log_dir/trace.json`."""
    cap = _Capture(log_dir)
    try:
        yield cap
    finally:
        cap.stop()


class ProfiledTicks:
    """Capture a trace spanning the next `n` scheduler ticks.

    Usage (launch/serve --profile-dir):

        prof = ProfiledTicks(log_dir, n=8)
        while driving:
            sched.step()
            prof.tick()
        prof.stop()  # idempotent; stops early if the serve drained first
    """

    def __init__(self, log_dir: str, n: int = 8):
        self.log_dir = log_dir
        self.remaining = max(1, int(n))
        self._cap = _Capture(log_dir)

    @property
    def path(self) -> str:
        return self._cap.path

    def tick(self) -> None:
        """Count one scheduler tick; stops the capture at zero."""
        if not self._cap.running:
            return
        self.remaining -= 1
        if self.remaining <= 0:
            self.stop()

    def stop(self) -> None:
        self._cap.stop()


__all__ = ["ProfiledTicks", "TRACE_FILE", "annotate", "profiler_trace",
           "scope"]
