"""Per-request trace spans (port of `repro.obs.trace`, standard library
only, line for line JAX's behaviour).

A `RequestTrace` is an append-only list of (event, dt_seconds, attrs)
marks relative to the request's submit time. The schedulers mark the
lifecycle:

    submit -> [defer ...] -> admit -> prefill{kind=cold|full_hit|partial_hit}
           -> first_token -> token* [verify{accepted=a}]* -> retire{reason}

with KV-block attribution (`blocks=` on paged admissions) and bank-row
attribution (`row=`/`adapter=`) in the attrs. Every completed request's
trace starts with submit, admits once, has one `token` mark per emitted
token and ends with retire.

Tracing is bounded (finished traces go to a `keep`-sized deque) and can be
turned off: a disabled tracer hands out one shared null trace whose `mark`
does nothing, so the hot path never branches.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple


class RequestTrace:
    """One request's lifecycle: marks are (name, seconds-since-submit,
    attrs-or-None) tuples, appended in order."""

    __slots__ = ("request_id", "t0", "events")

    def __init__(self, request_id: int):
        self.request_id = request_id
        self.t0 = time.perf_counter()
        self.events: List[Tuple[str, float, Optional[dict]]] = []

    def mark(self, name: str, **attrs) -> None:
        self.events.append(
            (name, time.perf_counter() - self.t0, attrs or None))

    def names(self) -> List[str]:
        return [n for n, _, _ in self.events]

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.events if n == name)

    def attrs_of(self, name: str) -> Optional[dict]:
        """Attrs of the FIRST mark with this name (None if absent)."""
        for n, _, a in self.events:
            if n == name:
                return a or {}
        return None

    def to_dict(self) -> dict:
        return {
            "request_id": self.request_id,
            "events": [
                {"name": n, "dt_s": dt, **(a or {})}
                for n, dt, a in self.events
            ],
        }


class _NullTrace:
    """Shared no-op trace for disabled tracers."""

    __slots__ = ()
    request_id = -1
    events: List = []

    def mark(self, name: str, **attrs) -> None:
        pass

    def names(self) -> List[str]:
        return []

    def count(self, name: str) -> int:
        return 0

    def attrs_of(self, name: str) -> Optional[dict]:
        return None

    def to_dict(self) -> dict:
        return {"request_id": -1, "events": []}


NULL_TRACE = _NullTrace()


class RequestTracer:
    """Registry of live and recently finished request traces."""

    def __init__(self, enabled: bool = True, keep: int = 1024):
        self.enabled = enabled
        self.active: Dict[int, RequestTrace] = {}
        self.done: deque = deque(maxlen=keep)

    def start(self, request_id: int) -> RequestTrace:
        if not self.enabled:
            return NULL_TRACE
        tr = RequestTrace(request_id)
        self.active[request_id] = tr
        return tr

    def get(self, request_id: int):
        """Live trace for a request (null when disabled or unknown)."""
        return self.active.get(request_id, NULL_TRACE)

    def finish(self, request_id: int) -> None:
        tr = self.active.pop(request_id, None)
        if tr is not None:
            self.done.append(tr)

    def find(self, request_id: int):
        """Live-or-finished trace by id, or None."""
        tr = self.active.get(request_id)
        if tr is not None:
            return tr
        for t in self.done:
            if t.request_id == request_id:
                return t
        return None

    def reset(self) -> None:
        self.active.clear()
        self.done.clear()
