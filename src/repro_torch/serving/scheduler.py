"""Continuous-batching scheduler over a slot-based KV cache (port of
`repro.serving.scheduler`).

  * The scheduler owns `num_slots` cache slots: rows of one pooled decode
    cache of length `max_len` (`engine.init_slot_caches`).
  * Admission is prefill-on-admit: a queued request is prefilled alone
    (B=1, cache_len=max_len) and its fresh cache row is copied into the
    free slot's row, mid-decode, without touching other slots.
  * Every tick runs ONE decode step across all slots with per-slot
    positions; each row attends over its own valid prefix. Slots of a
    MultiTaskEngine pass their task ids, so different tasks share a tick.
  * A slot retires the moment its request finishes (EOS or budget) and is
    reusable at once; a free row still flows through the step, its logits
    are ignored and its cache row is overwritten at the next admission.

Greedy decoding gives the tokens `ServeEngine.generate` gives for the
same prompts: every per-row op is independent of the batch.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.engine import check_temperature, sample_topk


@dataclass
class Request:
    """One generation request with its own budget, sampling and task."""

    prompt: np.ndarray  # (S,) int prompt tokens
    max_new_tokens: int
    top_k: int = 0  # 0 -> greedy
    temperature: float = 1.0
    seed: Optional[int] = None  # generator seed for top-k sampling
    task_id: int = 0  # adapter-bank row (MultiTaskEngine)
    eos_id: Optional[int] = None  # stop early on this token


@dataclass
class Completion:
    request_id: int
    tokens: np.ndarray  # generated tokens (includes the EOS token, if any)
    prompt_len: int
    task_id: int
    finish_reason: str  # 'eos' | 'length'
    ttft_s: float  # submit -> first token (includes queueing)
    latency_s: float  # submit -> finished


@dataclass
class _Slot:
    request_id: int
    req: Request
    generator: Optional[torch.Generator]
    submit_t: float
    tokens: List[int] = field(default_factory=list)
    pos: int = 0  # absolute position of the next decode write
    first_tok_t: float = 0.0


class Scheduler:
    """Continuous batching around a ServeEngine or MultiTaskEngine.

    prefill_bucket: right-pad prompts to a multiple of this before prefill
    (token-exact for the full-attention configs the port serves)."""

    def __init__(self, engine, *, num_slots: int, max_len: int,
                 prefill_bucket: Optional[int] = None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.engine = engine
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefill_bucket = prefill_bucket
        self.caches = engine.init_slot_caches(num_slots, max_len)
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

    # -- request lifecycle --------------------------------------------------

    def submit(self, req: Request) -> int:
        """Queue a request; returns its id. It is admitted on the next tick
        with a free slot."""
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
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, req, time.perf_counter()))
        return rid

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _sample_one(self, logits_row: torch.Tensor, st: _Slot) -> int:
        """One request's token from its (1, 1, V) logits."""
        if st.req.top_k and st.generator is not None:
            return int(sample_topk(logits_row, st.generator, k=st.req.top_k,
                                   temperature=st.req.temperature)[0])
        return int(logits_row[0, -1].argmax())

    def _emit(self, slot_idx: int, st: _Slot, tok: int) -> bool:
        """Record one token; True when the request is done."""
        if not st.tokens:
            st.first_tok_t = time.perf_counter()
        st.tokens.append(tok)
        if st.req.eos_id is not None and tok == st.req.eos_id:
            self._retire(slot_idx, st, "eos")
            return True
        if len(st.tokens) >= st.req.max_new_tokens:
            self._retire(slot_idx, st, "length")
            return True
        return False

    def _retire(self, slot_idx: int, st: _Slot, reason: str) -> None:
        now = time.perf_counter()
        self.completions[st.request_id] = Completion(
            request_id=st.request_id,
            tokens=np.asarray(st.tokens, np.int64),
            prompt_len=int(np.asarray(st.req.prompt).shape[-1]),
            task_id=st.req.task_id,
            finish_reason=reason,
            ttft_s=st.first_tok_t - st.submit_t,
            latency_s=now - st.submit_t,
        )
        self.slots[slot_idx] = None

    def _admit_one(self, slot_idx: int, rid: int, req: Request,
                   submit_t: float) -> None:
        t0 = time.perf_counter()
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
            prompt, self.max_len, task_ids=np.asarray([req.task_id]),
            last_pos=last_pos)
        for pool, row in zip(self.caches, fresh):
            pool["k"][slot_idx].copy_(row["k"][0])
            pool["v"][slot_idx].copy_(row["v"][0])
        gen = None
        if req.top_k:
            gen = torch.Generator(device=self.engine.device).manual_seed(
                req.seed if req.seed is not None else rid)
        st = _Slot(request_id=rid, req=req, generator=gen, submit_t=submit_t,
                   pos=S)
        self.slots[slot_idx] = st
        self._task[slot_idx] = req.task_id
        tok = self._sample_one(logits, st)
        self._prefill_s += time.perf_counter() - t0
        if not self._emit(slot_idx, st, tok):
            self._tok[slot_idx] = tok
            self._pos[slot_idx] = st.pos

    def _do_admissions(self) -> None:
        """Admit queued requests into free slots; a request that finishes
        at its first token frees its slot again at once."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        while free and self.queue:
            idx = free.pop()
            self._admit_one(idx, *self.queue.popleft())
            if self.slots[idx] is None:
                free.append(idx)

    # -- the tick -----------------------------------------------------------

    def step(self) -> int:
        """One tick: admissions into free slots, then one decode step
        across all slots. Returns the number of tokens generated."""
        self._do_admissions()
        occupied = [i for i, s in enumerate(self.slots) if s is not None]
        if not occupied:
            return 0
        t0 = time.perf_counter()
        logits, self.caches = self.engine.decode_step(
            self.caches, self._tok[:, None], self._pos,
            task_ids=self._task.copy())
        self._ticks += 1
        greedy = logits[:, -1].argmax(dim=-1).cpu().numpy()
        self._decode_s += time.perf_counter() - t0
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
        return len(occupied)

    # -- batch driver -------------------------------------------------------

    def run(self, requests: List[Request]):
        """Submit `requests`, tick until drained; returns (completions in
        request order, report)."""
        t0 = time.perf_counter()
        ticks0, pre0, dec0 = self._ticks, self._prefill_s, self._decode_s
        ids = [self.submit(r) for r in requests]
        while self.queue or self.active:
            self.step()
        elapsed = time.perf_counter() - t0
        done = [self.completions.pop(i) for i in ids]
        return done, self.report(done, elapsed, ticks=self._ticks - ticks0,
                                 prefill_s=self._prefill_s - pre0,
                                 decode_s=self._decode_s - dec0)

    def report(self, done=(), elapsed_s: float = 0.0,
               ticks: Optional[int] = None, prefill_s: Optional[float] = None,
               decode_s: Optional[float] = None) -> dict:
        """Throughput and latency over `done`, timed on the host clock
        around work that ends in a device sync (every tick reads its
        tokens back). TTFT includes queueing; the token gap (tpot) is a
        request's mean gap between output tokens; p50 and max are over
        the requests. prefill_s/decode_s split the host time between
        admissions and decode ticks (default: since construction)."""
        done = list(done)
        n_tok = sum(len(c.tokens) for c in done)
        ttft = np.array([c.ttft_s for c in done], np.float64)
        tpot = np.array([(c.latency_s - c.ttft_s) / (len(c.tokens) - 1)
                         for c in done if len(c.tokens) > 1], np.float64)

        def stat(a, fn):
            return float(fn(a)) if a.size else 0.0

        return {
            "requests": len(done),
            "tokens": n_tok,
            "elapsed_s": elapsed_s,
            "ticks": self._ticks if ticks is None else ticks,
            "requests_per_s": len(done) / elapsed_s if elapsed_s else 0.0,
            "tokens_per_s": n_tok / elapsed_s if elapsed_s else 0.0,
            "mean_ttft_s": stat(ttft, np.mean),
            "ttft_p50_s": stat(ttft, np.median),
            "ttft_max_s": stat(ttft, np.max),
            "tpot_p50_s": stat(tpot, np.median),
            "tpot_max_s": stat(tpot, np.max),
            "mean_latency_s": (sum(c.latency_s for c in done) / len(done)
                               if done else 0.0),
            "prefill_s": self._prefill_s if prefill_s is None else prefill_s,
            "decode_s": self._decode_s if decode_s is None else decode_s,
        }


def format_report(report: dict) -> str:
    return "\n".join(f"  {k:<16} {v:.4f}" if isinstance(v, float)
                     else f"  {k:<16} {v}" for k, v in report.items())
