"""Speculative multi-token decoding inside the continuous-batching tick
(port of `repro.serving.spec`).

Every tenant is the same frozen backbone plus a per-task affine (w, b), so
the backbone under identity adapters (w = 1, b = 0) is a draft model that
costs no weights: only a second set of slot caches. A `DraftLane` drafts k
greedy tokens a row each tick; the target then scores the k+1 positions
(the last accepted token and the k drafts) in one verify forward, and each
slot keeps the longest run of drafts that match the target's greedy
argmax, plus the target's own next token.

  * Greedy speculative decoding gives plain greedy decoding's tokens:
    each emitted token is the target's greedy choice, whatever the draft
    proposed (a poor draft costs speed, never tokens), as long as the
    verify forward's row j equals a plain decode step at pos+j.
  * Rollback is by overwrite: a verify writes KV at pos..pos+k; after
    accepting a drafts the next write starts at pos+a+1 <= pos+k, so each
    rejected position is rewritten before any query's causal bound
    reaches it.
  * Sampled (top_k) slots ride the same tick and draw one token from the
    verify's column 0, the plain decode distribution.
  * Full-attention targets only: recurrent state would take the drafts in
    (and the port admits no window yet). Self-drafting needs a Hadamard
    adapter (the identity row is the backbone); any other kind brings a
    separate draft model of the same vocabulary.
  * The draft lane decodes on its own contiguous slot caches even when the
    target is paged: a stale draft lowers the acceptance rate, never the
    tokens.

Where JAX drafts in one `lax.scan`, the lane runs k+1 decode steps in a
Python loop (the last writes the k-th draft's KV so an all-accept tick
leaves no gap in the draft cache); each step goes through the kernels.

The drafted/accepted/verify-tick counts are the registry's
`serve_spec_*_total` counters; the admission ladder lowers the effective
depth with `set_spec_k` (a `spec_depth` event) without touching the
draft's or the verify's shapes.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import tree as tu
from repro_torch.core.hadamard import ADAPTER_RE
from repro_torch.models import model as M
from repro_torch.serving.paged import PagedScheduler
from repro_torch.serving.scheduler import Request, Scheduler


class DraftLane:
    """The draft half of speculation: its own slot caches, an admission
    prefill and a k-step greedy draft.

    Self-speculation (draft=None) drafts with the engine's live backbone
    under identity adapters: the identity leaves are made once, and the
    draft tree is grafted from `engine.params` at every call, so a bank row
    written between calls is what the next call reads (the backbone leaves
    are the target's own, shared by reference). A separate draft model
    (draft=(cfg, params)) must share the target's vocabulary; it is moved
    to the engine's device once."""

    def __init__(self, engine, num_slots: int, max_len: int, k: int, *,
                 draft: Optional[Tuple] = None):
        if k < 1:
            raise ValueError("spec_k must be >= 1")
        self.engine = engine
        self.k = k
        self.max_len = max_len
        self._ident = {}
        if draft is None:
            if engine.cfg.adapter.kind != "hadamard":
                raise ValueError(
                    "self-speculation drafts with the adapter-free frozen "
                    "backbone (identity Hadamard rows w=1, b=0), which "
                    f"requires adapter.kind='hadamard' (got "
                    f"{engine.cfg.adapter.kind!r}); pass a separate draft "
                    "model via draft=(cfg, params)")
            self.cfg = engine.cfg
            self._sep = None
            for path, leaf in tu.flatten_with_paths(engine.params):
                if ADAPTER_RE.search("/" + path):
                    # a bank's (T, d) rows and one adapter's (d,) leaves
                    # alike give one (d,) identity
                    fill = 1.0 if path.endswith("/w") else 0.0
                    self._ident[path] = torch.full(
                        leaf.shape[-1:], fill, dtype=leaf.dtype,
                        device=leaf.device)
        else:
            dcfg, dparams = draft
            if dcfg.vocab_size != engine.cfg.vocab_size:
                raise ValueError(
                    f"draft model vocab {dcfg.vocab_size} != target vocab "
                    f"{engine.cfg.vocab_size}: drafted token ids would not "
                    "be target tokens")
            self.cfg = dcfg
            self._sep = tu.map_with_path(lambda _, t: t.to(engine.device),
                                         dparams)
        self.caches = M.init_decode_caches(self.cfg, num_slots, max_len,
                                           engine.device)

    def _params(self) -> dict:
        """The draft tree of this call (see the class docstring)."""
        if self._sep is not None:
            return self._sep
        return tu.map_with_path(lambda p, v: self._ident.get(p, v),
                                self.engine.params)

    def admit(self, slot_idx: int, prompt: np.ndarray, last_pos: int):
        """Prefill `prompt` ((1, S_pad), right-padded) through the draft
        model into the lane's row slot_idx. Runs at every admission, a
        target's whole-prompt prefix hit included (it skips the target's
        prefill, not the draft's)."""
        tokens = torch.as_tensor(prompt, dtype=torch.long,
                                 device=self.engine.device)
        with torch.no_grad():
            _, fresh = M.prefill_lm(self._params(), self.cfg, tokens,
                                    self.max_len, last_pos=last_pos)
            for pool, new in zip(self.caches, fresh):
                for name, leaf in pool.items():
                    leaf[slot_idx].copy_(new[name][0])

    def draft(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Greedy-draft k tokens a row: feed tok (B,), the last accepted
        token, at pos (B,) and chain the argmax on the device. Returns the
        (B, k) drafts; the lane's caches hold positions through pos+k."""
        params = self._params()
        outs = []
        with torch.no_grad():
            for _ in range(self.k + 1):
                logits, self.caches = M.decode_lm(params, self.cfg,
                                                  self.caches, tok[:, None],
                                                  pos)
                tok = logits[:, -1].argmax(dim=-1)
                outs.append(tok)
                pos = pos + 1
        return torch.stack(outs[:self.k], dim=1)


class _SpecMixin:
    """The verify tick shared by both speculative schedulers: draft,
    verify, acceptance, accounting. A scheduler class supplies
    `_verify_tick` and `_spec_padded_len`."""

    _sched_kind = "spec"

    def _init_spec(self, engine, num_slots: int, max_len: int, spec_k: int,
                   draft: Optional[Tuple]) -> None:
        """The draft lane and the speculation counters, on the
        scheduler's registry."""
        self.draft_lane = DraftLane(engine, num_slots, max_len, spec_k,
                                    draft=draft)
        # the depth acceptance is capped at (set_spec_k); the draft and
        # the verify keep the static spec_k's shapes
        self.spec_k_eff = spec_k
        self._g_spec_k = self.obs.gauge("serve_spec_k_effective",
                                        sched=self._sched_kind)
        self._g_spec_k.set(spec_k)
        self._c_drafted = self.obs.counter("serve_spec_drafted_total")
        self._c_accepted = self.obs.counter("serve_spec_accepted_total")
        self._c_spec_ticks = self.obs.counter("serve_spec_ticks_total")
        self.obs.add_derived("spec_acceptance_rate",
                             lambda: self.acceptance_rate)
        tc = getattr(self.draft_lane, "trace_counts", None)
        if tc is not None:
            self._watch_traces("draft_lane", tc)

    @staticmethod
    def _check_spec_target(engine, spec_k: int) -> None:
        if spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if not Scheduler.supports_bucketing(engine.cfg):
            raise ValueError(
                "speculative decoding requires full-attention slots: a "
                "windowed ring cache evicts entries the earlier verify "
                "queries still need when the k draft positions are "
                "written (masks can hide stale data, not recover evicted "
                "data); recurrent state folds the drafts in outright")

    def set_spec_k(self, k: int) -> None:
        """The effective speculation depth, 0 <= k <= spec_k; safe between
        ticks. Reservations and the headroom guard keep the static spec_k,
        and greedy output stays token-identical at every depth; k = 0
        runs plain decode ticks. A change is a `spec_depth` event."""
        if not isinstance(k, int) or not 0 <= k <= self.spec_k:
            raise ValueError(
                f"effective spec_k must be an int in [0, {self.spec_k}], "
                f"got {k!r}")
        if k == self.spec_k_eff:
            return
        self.spec_k_eff = k
        self._g_spec_k.set(k)
        self.obs.event("spec_depth", sched=self._sched_kind, spec_k=k)

    @property
    def spec_stats(self) -> dict:
        """A view of the speculation counters."""
        return {"drafted": self._c_drafted.value,
                "accepted": self._c_accepted.value,
                "spec_ticks": self._c_spec_ticks.value}

    @property
    def acceptance_rate(self) -> float:
        d = self._c_drafted.value
        return self._c_accepted.value / d if d else 0.0

    def submit(self, req: Request) -> int:
        """The headroom guard: a verify writes up to spec_k positions past
        the last emitted token, and they must stay in the cache."""
        S = int(np.asarray(req.prompt).shape[-1])
        if S + req.max_new_tokens + self.spec_k > self.max_len:
            raise ValueError(
                f"prompt_len {S} + max_new_tokens {req.max_new_tokens} + "
                f"spec_k {self.spec_k} exceeds cache length {self.max_len} "
                "(speculative verify writes up to spec_k positions past "
                "the token budget)")
        return super().submit(req)

    def _admit_one(self, slot_idx, rid, req, submit_t):
        """The target's admission, mirrored into the draft lane (padded as
        the target pads the prompt)."""
        super()._admit_one(slot_idx, rid, req, submit_t)
        if self.slots[slot_idx] is None:
            return  # finished at its first token: nothing to draft
        prompt = np.asarray(req.prompt, np.int64).reshape(1, -1)
        S = prompt.shape[1]
        P = self._spec_padded_len(S)
        if P > S:
            prompt = np.pad(prompt, ((0, 0), (0, P - S)))
        self.draft_lane.admit(slot_idx, prompt, last_pos=S - 1)

    def _step_impl(self) -> int:
        """One tick after the pre-tick hooks: admissions, k drafts a row,
        one verify of k+1 positions, acceptance. Returns the tokens
        emitted."""
        if self.spec_k_eff == 0:
            return super()._step_impl()  # plain decode ticks
        t0 = time.perf_counter()
        self._do_admissions()
        occupied = [i for i, s in enumerate(self.slots) if s is not None]
        if not occupied:
            return 0
        t_dec = time.perf_counter()
        dev = self.engine.device
        tok = torch.as_tensor(self._tok, device=dev)
        drafts = self.draft_lane.draft(
            tok, torch.as_tensor(self._pos, device=dev))
        toks = torch.cat([tok[:, None], drafts], dim=1)  # (B, k+1)
        logits = self._verify_tick(occupied, toks)
        self._ticks += 1
        greedy = logits.argmax(dim=-1).cpu().numpy()
        toks_h = toks.cpu().numpy()
        self._decode_s += time.perf_counter() - t_dec
        produced = self._spec_emit(occupied, toks_h, greedy, logits)
        self._post_tick(t0)
        return produced

    def _spec_emit(self, occupied: List[int], toks_h: np.ndarray,
                   greedy: np.ndarray, logits: torch.Tensor) -> int:
        """Per-slot acceptance against the verify's greedy tokens (B, k+1):
        a greedy slot emits its accepted drafts and the correction token; a
        sampled slot draws one token from column 0. Acceptance is capped at
        the effective depth; `drafted` counts the static spec_k, the draft
        work spent."""
        k = self.spec_k_eff
        self._c_spec_ticks.inc()
        produced = 0
        for i in occupied:
            st = self.slots[i]
            if st.req.top_k and st.generator is not None:
                # column 0 is the plain decode distribution (the causal
                # bound hides every draft write); its rejected drafts are
                # the a = 0 rollback
                st.pos += 1
                tok = self._sample_one(logits[i:i + 1, :1], st)
                produced += 1
                if not self._emit(i, st, tok):
                    self._tok[i] = tok
                    self._pos[i] = st.pos
                continue
            a = 0
            while a < k and toks_h[i, a + 1] == greedy[i, a]:
                a += 1
            self._c_drafted.inc(self.spec_k)
            self._c_accepted.inc(a)
            st.trace.mark("verify", accepted=a, drafted=k)
            done = False
            tok = 0
            for j in range(a + 1):  # a accepted drafts and the correction
                st.pos += 1
                tok = int(greedy[i, j])
                produced += 1
                if self._emit(i, st, tok):
                    done = True
                    break
            if not done:
                self._tok[i] = tok
                self._pos[i] = st.pos
        return produced


class SpecScheduler(_SpecMixin, Scheduler):
    """Continuous batching with speculative decoding over the contiguous
    slot caches: `Scheduler`'s surface and greedy tokens, 1 to spec_k+1
    tokens a greedy slot a tick.

    draft: None for self-speculation, or a (cfg, params) draft model of
    the target's vocabulary."""

    def __init__(self, engine, *, num_slots: int, max_len: int,
                 spec_k: int = 4, draft: Optional[Tuple] = None,
                 stream=None, prefill_bucket: Optional[int] = None,
                 obs=None):
        self._check_spec_target(engine, spec_k)
        super().__init__(engine, num_slots=num_slots, max_len=max_len,
                         stream=stream, prefill_bucket=prefill_bucket,
                         obs=obs)
        self.spec_k = spec_k
        self._init_spec(engine, num_slots, max_len, spec_k, draft)

    def _spec_padded_len(self, S: int) -> int:
        if self.prefill_bucket is None:
            return S
        return min(self.max_len,
                   -(-S // self.prefill_bucket) * self.prefill_bucket)

    def _verify_tick(self, occupied: List[int],
                     toks: torch.Tensor) -> torch.Tensor:
        # a free slot verifies at pos 0 and a retired one at its last
        # position, which the headroom guard keeps at pos + k < max_len:
        # every query row sees key 0 at least, so #5 meets no key-less row
        logits, self.caches = self.engine.verify_step(
            self.caches, toks, self._pos, task_ids=self._task.copy())
        return logits


class SpecPagedScheduler(_SpecMixin, PagedScheduler):
    """Speculative decoding over the paged pool: the verify writes k+1
    positions a row through the block tables, so admission reserves
    spec_k more worst-case positions and every page the tick's writes can
    touch is allocated before the verify (the reservation keeps this
    infallible). The draft lane stays contiguous."""

    _sched_kind = "spec_paged"

    def __init__(self, engine, *, num_slots: int, num_blocks: int, page: int,
                 max_len: int, spec_k: int = 4, draft: Optional[Tuple] = None,
                 kv_quant: Optional[str] = None, prefix_cache: bool = True,
                 stream=None, prefill_bucket: Optional[int] = None,
                 obs=None):
        self._check_spec_target(engine, spec_k)
        self.spec_k = spec_k
        super().__init__(engine, num_slots=num_slots, num_blocks=num_blocks,
                         page=page, max_len=max_len, kv_quant=kv_quant,
                         prefix_cache=prefix_cache, stream=stream,
                         prefill_bucket=prefill_bucket, obs=obs)
        self._init_spec(engine, num_slots, max_len, spec_k, draft)

    def _spec_padded_len(self, S: int) -> int:
        return self._padded_len(S)

    def _nb_worst(self, S: int, max_new: int, P: int) -> int:
        """spec_k more positions: the last tick's verify writes through
        position S + max_new + spec_k - 1."""
        return max(P // self.page,
                   -(-(S + max_new + self.spec_k) // self.page))

    def _verify_tick(self, occupied: List[int],
                     toks: torch.Tensor) -> torch.Tensor:
        # allocate-on-write over the verify's whole write range pos..pos+k:
        # the null block would swallow accepted KV
        for i in occupied:
            st = self.slots[i]
            p0 = int(self._pos[i])
            self._alloc_pages(i, st, p0 // self.page,
                              min((p0 + self.spec_k) // self.page,
                                  st.nb_worst - 1))
        # kv_lens = pos + k + 1 >= 1 for every row (see SpecScheduler)
        logits, self.pool = self.engine.paged_verify_step(
            self.pool, toks, self._pos, self.tables,
            task_ids=self._task.copy())
        return logits
