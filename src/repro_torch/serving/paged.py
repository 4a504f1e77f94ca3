"""Paged KV cache: block-table serving with copy-on-write prefix sharing
(port of `repro.serving.paged`).

The slot scheduler reserves `max_len` cache rows per slot up front. This
one keeps K/V in a pool of fixed-size pages instead:

  * One block pool per attention layer, (num_blocks, page, KH, D) K and V
    (`engine.init_paged_pool`), block 0 the reserved null block that
    unallocated table entries point at. Under `kv_quant` the pools are
    int8/e4m3 QTensors with per-token fp32 scales, and #5 dequantizes them
    where it reads them.
  * One block table per sequence, shared by every layer: a host-side
    (num_slots, max_len // page) int32 array mapping logical page j to a
    physical block.
  * A refcounted `BlockAllocator` and a `PrefixCache` keyed by chained page
    hashes of the prompt, per adapter row (the adapter rewrites K/V, so KV
    is shared only between requests of one task). Identical prefixes are
    prefilled once and shared read-only; a writer forks a partially filled
    tail block copy-on-write. A whole-prompt hit runs no forward pass and
    replays the prompt's stored last-token logits, kept on the host.
  * Admission reserves the worst case: a slot's remaining allocate-on-
    write budget stays subtracted from the free count, so a page
    allocation mid-decode never fails and nothing is preempted. When the
    free blocks less the reservations cannot cover an admission, prefix
    entries are evicted LRU-first; if that is not enough,
    `BlockPoolFullError` defers the queue, in order, to a later tick (as
    `BankFullError` does).

Each row's table has max_len // page entries, so #5 sees the pages, the
split plan and the masks of the contiguous cache and paged greedy decoding
gives the contiguous scheduler's tokens. Hot-swap (named) requests never
share KV: a name may be republished with new weights mid-stream. The
admission counts are the registry's `serve_prefix_hits_total{tier=}`
counters, and the admission ladder's first rung stops publishing retired
prompts (`set_prefix_fill`). Page hashes use Python's `hash`, salted per
process: they only have to agree within one scheduler.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry
from repro_torch.serving.registry import BankFullError
from repro_torch.serving.scheduler import Request, Scheduler, _Slot


class BlockPoolFullError(RuntimeError):
    """Admission would overcommit the block pool (free - reserved < need)."""


class BlockAllocator:
    """Refcounted free list over physical blocks 1..num_blocks-1.

    Block 0 is the null block: never handed out. A block's refcount counts
    its readers (the owning slot's table entry and every prefix-cache entry
    naming it); it returns to the free list when the last one drops it."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        # pop() hands out ascending ids: deterministic tables
        self._free = list(range(num_blocks - 1, 0, -1))
        self._refs = [0] * num_blocks

    @property
    def num_free(self) -> int:
        return len(self._free)

    def refcount(self, bid: int) -> int:
        return self._refs[bid]

    def alloc(self) -> int:
        if not self._free:
            raise BlockPoolFullError("block pool exhausted")
        bid = self._free.pop()
        self._refs[bid] = 1
        return bid

    def incref(self, bid: int) -> None:
        if bid <= 0 or self._refs[bid] <= 0:
            raise ValueError(f"incref of unallocated block {bid}")
        self._refs[bid] += 1

    def decref(self, bid: int) -> bool:
        """Drop one reference; True when the block was freed."""
        if bid <= 0 or self._refs[bid] <= 0:
            raise ValueError(f"double free of block {bid}")
        self._refs[bid] -= 1
        if self._refs[bid] == 0:
            self._free.append(bid)
            return True
        return False


class PrefixCache:
    """LRU cache of prompt-prefix blocks, keyed by chained page hashes.

    Two tiers, both per adapter key:
      * `blocks`: (akey, chain_hash_j) -> the block of one FULL page of a
        retired prompt; one allocator reference per entry.
      * `full`: (akey, S, chain_hash_all) -> (the blocks covering the whole
        prompt, its partial tail included; the stored (1, 1, V) fp32
        last-token logits on the host). A hit runs no prefill. One
        reference per listed block.

    `evict_one` drops the LRU `full` entry first (they pin the most
    blocks), then LRU `blocks` entries. `hits_full` and `hits_partial`
    count the matches: they read the `serve_prefix_hits_total{tier=}`
    counters on `obs` (a private registry when None)."""

    def __init__(self, obs: Optional[MetricsRegistry] = None):
        self.blocks: "OrderedDict[tuple, int]" = OrderedDict()
        self.full: "OrderedDict[tuple, Tuple[Tuple[int, ...], np.ndarray]]" \
            = OrderedDict()
        obs = obs if obs is not None else MetricsRegistry()
        self._c_full = obs.counter("serve_prefix_hits_total", tier="full")
        self._c_partial = obs.counter("serve_prefix_hits_total",
                                      tier="partial")

    @property
    def hits_full(self) -> int:
        return self._c_full.value

    @property
    def hits_partial(self) -> int:
        return self._c_partial.value

    def match_full(self, akey, S: int, h_all: int):
        ent = self.full.get((akey, S, h_all))
        if ent is not None:
            self.full.move_to_end((akey, S, h_all))
            self._c_full.inc()
        return ent

    def match_prefix(self, akey, hashes: List[int]) -> List[int]:
        """The longest run of cached full-page blocks of this hash chain."""
        out: List[int] = []
        for h in hashes:
            bid = self.blocks.get((akey, h))
            if bid is None:
                break
            self.blocks.move_to_end((akey, h))
            out.append(bid)
        if out:
            self._c_partial.inc()
        return out

    def insert_block(self, alloc: BlockAllocator, akey, h: int, bid: int):
        key = (akey, h)
        if key in self.blocks:
            self.blocks.move_to_end(key)
            return
        alloc.incref(bid)
        self.blocks[key] = bid

    def insert_full(self, alloc: BlockAllocator, akey, S: int, h_all: int,
                    bids: List[int], logits: np.ndarray):
        key = (akey, S, h_all)
        if key in self.full:
            self.full.move_to_end(key)
            return
        for b in bids:
            alloc.incref(b)
        self.full[key] = (tuple(bids), logits)

    def evict_one(self, alloc: BlockAllocator) -> bool:
        """Drop the LRU entry (full tier first); True if one was dropped."""
        if self.full:
            _, (bids, _) = self.full.popitem(last=False)
            for b in bids:
                alloc.decref(b)
            return True
        if self.blocks:
            _, bid = self.blocks.popitem(last=False)
            alloc.decref(bid)
            return True
        return False

    def clear(self, alloc: BlockAllocator):
        while self.evict_one(alloc):
            pass


@dataclass
class _PagedSlot(_Slot):
    akey: tuple = ()
    nb_worst: int = 0  # worst-case table entries this request may own
    nb_entries: int = 0  # table entries it owns now
    page_hashes: List[int] = field(default_factory=list)
    full_hash: int = 0
    prefill_logits: Optional[np.ndarray] = None  # (1, 1, V) host copy


class PagedScheduler(Scheduler):
    """Continuous batching over a paged block pool instead of slot rows.

    The surface of `Scheduler` (submit/step/run/report), token for token
    its greedy output at fp32, with admission gated on free blocks as well
    as free slots. kv_quant: 'int8'/'fp8' stores the blocks quantized with
    per-token scales. prefix_cache=False prefills every admission cold,
    paging all the same."""

    _sched_kind = "paged"

    def __init__(self, engine, *, num_slots: int, num_blocks: int, page: int,
                 max_len: int, kv_quant: Optional[str] = None,
                 prefix_cache: bool = True,
                 prefill_bucket: Optional[int] = None,
                 obs: Optional[MetricsRegistry] = None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if page < 1 or max_len % page != 0:
            raise ValueError(f"max_len {max_len} must be a multiple of the "
                             f"page size {page}")
        cfg = engine.cfg
        for s in cfg.layer_slots():
            if s.kind != "attn" or s.cross_attn:
                raise ValueError(
                    "PagedScheduler requires pure attention slots "
                    f"(got kind={s.kind!r} cross={s.cross_attn})")
            if s.window is not None and min(s.window, max_len) % page:
                raise ValueError(
                    f"windowed slot ring {min(s.window, max_len)} must "
                    f"be a multiple of the page size {page}")
        if prefill_bucket is not None:
            if not self.supports_bucketing(cfg):
                raise ValueError("prefill_bucket requires full-attention "
                                 "slots (same contract as Scheduler)")
            if prefill_bucket % page != 0:
                raise ValueError("prefill_bucket must be a multiple of the "
                                 "page size (pages are the unit of insert)")
        self._init_slots(engine, num_slots, max_len, prefill_bucket)
        self._init_obs(obs)  # before PrefixCache: its counters land there
        self.page = page
        self.nb_max = max_len // page
        self.kv_quant = kv_quant
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(obs=self.obs) if prefix_cache else None)
        self._prefix_fill = True  # publication gate (the admission ladder)
        self._c_cold = self.obs.counter("serve_prefix_hits_total",
                                        tier="cold")
        self._g_free_blocks = self.obs.gauge("kv_free_blocks")
        self._g_reserved_blocks = self.obs.gauge("kv_reserved_blocks")
        self.obs.add_derived(
            "prefix_hit_ratio_full",
            lambda: self._prefix_hit_ratio("full_hits"))
        self.obs.add_derived(
            "prefix_hit_ratio_partial",
            lambda: self._prefix_hit_ratio("partial_hits"))
        self.alloc = BlockAllocator(num_blocks)
        self.pool = engine.init_paged_pool(num_blocks, page, kv_quant)
        self.tables = np.zeros((num_slots, self.nb_max), np.int32)
        self._reserved = 0  # allocate-on-write budget of the live slots

    @property
    def stats(self) -> dict:
        """Admissions by kind: whole-prompt hits, prefix hits, cold (a
        view of the registry's counters)."""
        return {
            "full_hits": self.prefix.hits_full if self.prefix else 0,
            "partial_hits": self.prefix.hits_partial if self.prefix else 0,
            "cold": self._c_cold.value,
        }

    def _prefix_hit_ratio(self, key: str) -> float:
        s = self.stats
        tot = s["full_hits"] + s["partial_hits"] + s["cold"]
        return s[key] / tot if tot else 0.0

    def set_prefix_fill(self, on: bool) -> None:
        """Gate publication into the prefix cache (the admission ladder's
        first rung). Entries keep serving hits and keep their LRU
        eviction; only the spend stops: retiring requests no longer pin
        their prompt blocks, so the pool drains toward in-flight work."""
        if self.prefix is None or on == self._prefix_fill:
            return
        self._prefix_fill = on
        self.obs.event("prefix_fill", sched=self._sched_kind, enabled=on)

    # -- sizing -------------------------------------------------------------

    def _nb_worst(self, S: int, max_new: int, P: int) -> int:
        """Worst-case table entries of a request: its page-aligned prefill
        cover and every decode write of its token budget."""
        return max(P // self.page, -(-(S + max_new) // self.page))

    def _padded_len(self, S: int) -> int:
        b = self.prefill_bucket if self.prefill_bucket else self.page
        return min(-(-S // b) * b, self.max_len)

    def submit(self, req: Request) -> int:
        S = int(np.asarray(req.prompt).shape[-1])
        nb_worst = self._nb_worst(S, req.max_new_tokens, self._padded_len(S))
        if nb_worst > self.alloc.num_blocks - 1:
            raise ValueError(
                f"request needs {nb_worst} blocks but the pool only has "
                f"{self.alloc.num_blocks - 1} allocatable blocks")
        return super().submit(req)

    # -- prefix hashing -----------------------------------------------------

    def _hash_chain(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """Chained per-page hashes (page j's folds in page j-1's) and the
        whole-prompt hash, the partial tail included."""
        hs: List[int] = []
        h = 0
        n_full = len(prompt) // self.page
        for j in range(n_full):
            h = hash((h, prompt[j * self.page:(j + 1) * self.page].tobytes()))
            hs.append(h)
        tail = prompt[n_full * self.page:]
        h_all = hash((h, tail.tobytes())) if len(tail) else h
        return hs, h_all

    def _ensure_free(self, need: int):
        """Evict prefix entries until `need` blocks are allocatable over and
        above the live slots' reservations."""
        while self.alloc.num_free - self._reserved < need:
            if self.prefix is None or not self.prefix.evict_one(self.alloc):
                raise BlockPoolFullError(
                    f"need {need} blocks, "
                    f"{self.alloc.num_free - self._reserved} available "
                    f"after reservations")

    # -- admission ----------------------------------------------------------

    def _admit_one(self, slot_idx: int, rid: int, req: Request,
                   submit_t: float):
        t0 = time.perf_counter()
        row = req.task_id
        if req.adapter is not None:
            row = self.engine.acquire_adapter(req.adapter)  # pins the row
        try:
            self._admit_paged(slot_idx, rid, req, submit_t, row)
        except BlockPoolFullError:
            if req.adapter is not None:
                self.engine.release_adapter(req.adapter)
            raise
        self._m_queue_s.observe(time.perf_counter() - submit_t)
        st = self.slots[slot_idx]
        self._task[slot_idx] = row
        if st.generator is not None:
            tok = self._sample_one(torch.from_numpy(st.prefill_logits).to(
                self.engine.device), st)
        else:
            # the host copy's first maximum, as jnp.argmax breaks ties;
            # a whole-prompt hit reaches the device not at all
            tok = int(st.prefill_logits[0, -1].argmax())
        self._prefill_s += time.perf_counter() - t0
        if not self._emit(slot_idx, st, tok):
            self._tok[slot_idx] = tok
            self._pos[slot_idx] = st.pos

    def _admit_paged(self, slot_idx: int, rid: int, req: Request,
                     submit_t: float, row: int):
        prompt = np.asarray(req.prompt, np.int64).reshape(-1)
        S = len(prompt)
        page = self.page
        nb_cov = -(-S // page)  # blocks covering the true prompt
        P = self._padded_len(S)
        nb_worst = self._nb_worst(S, req.max_new_tokens, P)
        # named (hot-swap) adapters may be republished with new weights
        # mid-stream, which would stale KV cached under the name: named
        # requests never share KV (static task rows are immutable)
        cacheable = self.prefix is not None and req.adapter is None
        akey = ("task", row)
        hashes, h_all = self._hash_chain(prompt) if cacheable else ([], 0)
        tr = self.obs.tracer.get(rid)
        st = _PagedSlot(request_id=rid, req=req,
                        generator=self._generator(req, rid),
                        submit_t=submit_t, pos=S, row=row, trace=tr,
                        akey=akey, nb_worst=nb_worst, page_hashes=hashes,
                        full_hash=h_all)
        tbl = self.tables[slot_idx]
        task_ids = np.asarray([row])

        ent = self.prefix.match_full(akey, S, h_all) if cacheable else None
        if ent is not None:
            # ---- whole-prompt hit: no forward pass ----
            bids, logits = list(ent[0]), ent[1]
            for b in bids:
                self.alloc.incref(b)
            try:
                fork = 1 if S % page else 0
                self._ensure_free(fork + nb_worst - nb_cov)
            except BlockPoolFullError:
                for b in bids:
                    self.alloc.decref(b)
                raise
            if S % page:
                # the first decode write lands in the partially filled tail
                # block, so the writer forks it
                dst = self.alloc.alloc()
                self.pool = self.engine.copy_block(self.pool, bids[-1], dst)
                self.alloc.decref(bids[-1])
                bids[-1] = dst
            tbl[:nb_cov] = bids
            st.nb_entries = nb_cov
            st.prefill_logits = logits
            hit_kind = "full_hit"  # counted by PrefixCache.match_full
        else:
            m_bids: List[int] = []
            if cacheable and S > page:
                m_bids = self.prefix.match_prefix(
                    akey, hashes[:(S - 1) // page])  # keep a suffix
            m = len(m_bids)
            if m:
                # ---- prefix hit: prefill only the suffix, in place ----
                for b in m_bids:
                    self.alloc.incref(b)
                try:
                    self._ensure_free(nb_worst - m)
                except BlockPoolFullError:
                    for b in m_bids:
                        self.alloc.decref(b)
                    raise
                tbl[:m] = m_bids
                for j in range(m, nb_cov):
                    tbl[j] = self.alloc.alloc()
                st.nb_entries = nb_cov
                sfx = prompt[m * page:]
                padded = (nb_cov - m) * page
                if padded > len(sfx):
                    sfx = np.pad(sfx, (0, padded - len(sfx)))
                logits, self.pool = self.engine.paged_extend(
                    self.pool, sfx.reshape(1, -1),
                    self.tables[slot_idx:slot_idx + 1], start=m * page,
                    kv_len=S, last_pos=S - m * page - 1, task_ids=task_ids)
                hit_kind = "partial_hit"  # counted by match_prefix
            else:
                # ---- cold: prefill the page-aligned prompt, insert ----
                self._ensure_free(nb_worst)
                nbl = P // page
                for j in range(nbl):
                    tbl[j] = self.alloc.alloc()
                st.nb_entries = nbl
                toks = prompt.reshape(1, -1)
                if P > S:
                    toks = np.pad(toks, ((0, 0), (0, P - S)))
                logits, fresh = self.engine.prefill(
                    toks, P, task_ids=task_ids,
                    last_pos=None if P == S else S - 1)
                self.pool = self.engine.paged_insert(self.pool, fresh,
                                                     tbl[:nbl])
                self._c_cold.inc()
                hit_kind = "cold"
            st.prefill_logits = logits[:, -1:].cpu().numpy()
        # marked on success only: a deferred admission (pool full) leaves
        # no admit mark, so a trace admits exactly once
        tr.mark("admit", slot=slot_idx, row=row, adapter=req.adapter,
                queue_s=time.perf_counter() - submit_t)
        tr.mark("prefill", kind=hit_kind, blocks=st.nb_entries)
        self._reserved += st.nb_worst - st.nb_entries
        self.slots[slot_idx] = st

    # -- retirement ---------------------------------------------------------

    def _retire(self, slot_idx: int, st: _PagedSlot, reason: str):
        tbl = self.tables[slot_idx]
        if (self.prefix is not None and self._prefix_fill
                and st.req.adapter is None
                and reason != "error" and st.prefill_logits is not None):
            # publish the prompt's blocks before dropping this slot's
            # references: full pages into the chain tier, the whole cover
            # (partial tail and stored logits included) into the full tier
            S = int(np.asarray(st.req.prompt).shape[-1])
            for j, h in enumerate(st.page_hashes):
                self.prefix.insert_block(self.alloc, st.akey, h, int(tbl[j]))
            nb_cov = -(-S // self.page)
            self.prefix.insert_full(
                self.alloc, st.akey, S, st.full_hash,
                [int(b) for b in tbl[:nb_cov]], st.prefill_logits)
        self._reserved -= st.nb_worst - st.nb_entries
        for j in range(self.nb_max):
            if tbl[j]:
                self.alloc.decref(int(tbl[j]))
                tbl[j] = 0
        super()._retire(slot_idx, st, reason)

    # -- the tick -----------------------------------------------------------

    # defer on block exhaustion too: admission retries after a retirement
    # releases blocks, the queue's order kept
    _defer_errors = (BankFullError, BlockPoolFullError)

    def _alloc_pages(self, i: int, st: _PagedSlot, first: int, last: int):
        """Allocate-on-write: a fresh block for every null table entry of
        logical pages first..last. Admission paid for each (one unit of
        the slot's reservation released per block), so this cannot fail."""
        for j in range(first, last + 1):
            if not self.tables[i, j]:
                self.tables[i, j] = self.alloc.alloc()
                st.nb_entries += 1
                self._reserved -= 1

    def _decode_tick(self, occupied: List[int]) -> torch.Tensor:
        for i in occupied:
            st = self.slots[i]
            p = int(self._pos[i])
            if p // self.page < st.nb_worst:
                self._alloc_pages(i, st, p // self.page, p // self.page)
        logits, self.pool = self.engine.paged_decode_step(
            self.pool, self._tok[:, None], self._pos, self.tables,
            task_ids=self._task.copy())
        return logits

    def _post_tick(self, t0: float) -> None:
        self._g_free_blocks.set(self.alloc.num_free)
        self._g_reserved_blocks.set(self._reserved)
        super()._post_tick(t0)

    # -- accounting ---------------------------------------------------------

    def pool_report(self) -> dict:
        """The pool's live accounting."""
        live = self.alloc.num_blocks - 1 - self.alloc.num_free
        return {
            "num_blocks": self.alloc.num_blocks - 1,
            "live_blocks": live,
            "free_blocks": self.alloc.num_free,
            "reserved_blocks": self._reserved,
            "prefix_block_entries": (len(self.prefix.blocks)
                                     if self.prefix else 0),
            "prefix_full_entries": (len(self.prefix.full)
                                    if self.prefix else 0),
            **self.stats,
        }
