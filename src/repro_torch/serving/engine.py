"""Serving engines (port of `repro.serving.engine`): prefill and per-row
decode over slot caches, lock-step generation, and multi-task Hadamard
serving over a static or a hot-swap adapter bank.

`ServeEngine` serves one adapter; every block runs the fused
adapter-residual-norm kernel. `MultiTaskEngine` serves a bank of T tasks'
adapters over one frozen backbone: requests carrying different task ids
share every decode tick, and each block reads each row's adapter out of
the bank inside the multitask kernel. Over a hot-swap `AdapterBank`
(rows loaded and evicted by name at run time, pruned tenants gated off
per layer) every step passes the bank's device-resident row gates, and
each block runs the masked multitask kernel instead. With `quant="int8"` or `"fp8"` either
engine quantizes the frozen backbone's matmul weights once, at
construction, and every projection of every step then streams 1-byte
weights through the dequant-matmul kernel (over an RWKV6 config only its
untied LM head matches the quantization table).

Both engines also step a paged block pool (`init_paged_pool`,
`paged_insert`, `copy_block`, `paged_decode_step`, `paged_extend`), for
`serving/paged.py`, and score k+1 tokens a row in one forward
(`verify_step`, `paged_verify_step`), for `serving/spec.py`.

`ServeEngine(fold=True)` folds the Hadamard adapter into W_O and b_O at
construction (`core.hadamard.fold_adapter`, before any quantization), as
JAX's engine does: the adapter op still runs, on the identity.
Sharded serving: an engine built inside `dist.api.use_mesh(mesh)` holds
its rank's shards (`dist.sharding.shard_params`: a quantized trunk is
quantized whole, then sliced) and runs its `local_cfg`, activating the
mesh again around every model call; its slot caches and paged pools hold
the rank's KV heads, their slot and block dims whole (JAX's
`slot_cache_spec`, `paged_cache_spec`). Every data rank computes every
slot, as JAX's replicated slot dim implies, so the tokens are the same on
every rank. `full_cfg` is the config it was given.
`generate` is JAX's unified entry point: a (B, S) array of same-length
prompts decoded lock-step to one budget, or a list of `Request`s with
their own budgets, sampling, EOS and (on a MultiTaskEngine) task rows or
adapter names.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common import tree as tu
from repro_torch.common.device import resolve_device
from repro_torch.common.types import ModelCfg
from repro_torch.core.hadamard import build_bank, fold_adapter
from repro_torch.dist.api import current_mesh, use_mesh
from repro_torch.dist.sharding import local_cfg, shard_params
from repro_torch.models import model as M
from repro_torch.models.attention import DECODE_PAGE, write_pool
from repro_torch.quant.qtensor import is_qtensor, quantize_tree


def check_temperature(temperature) -> float:
    t = float(temperature)
    if not np.isfinite(t) or t < 0:
        raise ValueError(f"temperature must be finite and >= 0 (got "
                         f"{temperature!r}); temperature=0 decodes greedily")
    return t


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, -1].argmax(dim=-1)


def sample_topk(logits: torch.Tensor, generator: torch.Generator,
                k: int = 40, temperature: float = 1.0) -> torch.Tensor:
    """Top-k sampling from `generator` (on the logits' device);
    temperature <= 0 is explicit argmax."""
    if temperature <= 0:
        return sample_greedy(logits)
    top, idx = torch.topk(logits[:, -1] / temperature, k, dim=-1)
    choice = torch.multinomial(torch.softmax(top, dim=-1), 1,
                               generator=generator)
    return idx.gather(-1, choice)[:, 0]


def round_to_page(n: int) -> int:
    return -(-n // DECODE_PAGE) * DECODE_PAGE


class ServeEngine:
    """Greedy/top-k generation for a decoder config with one adapter.

    device: where the parameters live and every step runs; `cuda` unless
    given (and with no CUDA present the constructor raises).

    fold: fold a Hadamard adapter into W_O and b_O (fp32) and reset it to
    the identity, which the model still runs (as JAX's engine does).

    quant: None keeps the parameters as given; "int8"/"fp8" quantizes the
    backbone's matmul projections (`quantize_tree`) before placement, after
    any folding, so the device holds 1 byte per weight. Adapters, norms and
    the embedding keep their dtype. A tree that already holds QTensors
    passes through untouched (`quantize_tree` is idempotent).

    The engine does not own `params`: `quantize_tree` leaves it untouched,
    so while the caller references it the build holds the dense tree and
    the quantized one at once (gemma2-27b: 54.5 GB of bf16 beside a 28.4
    GB int8 tree, more than one 80 GB card). A caller that owns its tree
    quantizes it in place first (`quant.quantize_owned`, as
    `launch.serve.build_engine` and the launcher do): the peak is then the
    dense tree and one projection's temporaries, and the engine adopts the
    QTensors as they are.
    """

    def __init__(self, cfg: ModelCfg, params: dict, *, fold: bool = False,
                 quant: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.mesh = current_mesh()
        self.full_cfg = cfg
        self.cfg = local_cfg(cfg, self.mesh)  # refuses what is not sharded
        if fold and cfg.adapter.kind == "hadamard":
            params = fold_adapter(params, cfg)
        if quant:
            params = quantize_tree(params, mode=quant)
        if self.mesh is not None:  # quantized whole, then sliced
            params = shard_params(params, cfg, self.mesh)
        self.quant = quant
        self.params = tu.map_with_path(lambda _, t: t.to(self.device), params)

    def _calls(self):
        """The context of every model call: no autograd, and the mesh the
        engine was built under (None: none), as JAX's engine re-activates
        its mesh around each trace."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        stack.enter_context(use_mesh(self.mesh))
        return stack

    # -- the model calls ----------------------------------------------------

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    def _task_ids(self, task_ids) -> Optional[torch.Tensor]:
        return None

    def _gates(self) -> Optional[torch.Tensor]:
        return None

    def prefill(self, tokens, cache_len: int, task_ids=None, last_pos=None):
        """(logits (B, 1, V), fresh caches of cache_len) for same-length
        prompts; last_pos picks the position whose logits return."""
        with self._calls():
            return M.prefill_lm(self.params, self.cfg, self._tokens(tokens),
                                cache_len, last_pos=last_pos,
                                task_ids=self._task_ids(task_ids),
                                gates=self._gates())

    def _positions(self, pos, span: int, L: Optional[int]) -> torch.Tensor:
        """pos (B,) on the device, refused unless every row's writes
        pos..pos+span-1 lie in [0, L) (L None: no KV length to bound)."""
        pos = np.asarray(pos.cpu() if isinstance(pos, torch.Tensor) else pos)
        if L is not None and pos.size and (pos.min() < 0
                                          or pos.max() + span > L):
            raise ValueError(f"write positions {pos} (+{span - 1}) outside "
                             f"the cache length {L}")
        return torch.as_tensor(pos, dtype=torch.long, device=self.device)

    def _slot_len(self, caches) -> Optional[int]:
        """The bound of a row's positions: the longest full-range
        attention cache (a ring takes any position; None where no layer
        bounds it)."""
        lens = [c["k"].shape[1] for c, s in zip(caches,
                                                 self.cfg.layer_slots())
                if "k" in c and s.window is None]
        return max(lens) if lens else None

    def decode_step(self, caches, tok, pos, task_ids=None):
        """One decode step for every row: tok (B, 1), pos (B,) per-row
        positions (bounded by the KV cache's length where the config has
        attention layers). Writes the caches in place; returns (logits,
        caches)."""
        pos = self._positions(pos, 1, self._slot_len(caches))
        with self._calls():
            return M.decode_lm(self.params, self.cfg, caches,
                               self._tokens(tok), pos,
                               task_ids=self._task_ids(task_ids),
                               gates=self._gates())

    def verify_step(self, caches, toks, pos, task_ids=None):
        """Speculative verify over the slot caches: toks (B, k+1) = [last
        accepted token, k drafts], pos (B,) the position of toks[:, 0],
        with pos + k inside the cache. Returns (logits (B, k+1, V),
        caches)."""
        toks = self._tokens(toks)
        pos = self._positions(pos, toks.shape[1], self._slot_len(caches))
        with self._calls():
            return M.verify_lm(self.params, self.cfg, caches, toks, pos,
                               task_ids=self._task_ids(task_ids),
                               gates=self._gates())

    def init_slot_caches(self, num_slots: int, cache_len: int):
        """Zeroed slot caches: row i is slot i's private cache region."""
        return M.init_decode_caches(self.cfg, num_slots, cache_len,
                                    self.device)

    # -- the paged block pool (serving/paged.py) ----------------------------

    def init_paged_pool(self, num_blocks: int, page: int,
                        kv_quant: Optional[str] = None):
        """Zeroed block pools on the device, one per layer (QTensor leaves
        under kv_quant); block 0 is the allocator's null block."""
        return M.init_paged_pool(self.cfg, num_blocks, page, kv_quant,
                                 self.device)

    def _tables(self, tables) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tables), dtype=torch.int32,
                               device=self.device)

    def paged_insert(self, pool, fresh, bids):
        """Write a fresh B = 1 prefill cache into pool blocks `bids`, page
        by page, through the decode write (`attention.write_pool`): each
        layer writes its own length L (the prefill's cache_len, or a
        windowed layer's ring, in ring order) into the first L // page
        entries of `bids`, as JAX's insert does; a quantized pool quantizes
        each token and head by the same rule. Returns the pool, written in
        place."""
        ids = self._tables(np.asarray(bids).reshape(1, -1))
        with self._calls():
            for layer, new in zip(pool, fresh):
                L = new["k"].shape[1]
                pos = torch.arange(L, device=self.device)[None]
                write_pool(layer, ids, pos, new["k"], new["v"])
        return pool

    def copy_block(self, pool, src: int, dst: int):
        """The copy-on-write fork: block src duplicated into dst on every
        leaf (payload and scales). Returns the pool, written in place."""
        with self._calls():
            for layer in pool:
                for leaf in layer.values():
                    for t in ((leaf.values, leaf.scales) if is_qtensor(leaf)
                              else (leaf,)):
                        t[dst].copy_(t[src])
        return pool

    def _pool_len(self, pool, tables) -> int:
        leaf = pool[0]["k"]
        page = (leaf.values if is_qtensor(leaf) else leaf).shape[1]
        return np.asarray(tables).shape[1] * page

    def paged_decode_step(self, pool, tok, pos, tables, task_ids=None):
        """One decode tick against the pool: tok (B, 1), pos (B,), tables
        the host's (num_slots, nb_max) int32 block tables. Returns
        (logits, pool)."""
        pos = self._positions(pos, 1, self._pool_len(pool, tables))
        with self._calls():
            return M.decode_lm_paged(self.params, self.cfg, pool,
                                     self._tokens(tok), pos,
                                     self._tables(tables),
                                     task_ids=self._task_ids(task_ids),
                                     gates=self._gates())

    def paged_verify_step(self, pool, toks, pos, tables, task_ids=None):
        """Speculative verify against the pool: toks (B, k+1), pos (B,);
        every page of pos..pos+k must be allocated. Returns (logits (B,
        k+1, V), pool)."""
        toks = self._tokens(toks)
        pos = self._positions(pos, toks.shape[1],
                              self._pool_len(pool, tables))
        with self._calls():
            return M.verify_lm_paged(self.params, self.cfg, pool, toks, pos,
                                     self._tables(tables),
                                     task_ids=self._task_ids(task_ids),
                                     gates=self._gates())

    def paged_extend(self, pool, tokens, tables, start: int, kv_len: int,
                     last_pos: int, task_ids=None):
        """Prefill a prompt suffix straight into pool blocks (a prefix-cache
        partial hit): tokens (1, S_pad) right-padded, `start` its offset,
        kv_len the true prompt length, last_pos the suffix index of the
        last real token. Returns (logits (1, 1, V), pool)."""
        toks = self._tokens(tokens)
        self._positions([start], toks.shape[1], self._pool_len(pool, tables))
        with self._calls():
            return M.extend_lm(self.params, self.cfg, pool, toks,
                               self._tables(tables), int(start), int(kv_len),
                               int(last_pos),
                               task_ids=self._task_ids(task_ids),
                               gates=self._gates())

    # -- lock-step generation -----------------------------------------------

    def generate(self, requests, max_new_tokens: Optional[int] = None, *,
                 top_k: int = 0, temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 task_ids=None):
        """JAX's unified generation entry point. Two input forms:

        * an int array (B, S) of same-length prompts and max_new_tokens:
          the lock-step batch. Returns (B, max_new_tokens) int64, every row
          decoded to the whole budget; greedy unless top_k > 0 and a
          `generator` (on the engine's device) is given; task_ids: each
          row's bank row (a MultiTaskEngine).
        * a list of `serving.Request`s (same-length prompts): each
          request's budget, sampling (top_k, temperature and a generator
          seeded by its seed, else its index, as the scheduler seeds one)
          and, on a MultiTaskEngine, its task_id or adapter name. Returns a
          list of token arrays, each cut at its own max_new_tokens and at
          its first EOS (inclusive) when eos_id is set. A call-level
          `generator` samples every row with `top_k` instead.

        Mixed prompt lengths, streaming and arrivals over time belong to
        the schedulers (`serving.make_scheduler`)."""
        if not isinstance(requests, (list, tuple)):
            if max_new_tokens is None:
                raise ValueError("array input requires max_new_tokens")
            check_temperature(temperature)
            return self._lockstep(np.asarray(requests), int(max_new_tokens),
                                  self._call_pick(top_k, temperature,
                                                  generator), task_ids)
        reqs = list(requests)
        if not reqs:
            return []
        for r in reqs:
            check_temperature(r.temperature)
        prompts = [np.asarray(r.prompt).reshape(-1) for r in reqs]
        if len({p.shape[0] for p in prompts}) != 1:
            raise ValueError(
                "generate(list[Request]) batches lock-step and needs "
                "same-length prompts; use serving.make_scheduler for "
                "heterogeneous lengths")
        tokens = np.stack(prompts)
        budget = max(r.max_new_tokens for r in reqs)
        if max_new_tokens is not None:
            budget = min(budget, int(max_new_tokens))
        return self._generate_rows(tokens, reqs, budget, generator, top_k)

    @staticmethod
    def _call_pick(top_k: int, temperature: float,
                   generator: Optional[torch.Generator]):
        """One sampling rule for every row: top-k from `generator`, or
        greedy."""
        if top_k and generator is not None:
            return lambda logits: sample_topk(logits, generator, top_k,
                                              temperature)
        return sample_greedy

    def _generate_rows(self, tokens, reqs, budget, generator, top_k):
        """The request-list path. One parameter tree: a request's task_id
        or adapter needs a MultiTaskEngine."""
        if any(r.task_id or r.adapter is not None for r in reqs):
            raise ValueError(
                "per-request task_id/adapter requires a MultiTaskEngine")
        return self._decode_rows(tokens, reqs, budget, generator, top_k)

    def _decode_rows(self, tokens, reqs, budget, generator, top_k,
                     task_ids=None):
        """Lock-step decode with each request's sampling, then each cut at
        its budget and EOS."""
        if generator is not None:  # call-level sampling
            out = self._lockstep(tokens, budget,
                                 self._call_pick(top_k, 1.0, generator),
                                 task_ids)
            return self._truncate(out, reqs)
        gens = [torch.Generator(device=self.device).manual_seed(
                    r.seed if r.seed is not None else i) if r.top_k else None
                for i, r in enumerate(reqs)]

        def pick(logits):
            toks = sample_greedy(logits)
            for i, r in enumerate(reqs):
                if r.top_k:  # the row's own generator, as the scheduler's
                    toks[i] = sample_topk(logits[i:i + 1], gens[i], r.top_k,
                                          r.temperature)[0]
            return toks

        return self._truncate(self._lockstep(tokens, budget, pick, task_ids),
                              reqs)

    @staticmethod
    def _truncate(out: np.ndarray, reqs) -> List[np.ndarray]:
        res = []
        for i, r in enumerate(reqs):
            row = np.asarray(out[i, :r.max_new_tokens])
            if r.eos_id is not None:
                hits = np.flatnonzero(row == r.eos_id)
                if hits.size:
                    row = row[:hits[0] + 1]
            res.append(row)
        return res

    def _lockstep(self, tokens: np.ndarray, max_new_tokens: int, pick,
                  task_ids=None) -> np.ndarray:
        """Prefill the (B, S) prompts, then decode every row together for
        max_new_tokens, `pick` choosing each step's tokens from the logits
        (the first one after the prefill included). Returns (B,
        max_new_tokens) int64."""
        B, S = tokens.shape
        cache_len = round_to_page(S + max_new_tokens)
        logits, caches = self.prefill(tokens, cache_len, task_ids=task_ids)
        tok = pick(logits)
        out = []
        for i in range(max_new_tokens):
            out.append(tok)
            logits, caches = self.decode_step(
                caches, tok[:, None], np.full((B,), S + i), task_ids=task_ids)
            tok = pick(logits)
        if not out:
            return np.zeros((B, 0), np.int64)
        return torch.stack(out, dim=1).cpu().numpy()


class MultiTaskEngine(ServeEngine):
    """One frozen backbone + a bank of per-task Hadamard adapters.

    tasks: either per-task parameter trees that share every non-adapter
    leaf (a static bank, built once: (T, d) rows per layer) or an
    `AdapterBank` (hot-swap: rows are loaded and evicted by name at run
    time through its registry). Every prefill and decode step takes
    per-row task ids (bank rows). Over an AdapterBank the engine adopts the
    bank's tree on its device (`AdapterBank.attach`), so a row written
    between steps is what the next step reads, and each step passes the
    bank's (L, size) row gates to the model. quant: as for `ServeEngine`,
    applied to the bank's tree; the adapter rows stay as they are."""

    def __init__(self, cfg: ModelCfg, tasks, *, quant: Optional[str] = None,
                 device=None):
        from repro_torch.serving.registry import AdapterBank

        self.adapter_bank = tasks if isinstance(tasks, AdapterBank) else None
        if self.adapter_bank is not None:
            tree, self.num_tasks = tasks.tree, tasks.size
        elif tasks:
            tree, self.num_tasks = build_bank(list(tasks)), len(tasks)
        else:
            raise ValueError("MultiTaskEngine needs at least one task")
        super().__init__(cfg, tree, quant=quant, device=device)
        if self.adapter_bank is not None:
            self.adapter_bank.attach(self.params)

    @property
    def bank(self) -> dict:
        """The bank tree the steps read (the AdapterBank's live tree)."""
        return self.params

    # -- adapter-name resolution (scheduler admission) ----------------------

    def has_adapter(self, name: str) -> bool:
        return (self.adapter_bank is not None
                and (self.adapter_bank.row_of(name) is not None
                     or name in self.adapter_bank.registry))

    def acquire_adapter(self, name: str) -> int:
        """name -> pinned bank row (loaded from the registry on a miss)."""
        if self.adapter_bank is None:
            raise ValueError(
                "engine has a static bank; named-adapter requests need an "
                "AdapterBank (MultiTaskEngine(cfg, AdapterBank(...)))")
        return self.adapter_bank.acquire(name)

    def release_adapter(self, name: str) -> None:
        if self.adapter_bank is not None:
            self.adapter_bank.release(name)

    def _gates(self) -> Optional[torch.Tensor]:
        return (None if self.adapter_bank is None
                else self.adapter_bank.gate_tensor)

    def _task_ids(self, task_ids) -> torch.Tensor:
        if task_ids is None:
            raise ValueError("MultiTaskEngine steps require task_ids")
        ids = np.asarray(task_ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_tasks):
            raise ValueError(f"task ids {ids} outside the bank's "
                             f"{self.num_tasks} rows")
        return torch.as_tensor(ids, dtype=torch.int32, device=self.device)

    # -- lock-step generation with per-request adapters ---------------------

    def _generate_rows(self, tokens, reqs, budget, generator, top_k):
        """The request-list path with per-request adapters: every name is
        resolved to a bank row up front (each unique name pinned once, so
        no row displaces another mid-batch), the batch runs with those rows
        as its task ids, and the pins are released in finally: a
        BankFullError or KeyError halfway must not leak pins."""
        uniq = list(dict.fromkeys(
            r.adapter for r in reqs if r.adapter is not None))
        if uniq and self.adapter_bank is None:
            raise ValueError(
                "named-adapter requests need an AdapterBank "
                "(MultiTaskEngine(cfg, AdapterBank(...)))")
        acquired = []
        try:
            for n in uniq:
                self.adapter_bank.acquire(n)
                acquired.append(n)
            rows = [self.adapter_bank.row_of(r.adapter)
                    if r.adapter is not None else r.task_id for r in reqs]
            return self._decode_rows(tokens, reqs, budget, generator, top_k,
                                     task_ids=rows)
        finally:
            for n in acquired:
                self.adapter_bank.release(n)

    # -- deprecated entry points (use generate(list[Request])) --------------

    def generate_for_tasks(self, tokens, task_ids, max_new_tokens: int, *,
                           top_k: int = 0,
                           generator: Optional[torch.Generator] = None):
        """Deprecated, as in JAX: `generate(list[Request])` with each
        request's task_id does the same. Returns the (B, max_new_tokens)
        array of the lock-step batch over rows `task_ids`."""
        warnings.warn(
            "generate_for_tasks is deprecated; use MultiTaskEngine."
            "generate([Request(..., task_id=...)], ...) instead",
            DeprecationWarning, stacklevel=2)
        return self.generate(tokens, max_new_tokens, top_k=top_k,
                             generator=generator, task_ids=task_ids)

    def generate_for_adapters(self, tokens, names, max_new_tokens: int, *,
                              top_k: int = 0,
                              generator: Optional[torch.Generator] = None):
        """Deprecated, as in JAX: `generate(list[Request])` with each
        request's adapter name does the same (the same pin-once, release
        discipline). Returns the stacked (B, max_new_tokens) tokens."""
        warnings.warn(
            "generate_for_adapters is deprecated; use MultiTaskEngine."
            "generate([Request(..., adapter=...)], ...) instead",
            DeprecationWarning, stacklevel=2)
        if self.adapter_bank is None:
            raise ValueError("generate_for_adapters needs an AdapterBank")
        from repro_torch.serving.scheduler import Request

        tokens = np.asarray(tokens)
        reqs = [Request(prompt=tokens[i], max_new_tokens=int(max_new_tokens),
                        adapter=n) for i, n in enumerate(names)]
        return np.stack(self._generate_rows(tokens, reqs,
                                            int(max_new_tokens), generator,
                                            top_k), axis=0)
