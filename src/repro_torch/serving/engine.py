"""Serving engines (port of `repro.serving.engine`): prefill and per-row
decode over slot caches, lock-step generation, and multi-task Hadamard
serving over a static adapter bank.

`ServeEngine` serves one adapter; every block runs the fused
adapter-residual-norm kernel. `MultiTaskEngine` serves a bank of T tasks'
adapters over one frozen backbone: requests carrying different task ids
share every decode tick, and each block reads each row's adapter out of
the bank inside the multitask kernel. The hot-swap `AdapterBank`, folding,
the paged pool and speculative decoding arrive with later slices.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.common import tree as tu
from repro_torch.common.device import resolve_device
from repro_torch.common.types import ModelCfg
from repro_torch.core.hadamard import build_bank
from repro_torch.models import model as M
from repro_torch.models.attention import DECODE_PAGE


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
    """

    def __init__(self, cfg: ModelCfg, params: dict, *, fold: bool = False,
                 device=None):
        if fold:
            raise NotImplementedError(
                "fold=True removes the adapter op, and with it the fused "
                "adapter-residual-norm kernel; folding arrives with a later "
                "slice")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tu.map_with_path(lambda _, t: t.to(self.device), params)

    # -- the model calls ----------------------------------------------------

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    def _task_ids(self, task_ids) -> Optional[torch.Tensor]:
        return None

    def prefill(self, tokens, cache_len: int, task_ids=None, last_pos=None):
        """(logits (B, 1, V), fresh caches of cache_len) for same-length
        prompts; last_pos picks the position whose logits return."""
        with torch.no_grad():
            return M.prefill_lm(self.params, self.cfg, self._tokens(tokens),
                                cache_len, last_pos=last_pos,
                                task_ids=self._task_ids(task_ids))

    def decode_step(self, caches, tok, pos, task_ids=None):
        """One decode step for every row: tok (B, 1), pos (B,) per-row
        positions. Writes the caches in place; returns (logits, caches)."""
        pos = np.asarray(pos)
        L = caches[0]["k"].shape[1]
        if pos.size and (pos.min() < 0 or pos.max() >= L):
            raise ValueError(f"decode positions {pos} outside the cache "
                             f"length {L}")
        with torch.no_grad():
            return M.decode_lm(self.params, self.cfg, caches,
                               self._tokens(tok),
                               torch.as_tensor(pos, device=self.device),
                               task_ids=self._task_ids(task_ids))

    def init_slot_caches(self, num_slots: int, cache_len: int):
        """Zeroed slot caches: row i is slot i's private cache region."""
        return M.init_decode_caches(self.cfg, num_slots, cache_len,
                                    self.device)

    # -- lock-step generation -----------------------------------------------

    def generate(self, tokens, max_new_tokens: int, *, top_k: int = 0,
                 temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 task_ids=None) -> np.ndarray:
        """Lock-step batch: same-length prompts (B, S) decode together for
        max_new_tokens. Greedy unless top_k > 0 and a generator (on the
        engine's device) is given. Returns (B, max_new_tokens) int64."""
        check_temperature(temperature)
        tokens = np.asarray(tokens)
        B, S = tokens.shape
        cache_len = round_to_page(S + max_new_tokens)

        def pick(logits):
            if top_k and generator is not None:
                return sample_topk(logits, generator, top_k, temperature)
            return sample_greedy(logits)

        logits, caches = self.prefill(tokens, cache_len, task_ids=task_ids)
        tok = pick(logits)
        out = []
        for i in range(max_new_tokens):
            out.append(tok)
            logits, caches = self.decode_step(
                caches, tok[:, None], np.full((B,), S + i), task_ids=task_ids)
            tok = pick(logits)
        return torch.stack(out, dim=1).cpu().numpy()


class MultiTaskEngine(ServeEngine):
    """One frozen backbone + a static bank of per-task Hadamard adapters.

    tasks: per-task parameter trees that share every non-adapter leaf; the
    bank stacks their adapters into (T, d) rows per layer. Every prefill
    and decode step takes per-row task ids (bank rows)."""

    def __init__(self, cfg: ModelCfg, tasks: List[dict], *, device=None):
        if not tasks:
            raise ValueError("MultiTaskEngine needs at least one task")
        super().__init__(cfg, build_bank(list(tasks)), device=device)
        self.num_tasks = len(tasks)

    def _task_ids(self, task_ids) -> torch.Tensor:
        if task_ids is None:
            raise ValueError("MultiTaskEngine steps require task_ids")
        ids = np.asarray(task_ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_tasks):
            raise ValueError(f"task ids {ids} outside the bank's "
                             f"{self.num_tasks} rows")
        return torch.as_tensor(ids, dtype=torch.int32, device=self.device)
