"""Hadamard-adapter operations a deployment needs (port of
`repro.core.hadamard`): task deltas, static and hot-swap multi-task banks,
and synthetic task variants.

Everything here works in the port's per-layer layout: a layer's adapter
leaves are (d,) tensors, and a bank's are (T, d) rows per layer (JAX
stacks the layers, (L, d) and (L, T, d)). `convert.stack_delta` carries a
per-layer delta into the JAX layout that the registry stores.

`select_tasks` is the clamping gather of the JAX serving tick. The bank
stays stacked on the serving path, where the multitask kernels read each
request's row straight out of it; the gather serves the placements those
kernels do not cover. `fold_adapter` folds one adapter into W_O (and b_O)
and resets it to the identity, as JAX's does.
"""
from __future__ import annotations

import re
import zlib
from typing import Dict, List

import numpy as np
import torch

from repro_torch.common import tree as tu
from repro_torch.common.types import ModelCfg

ADAPTER_RE = re.compile(r"/adapter/")
DELTA_PATTERNS = (r"/adapter/", r"/ffn_norm/", r"^pooler/", r"^classifier/")
SHARED_W_RE = re.compile(r"/adapter/w$")


def _is_adapter(path: str) -> bool:
    return ADAPTER_RE.search("/" + path) is not None


def extract_delta(params: dict) -> dict:
    """The task-specific leaves (adapter, tuned norms, head): KB-sized. A
    tree of `params`' structure with None in place of every other leaf."""
    delta, _ = tu.partition(params, tu.mask_from_patterns(params,
                                                          DELTA_PATTERNS))
    return delta


def apply_delta(params: dict, delta: dict) -> dict:
    """Overlay a task delta onto (shared, frozen) backbone params, by
    path: a None in the delta keeps the backbone's leaf."""
    flat = dict(tu.flatten_with_paths(delta))

    def pick(path, leaf):
        d = flat.get(path)
        return leaf if d is None else d

    return tu.map_with_path(pick, params)


# ---------------------------------------------------------------------------
# Folding
# ---------------------------------------------------------------------------


def fold_adapter(params: dict, cfg: ModelCfg) -> dict:
    """Fold each attention layer's Hadamard adapter into its out-projection
    in fp32, as `repro.core.hadamard.fold_adapter` does:

      attn_concat:  (c*w + b) @ Wo + bo = c @ (w[:, None]*Wo) + (b@Wo + bo)
      attn_out:     (c @ Wo + bo)*w + b = c @ (Wo*w[None, :]) + (bo*w + b)

    W_O keeps its dtype, b_O becomes (or is made) fp32, and the adapter is
    reset to the identity (w = 1, b = 0). The folded model still runs its
    adapter op, now the identity (#3, or #1 under post-norms), as the JAX
    model does. A layer without "attn" (RWKV6) or without a Hadamard "w"
    is returned as it is. Returns new params; `params` is not changed."""
    concat = cfg.adapter.position == "attn_concat"

    def fold_block(block: dict) -> dict:
        ad = block.get("adapter")
        if ad is None or "attn" not in block or "w" not in ad:
            return block
        attn = dict(block["attn"])
        wo = attn["wo"]
        w, b = ad["w"].float(), ad["b"].float()
        wo32 = wo.float()
        if concat:
            new_wo = wo32 * w[:, None]
            extra_bias = b @ wo32
        else:
            new_wo = wo32 * w[None, :]
            extra_bias = b
        bo = attn.get("bo")
        bo = (torch.zeros(new_wo.shape[-1], dtype=torch.float32,
                          device=wo.device) if bo is None else bo.float())
        attn["wo"] = new_wo.to(wo.dtype)
        attn["bo"] = (bo if concat else bo * w) + extra_bias
        return {**block, "attn": attn,
                "adapter": {"w": torch.ones_like(ad["w"]),
                            "b": torch.zeros_like(ad["b"])}}

    return {**params, "layers": [fold_block(b) for b in params["layers"]]}


# ---------------------------------------------------------------------------
# Multi-task banks
# ---------------------------------------------------------------------------


def build_bank(param_list: List[dict]) -> dict:
    """Stack T tasks' params into a bank: each layer's adapter leaves
    (d,) -> (T, d). Every other leaf must be shared and is taken from
    task 0."""
    flat = [dict(tu.flatten_with_paths(p)) for p in param_list]

    def stack(path, leaf):
        if _is_adapter(path):
            return torch.stack([f[path] for f in flat], dim=-2)
        return leaf

    return tu.map_with_path(stack, param_list[0])


def select_rows(leaf: torch.Tensor, task_ids: torch.Tensor) -> torch.Tensor:
    """Rows of one bank leaf (T, d) for per-request task ids (B,) -> (B, d),
    each id clamped into [0, T): a shared-w leaf (one row) gives that row
    to every request, as JAX's `select_tasks` gathers it."""
    return leaf[task_ids.long().clamp(0, leaf.shape[-2] - 1)]


def select_tasks(bank_params: dict, task_ids: torch.Tensor) -> dict:
    """Resolve a bank into per-request adapters: each layer's (T, d)
    adapter leaves -> (B, d), through the clamping gather `select_rows`."""
    def sel(path, v):
        return select_rows(v, task_ids) if _is_adapter(path) else v

    return tu.map_with_path(sel, bank_params)


def init_bank(params: dict, size: int, shared_w: bool = False) -> dict:
    """Tile one param tree into a `size`-row bank: each layer's adapter
    leaves (d,) -> (size, d), every row a copy of `params`' adapter.
    shared_w=True: the w leaves get ONE row (1, d), `params`' w being the
    shared weight of every tenant, while b keeps `size` rows. Non-adapter
    leaves are shared. The tensors are new; `params` is not touched."""
    def one(path, leaf):
        if _is_adapter(path):
            n = 1 if shared_w and SHARED_W_RE.search(path) else size
            return leaf.unsqueeze(-2).repeat_interleave(n, dim=-2).contiguous()
        return leaf

    return tu.map_with_path(one, params)


def adapter_row(tree: dict) -> dict:
    """A delta or param tree filtered down to its Hadamard adapter leaves,
    the leaves a bank row stores; every other leaf becomes None."""
    row, _ = tu.partition(tree, tu.mask_from_patterns(
        tree, (ADAPTER_RE.pattern,), path_of=lambda p: "/" + p))
    return row


def validate_adapter_row(bank: dict, row: dict, *,
                         shared_w: bool = False) -> None:
    """Check a row tree against a bank before it is written: every adapter
    leaf of the bank must be in the row with the bank's per-row shape (bank
    (..., T, d) -> row (..., d)) and a float dtype. Raises ValueError
    naming every mismatch. The check reads shapes only, so it holds for a
    per-layer bank (T, d) with (d,) rows and for the JAX layout alike.

    shared_w: the bank stores one shared w row, so the row may omit its w
    leaves (and those it carries are checked but never written; see
    `insert_bank_row(skip=...)`)."""
    flat_row = {p: v for p, v in tu.flatten_with_paths(row) if v is not None}
    problems = []
    for path, leaf in tu.flatten_with_paths(bank):
        if leaf is None or not _is_adapter(path):
            continue
        r = flat_row.pop(path, None)
        want = tuple(leaf.shape[:-2]) + tuple(leaf.shape[-1:])
        if r is None:
            if shared_w and SHARED_W_RE.search(path):
                continue
            problems.append(f"missing adapter leaf {path} (want {want})")
        elif tuple(r.shape) != want:
            problems.append(
                f"{path}: row shape {tuple(r.shape)} != bank row {want}")
        elif not torch.as_tensor(r).is_floating_point():
            problems.append(f"{path}: non-float dtype {r.dtype}")
    problems += [f"unknown adapter leaf {p}" for p in flat_row
                 if _is_adapter(p)]
    if problems:
        raise ValueError("adapter row does not fit bank:\n  "
                         + "\n  ".join(problems))


def insert_bank_row(bank: dict, row: dict, idx: int, skip=None) -> dict:
    """Write one task's adapters into bank row `idx`, in place: each bank
    adapter leaf (T, d) gets the row's (d,) leaf at T=idx, cast to the
    bank's dtype and device; everything else is untouched. The bank keeps
    its tensors, so the engine that reads them sees the new row at once.
    Returns the bank.

    skip: an optional regex; matching paths are never written. Shared-w
    banks pass SHARED_W_RE, so one tenant's delta never overwrites the
    single shared w row."""
    flat_row = dict(tu.flatten_with_paths(row))
    for path, leaf in tu.flatten_with_paths(bank):
        r = flat_row.get(path)
        if r is None or leaf is None or not _is_adapter(path):
            continue
        if skip is not None and skip.search(path):
            continue
        leaf.select(-2, idx).copy_(torch.as_tensor(r))
    return bank


def extract_bank_row(bank: dict, idx: int) -> dict:
    """Row `idx` of a bank as an adapter-only row tree ((T, d) -> (d,)
    copies); the inverse of `insert_bank_row` for one row."""
    def one(path, leaf):
        if leaf is not None and _is_adapter(path):
            return leaf.select(-2, idx).clone()
        return None

    return tu.map_with_path(one, bank)


def perturb_adapters(params: dict, seed: int, scale: float = 0.05,
                     leaves=("w", "b")) -> dict:
    """A synthetic 'fine-tuned' task variant: every Hadamard adapter leaf
    shifted by scale * N(0, 1). Each leaf draws from its own CPU generator
    seeded by (seed, crc32 of its path), so a variant is the same on every
    device. `leaves` picks the components moved: ("b",) builds the
    shared-w/per-task-b world of paper Fig 5 (move w once for all tasks,
    then b per task). Returns a new tree; `params` is not modified."""
    pat = re.compile(r"/adapter/(%s)$" % "|".join(leaves))

    def one(path, leaf):
        if not pat.search("/" + path):
            return leaf
        g = torch.Generator().manual_seed(
            (int(seed) * 1_000_003 + zlib.crc32(path.encode())) % (1 << 63))
        noise = torch.randn(leaf.shape, generator=g, dtype=torch.float32)
        return (leaf.float() + scale * noise.to(leaf.device)).to(leaf.dtype)

    return tu.map_with_path(one, params)


def adapter_vectors(params: dict, cfg: ModelCfg) -> Dict[str, np.ndarray]:
    """Every layer's (w, b) as (n_layers, d) fp32 arrays in layer order
    (the port's layer list is in JAX's global layer order)."""
    del cfg  # the layer list is already in order
    ws, bs = [], []
    for layer in params["layers"]:
        ad = layer.get("adapter")
        if ad is None or "w" not in ad:
            continue
        ws.append(ad["w"].detach().float().cpu().numpy())
        bs.append(ad["b"].detach().float().cpu().numpy())
    return {"w": np.stack(ws), "b": np.stack(bs)}
