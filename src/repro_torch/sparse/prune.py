"""Packed sparse adapters (port of `repro.sparse.prune`).

A stacked adapter leaf (repeats, d) with `keep` (repeats,) becomes a
`PackedRows`: the bool mask plus ONLY the kept rows, with the identity fill
value (1.0 for w, 0.0 for b) recorded so `unpack_leaf(pack_leaf(x)) ==
apply_layer_mask(x)` exactly. A sparse DELTA is a task delta in the JAX
layout (`convert.stack_delta`) whose adapter leaves are PackedRows: the
mask spans a whole stacked leaf, so packing happens on the JAX layout, and
a per-layer delta handed to `pack_delta`/`prune_delta` is stacked first.
The checkpoint store writes PackedRows natively, the registry publishes
them, and `serving.AdapterBank` unpacks them at insert into identity-filled
dense rows, so the device bank keeps its shape.

Rows are always fp32: quantization never touches the adapters, and
`PackedRows` refuses anything narrower.

The paper's 0.022 % variant (keep the top 2/3 of layers, Table 5's
saturation point) ships as the "paper-0.022" preset; `search_mask` finds a
mask greedily under a quality budget.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.common.types import ModelCfg
from repro_torch.core import peft
from repro_torch.sparse import importance as imp

_ADAPTER_LEAF = r"/adapter/(w|b)$"


class PackedRows:
    """Bool mask + kept rows of one stacked adapter leaf, host tensors. A
    tree leaf of its own: tree maps carry it whole, with its path."""

    __slots__ = ("mask", "rows", "fill")

    def __init__(self, mask, rows, fill: float):
        mask = (mask if torch.is_tensor(mask) else torch.from_numpy(
            np.array(mask, bool))).to(device="cpu", dtype=torch.bool)
        rows = rows if torch.is_tensor(rows) else torch.from_numpy(
            np.array(rows))
        if mask.dim() != 1:
            raise ValueError(f"mask must be 1-D, got {tuple(mask.shape)}")
        if tuple(rows.shape[:1]) != (int(mask.sum()),):
            raise ValueError(f"rows {tuple(rows.shape)} does not hold "
                             f"{int(mask.sum())} kept rows")
        if not rows.is_floating_point() or rows.element_size() < 4:
            raise ValueError(
                f"sparse adapter rows must stay fp32, got {rows.dtype} "
                "(quantized/int rows would corrupt the serving bank)")
        self.mask = mask
        self.rows = rows.detach().to(device="cpu", dtype=torch.float32)
        self.fill = float(fill)

    @property
    def shape(self) -> Tuple[int, ...]:
        """Dense shape this leaf unpacks to."""
        return (self.mask.shape[0],) + tuple(self.rows.shape[1:])

    @property
    def nbytes(self) -> int:
        return self.rows.nbytes + self.mask.nbytes

    def __repr__(self):
        return (f"PackedRows(kept={int(self.mask.sum())}/"
                f"{self.mask.shape[0]}, d={tuple(self.rows.shape[1:])}, "
                f"fill={self.fill})")


def is_packed(v) -> bool:
    return isinstance(v, PackedRows)


def pack_leaf(leaf, keep, fill: float) -> PackedRows:
    """(repeats, ...) dense leaf + (repeats,) keep mask -> PackedRows.
    Exact round trip when the dropped rows already hold the identity."""
    leaf = leaf if torch.is_tensor(leaf) else torch.from_numpy(np.array(leaf))
    keep = torch.from_numpy(np.array(keep, bool))
    if tuple(keep.shape) != tuple(leaf.shape[:1]):
        raise ValueError(f"keep {tuple(keep.shape)} != leading dim of "
                         f"{tuple(leaf.shape)}")
    return PackedRows(keep, leaf.detach().cpu()[keep], fill)


def unpack_leaf(pr: PackedRows, dtype=torch.float32) -> torch.Tensor:
    """Inverse of pack_leaf: identity fill at dropped rows."""
    out = torch.full(pr.shape, pr.fill, dtype=dtype)
    out[pr.mask] = pr.rows.to(dtype)
    return out


def _leaf_fill(path: str) -> float:
    return 1.0 if path.endswith("/w") else 0.0


def pack_delta(delta: dict, cfg: ModelCfg, mask) -> dict:
    """Task delta -> sparse delta in the JAX layout: the adapter leaves
    become PackedRows keeping only the layers `mask` marks active; other
    delta leaves (tuned norms, heads) stay dense."""
    mask = np.asarray(mask, bool)

    def one(path: str, v):
        if v is None or is_packed(v) \
                or not re.search(_ADAPTER_LEAF, "/" + path):
            return v
        ids = imp.leaf_layer_ids(cfg, path)
        if ids is None:
            return v
        return pack_leaf(v, mask[ids], _leaf_fill(path))

    return tu.map_with_path(one, convert.stack_delta(delta, cfg))


def unpack_delta(delta: dict) -> dict:
    """Sparse delta -> dense delta (identity rows at pruned layers); a
    dense delta passes through unchanged."""
    return tu.map_with_path(
        lambda _, v: unpack_leaf(v) if is_packed(v) else v, delta)


def prune_delta(delta: dict, cfg: ModelCfg, mask) -> dict:
    """apply_layer_mask + pack in one step, the exact-round-trip form:
    unpack(prune_delta(x)) == apply_layer_mask(x). A packed delta is
    unpacked first, so the new mask wins."""
    delta = unpack_delta(convert.stack_delta(delta, cfg))
    return pack_delta(imp.apply_layer_mask(delta, cfg, mask), cfg, mask)


def delta_mask(delta: dict, cfg: ModelCfg) -> np.ndarray:
    """(L,) active-layer mask of a (possibly sparse) delta in either
    layout: a layer is active if ANY of its adapter leaves keeps a row
    there. This is the mask the bank pins per row."""
    mask = np.zeros((imp.n_layers(cfg),), bool)
    for path, v in tu.flatten_with_paths(delta):
        if v is None or not re.search(_ADAPTER_LEAF, "/" + path):
            continue
        ids = imp.leaf_layer_ids(cfg, path)
        if ids is None:
            continue
        mask[ids] |= v.mask.numpy() if is_packed(v) else True
    return mask


def packed_bytes(delta: dict) -> int:
    """Host bytes of a (possibly sparse) delta's adapter leaves."""
    total = 0
    for path, v in tu.flatten_with_paths(delta):
        if v is None or not re.search(_ADAPTER_LEAF, "/" + path):
            continue
        total += v.nbytes
    return total


# ---------------------------------------------------------------------------
# Presets and parameter accounting
# ---------------------------------------------------------------------------

# paper Table 5: quality saturates past ~2/3 of depth; keeping the top 2/3
# of layers is the published 0.022 % variant (8/12 on BERT-base)
PRESETS: Dict[str, Callable[[ModelCfg], np.ndarray]] = {
    "paper-0.022": lambda cfg: imp.depth_mask(
        cfg, max(1, (2 * imp.n_layers(cfg)) // 3)),
}


def preset_mask(cfg: ModelCfg, name: str = "paper-0.022") -> np.ndarray:
    try:
        return PRESETS[name](cfg)
    except KeyError:
        raise KeyError(f"unknown prune preset {name!r} "
                       f"(known: {sorted(PRESETS)})") from None


def search_mask(scores: np.ndarray,
                eval_fn: Callable[[np.ndarray], float],
                *, budget: float, min_layers: int = 1,
                ) -> Tuple[np.ndarray, List[dict]]:
    """Greedy quality-budgeted pruning: drop layers in ascending
    importance order while `eval_fn(mask)` stays within `budget` of the
    all-layers quality. Returns (mask, history), history one dict per
    probe (mask, quality, kept, accepted).

    eval_fn takes a candidate (L,) mask and returns quality (higher is
    better): a gated fine-tune and evaluation, or for post-training
    pruning `evaluate` of `importance.apply_layer_mask(params, cfg, m)`."""
    scores = np.asarray(scores, np.float64)
    L = scores.shape[0]
    if not 1 <= min_layers <= L:
        raise ValueError(f"min_layers must be in [1, {L}]")
    mask = np.ones((L,), bool)
    base = float(eval_fn(mask))
    history = [{"mask": mask.copy(), "quality": base, "kept": L,
                "accepted": True}]
    # ties broken toward dropping SHALLOW layers first (paper Fig 4)
    for l in np.argsort(scores + np.arange(L) * 1e-12):
        if mask.sum() <= min_layers:
            break
        cand = mask.copy()
        cand[l] = False
        q = float(eval_fn(cand))
        ok = q >= base - budget
        history.append({"mask": cand.copy(), "quality": q,
                        "kept": int(cand.sum()), "accepted": ok})
        if ok:
            mask = cand
    return mask, history


def sparse_param_stats(params: dict, cfg: ModelCfg, mask,
                       strategy_name: str = "hadamard") -> Dict[str, float]:
    """Trainable-parameter accounting under a layer mask: the pruned
    count and percent beside the dense ones (the paper's 0.033 % ->
    0.022 % line)."""
    strat = peft.strategy(strategy_name)
    tmask = peft.trainable_mask(params, strat, cfg=cfg)
    dense = peft.param_stats(params, tmask)
    n = imp.gated_param_count(params, tmask, imp.mask_gate(params, cfg, mask))
    return {
        "total": dense["total"],
        "dense_trainable": dense["trainable"],
        "dense_percent": dense["percent"],
        "pruned_trainable": n,
        "pruned_percent": 100.0 * n / max(dense["total"], 1),
        "kept_layers": int(np.asarray(mask, bool).sum()),
        "n_layers": imp.n_layers(cfg),
    }
