"""Shared-`w` / per-task-`b` factorization of the adapter bank (port of
`repro.sparse.shared`).

Paper Fig 5: the learned `w` vectors are nearly the same across tasks
while `b` is task-specific. `factorize` averages w across tasks per leaf
and keeps each task's b; `shared_w_overlay` burns the shared w into the
base params, and `serving.AdapterBank(shared_w=True)` built from them
stores ONE w row per layer while each tenant's insert writes only its b
rows: T tenants cost (T+1) row-sets instead of 2T.

`SharedAdapter`'s trees are deltas in the JAX layout (`convert.stack_delta`),
the layout the checkpoint store and the registry keep, so `save_shared`
writes the bytes JAX writes. `shared_w_overlay` takes the config to give
the stacked rows back to the port's per-layer params.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.common.types import ModelCfg
from repro_torch.sparse import importance as imp
from repro_torch.sparse import prune

_W_RE = re.compile(r"/adapter/w$")
_B_RE = re.compile(r"/adapter/b$")


@dataclass
class SharedAdapter:
    """w: a JAX-layout delta holding only /adapter/w leaves (dense or
    PackedRows); b: task name -> one holding only /adapter/b leaves; mask:
    the (L,) layer mask both were packed under (None = dense)."""

    w: dict
    b: Dict[str, dict] = field(default_factory=dict)
    mask: Optional[np.ndarray] = None

    @property
    def tasks(self):
        return sorted(self.b)

    def bytes_w(self) -> int:
        return prune.packed_bytes(self.w)

    def bytes_b(self, task: str) -> int:
        return prune.packed_bytes(self.b[task])


def _keep(tree: dict, regex: re.Pattern) -> dict:
    """The tree with only the leaves whose path matches; the rest None."""
    sel, _ = tu.partition(tree, tu.mask_from_patterns(
        tree, (regex.pattern,), path_of=lambda p: "/" + p))
    return sel


def _stacked(delta: dict, cfg: ModelCfg) -> dict:
    """A dense JAX-layout copy of a delta of either layout."""
    return prune.unpack_delta(convert.stack_delta(delta, cfg))


def factorize(task_deltas: Dict[str, dict], cfg: ModelCfg,
              mask: Optional[np.ndarray] = None) -> SharedAdapter:
    """Average `w` across tasks per leaf (fp32, numpy's mean on the host,
    as JAX computes it) and keep each task's `b`. With a layer mask both
    sides are packed."""
    if not task_deltas:
        raise ValueError("need at least one task delta")
    names = sorted(task_deltas)
    task_deltas = {t: _stacked(d, cfg) for t, d in task_deltas.items()}
    flat = [dict(tu.flatten_with_paths(_keep(task_deltas[t], _W_RE)))
            for t in names]
    mean_w = {
        p: torch.from_numpy(np.mean(
            [f[p].to(torch.float32).cpu().numpy() for f in flat], axis=0))
        for p in flat[0] if flat[0][p] is not None
    }
    shared_w = tu.map_with_path(lambda p, v: mean_w.get(p, v),
                                _keep(task_deltas[names[0]], _W_RE))
    b = {t: _keep(task_deltas[t], _B_RE) for t in names}
    if mask is not None:
        shared_w = prune.prune_delta(shared_w, cfg, mask)
        b = {t: prune.prune_delta(v, cfg, mask) for t, v in b.items()}
    return SharedAdapter(w=shared_w, b=b, mask=None if mask is None
                         else np.asarray(mask, bool))


def from_vectors(shared_w: np.ndarray, per_task_b: Dict[str, np.ndarray],
                 template: dict, cfg: ModelCfg,
                 mask: Optional[np.ndarray] = None) -> SharedAdapter:
    """A SharedAdapter from (L, d) layer-ordered arrays (a shared w and
    per-task b), scattered into the adapter leaves of `template` (any
    tree with the model's adapter leaves, in either layout)."""
    template = convert.stack_delta(template, cfg)

    def scatter(arr):
        def one(path: str, v):
            ids = imp.leaf_layer_ids(cfg, path)
            if ids is None or v is None:
                return v
            return torch.as_tensor(np.asarray(arr[ids], np.float32))
        return one

    sa = SharedAdapter(
        w=tu.map_with_path(scatter(shared_w), _keep(template, _W_RE)),
        b={t: tu.map_with_path(scatter(vec), _keep(template, _B_RE))
           for t, vec in per_task_b.items()})
    if mask is not None:
        sa.w = prune.prune_delta(sa.w, cfg, mask)
        sa.b = {t: prune.prune_delta(v, cfg, mask) for t, v in sa.b.items()}
        sa.mask = np.asarray(mask, bool)
    return sa


def _nest(flat: Dict[str, object]) -> dict:
    root: dict = {}
    for path, v in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def task_row(shared: SharedAdapter, task: str) -> dict:
    """One tenant's dense row tree in the JAX layout (shared w + its own
    b), merged by path: what a tenant of a shared-w bank publishes."""
    flat = {p: v for tree in (prune.unpack_delta(shared.w),
                              prune.unpack_delta(shared.b[task]))
            for p, v in tu.flatten_with_paths(tree) if v is not None}
    return _nest(flat)


def shared_w_overlay(base_params: dict, shared: SharedAdapter,
                     cfg: ModelCfg) -> dict:
    """Per-layer base params with the shared `w` overlaid onto every
    adapter w leaf (b untouched, in the base's dtype and device): the
    tree a shared-w `AdapterBank` is built from."""
    w_tree = convert.unstack_delta(prune.unpack_delta(shared.w), cfg)
    w_leaves = {p: v for p, v in tu.flatten_with_paths(w_tree)
                if v is not None}

    def one(path: str, v):
        w = w_leaves.get(path)
        return v if w is None else w.to(dtype=v.dtype, device=v.device)

    return tu.map_with_path(one, base_params)


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------


def save_shared(path: str, shared: SharedAdapter) -> None:
    from repro_torch.checkpoint.store import save_tree

    save_tree(path, {"w": shared.w, "b": shared.b},
              metadata={
                  "kind": "shared_adapter",
                  "tasks": shared.tasks,
                  "mask": None if shared.mask is None
                  else [bool(x) for x in shared.mask],
              })


def load_shared(path: str) -> SharedAdapter:
    from repro_torch.checkpoint.store import load_tree

    tree, meta = load_tree(path)
    if meta.get("kind") != "shared_adapter":
        raise ValueError(f"{path} is not a shared-adapter artifact")
    mask = meta.get("mask")
    return SharedAdapter(w=tree["w"], b=tree.get("b", {}),
                         mask=None if mask is None else np.asarray(mask, bool))


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------


def bank_bytes_report(cfg: ModelCfg, template: dict, n_tasks: int,
                      mask: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Adapter-bank bytes for T tenants: dense (T full (w, b) row-sets)
    against shared-w (one w row-set + T b row-sets), optionally packed.
    `marginal_*` is the cost of one more tenant."""
    del cfg  # the byte counts need no layer layout
    w_b = prune.packed_bytes(_keep(template, _W_RE))
    b_b = prune.packed_bytes(_keep(template, _B_RE))
    if mask is not None:
        frac = float(np.asarray(mask, bool).mean())
        w_b, b_b = w_b * frac, b_b * frac
    dense_total = n_tasks * (w_b + b_b)
    shared_total = w_b + n_tasks * b_b
    return {
        "tenants": n_tasks,
        "dense_total": dense_total,
        "shared_total": shared_total,
        "total_reduction": dense_total / max(shared_total, 1),
        "marginal_dense": w_b + b_b,
        "marginal_shared": b_b,
        "marginal_reduction": (w_b + b_b) / max(b_b, 1),
    }
