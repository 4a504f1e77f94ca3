"""Per-layer adapter importance and layer masks (port of
`repro.sparse.importance`).

A Hadamard adapter layer is exactly redundant when its affine is the
identity (w=1, b=0). A layer MASK is a host-side (n_layers,) bool numpy
array in global layer order: groups in config order, repeats within a
group, slots within a repeat, which is the order of the port's layer list.

Every function here takes a leaf's layer from its path through
`leaf_layer_ids`, which reads both layouts: the port's per-layer leaves
('layers/<i>/...') and the JAX layout's stacked leaves
('blocks/g<G>/slot<S>/...', one row per repeat) that deltas and the
registry use. `ablation_importance` scores each layer by the quality lost
when its adapter alone is reset to the identity, through the caller's
eval loop.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.common import tree as tu
from repro_torch.common.types import ModelCfg
from repro_torch.core.hadamard import adapter_vectors

_STACKED_RE = re.compile(r"blocks/g(\d+)/slot(\d+)/")
_LAYER_RE = re.compile(r"^layers/(\d+)/")
_GATED_RE = re.compile(r"/(adapter|ffn_norm)/")


def n_layers(cfg: ModelCfg) -> int:
    return sum(g.n_layers for g in cfg.groups)


def leaf_layer_ids(cfg: ModelCfg, path: str) -> Optional[np.ndarray]:
    """Global layer ids of a leaf: (1,) for a port layer leaf, (repeats,)
    for a stacked JAX-layout group leaf, None for non-block leaves
    (embeddings, heads)."""
    m = _LAYER_RE.match(path)
    if m is not None:
        return np.asarray([int(m.group(1))])
    m = _STACKED_RE.search(path)
    if m is None:
        return None
    gi, si = int(m.group(1)), int(m.group(2))
    offset = sum(g.n_layers for g in cfg.groups[:gi])
    g = cfg.groups[gi]
    return offset + np.arange(g.repeats) * len(g.slots) + si


def _check_mask(cfg: ModelCfg, mask) -> np.ndarray:
    mask = np.asarray(mask, bool)
    if mask.shape != (n_layers(cfg),):
        raise ValueError(f"mask shape {mask.shape} != ({n_layers(cfg)},)")
    return mask


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------


def depth_mask(cfg: ModelCfg, top_layers: int) -> np.ndarray:
    """Keep the top `top_layers` layers (the paper's Table-5 axis)."""
    L = n_layers(cfg)
    if not 1 <= top_layers <= L:
        raise ValueError(f"top_layers must be in [1, {L}], got {top_layers}")
    mask = np.zeros((L,), bool)
    mask[L - top_layers:] = True
    return mask


def topk_mask(scores: np.ndarray, k: int) -> np.ndarray:
    """Keep the k highest-importance layers (ties broken toward depth)."""
    scores = np.asarray(scores, np.float64)
    if not 1 <= k <= scores.shape[0]:
        raise ValueError(f"k must be in [1, {scores.shape[0]}], got {k}")
    order = np.argsort(scores + np.arange(scores.shape[0]) * 1e-12)
    mask = np.zeros(scores.shape[0], bool)
    mask[order[-k:]] = True
    return mask


# ---------------------------------------------------------------------------
# Importance scores
# ---------------------------------------------------------------------------


def magnitude_importance(params: dict, cfg: ModelCfg) -> np.ndarray:
    """(L,) deviation-from-identity score: mean|w-1| + mean|b| per layer."""
    vecs = adapter_vectors(params, cfg)
    return (np.abs(vecs["w"] - 1.0).mean(axis=1)
            + np.abs(vecs["b"]).mean(axis=1))


def cross_task_importance(task_params: Dict[str, dict],
                          cfg: ModelCfg) -> np.ndarray:
    """(L,) importance aggregated over tasks: the per-task magnitude
    scores averaged."""
    if not task_params:
        raise ValueError("need at least one task's params")
    scores = [magnitude_importance(p, cfg) for p in task_params.values()]
    return np.mean(scores, axis=0)


def apply_layer_mask(params: dict, cfg: ModelCfg, mask) -> dict:
    """Reset the adapters of masked-OFF layers to the identity (w=1,
    b=0); every other leaf passes through. Works on per-layer params and
    on dense JAX-layout deltas; a PackedRows leaf is refused."""
    from repro_torch.sparse.prune import is_packed  # prune imports this

    mask = _check_mask(cfg, mask)

    def one(path: str, v):
        m = re.search(r"/adapter/(w|b)$", "/" + path)
        ids = leaf_layer_ids(cfg, path)
        if m is None or ids is None or v is None:
            return v
        if is_packed(v):
            raise ValueError(
                f"{path} is a PackedRows leaf; apply_layer_mask works on "
                "dense trees - run prune.unpack_delta first (prune_delta "
                "does this for you)")
        keep = torch.as_tensor(mask[ids], dtype=torch.float32,
                               device=v.device)
        keep = keep.reshape(()) if _LAYER_RE.match(path) \
            else keep.reshape((-1,) + (1,) * (v.dim() - 1))
        ident = 1.0 if m.group(1) == "w" else 0.0
        return (v * keep + ident * (1.0 - keep)).to(v.dtype)

    return tu.map_with_path(one, params)


def ablate_layers(params: dict, cfg: ModelCfg, layer_ids) -> dict:
    """Reset the given layers' adapters to the identity."""
    mask = np.ones((n_layers(cfg),), bool)
    mask[np.asarray(layer_ids, int)] = False
    return apply_layer_mask(params, cfg, mask)


def ablation_importance(params: dict, cfg: ModelCfg,
                        eval_fn: Callable[[dict], float]) -> np.ndarray:
    """(L,) delta-quality score: the quality of `params` minus the quality
    with layer l's adapter ablated to the identity. `eval_fn(params) ->
    float` (higher is better) is typically `lambda p: loop.evaluate(cfg,
    p, data.eval_batches(bs), metric)`."""
    base = float(eval_fn(params))
    return np.asarray([
        base - float(eval_fn(ablate_layers(params, cfg, [l])))
        for l in range(n_layers(cfg))
    ])


# ---------------------------------------------------------------------------
# Gradient gating (mask -> gate tree)
# ---------------------------------------------------------------------------


def mask_gate(params: dict, cfg: ModelCfg, mask: Optional[np.ndarray]):
    """The gradient gate of a layer mask: 1.0 everywhere except the
    adapter and ffn_norm leaves of masked-OFF layers, 0.0. A port layer
    leaf gets one float; a stacked JAX-layout leaf a (repeats, 1, ...)
    fp32 tensor, as JAX gives it. mask=None gates nothing."""
    if mask is None:
        return tu.map_with_path(lambda p, v: 1.0, params)
    mask = _check_mask(cfg, mask)

    def gate(path: str, v):
        ids = leaf_layer_ids(cfg, path)
        if ids is None or not _GATED_RE.search("/" + path):
            return 1.0
        if _LAYER_RE.match(path):
            return float(mask[ids[0]])
        gates = torch.as_tensor(mask[ids], dtype=torch.float32)
        return gates.reshape((len(ids),) + (1,) * (getattr(v, "ndim", 1) - 1))

    return tu.map_with_path(gate, params)


def gated_param_count(params: dict, trainable_mask: dict, gate_tree) -> int:
    """Trainable parameters surviving the gate (Table-5 / preset
    fractions)."""
    flags = dict(tu.flatten_with_paths(trainable_mask))
    gates = dict(tu.flatten_with_paths(gate_tree))
    count = 0
    for path, leaf in tu.flatten_with_paths(params):
        if not flags[path] or leaf is None:
            continue
        g = gates[path]
        numel = int(np.prod(tuple(leaf.shape)))
        if isinstance(g, (float, int)):
            count += numel * int(g != 0.0)
        else:
            count += int(torch.as_tensor(g).sum()) * (numel // g.shape[0])
    return count
