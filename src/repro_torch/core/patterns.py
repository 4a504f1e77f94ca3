"""Tuning-pattern analysis (paper §5, Fig 5; port of `repro.core.patterns`).

Given trained adapters for several downstream tasks, compute:
  (a1/a2) per-layer distributions of adapter w and b values,
  (b1-b4) per-layer distributions of the tuned norm scales/biases,
  (c1/c2) cross-task cosine similarity of w and b per layer.

The paper's finding - w vectors are nearly identical across tasks
(cos ~ 1.0) while b vectors are task-specific (cos <= ~0.3) - motivates
shared-weight adapter serving; `suggest_shared_weight` implements it.
Everything here is numpy over `core.hadamard.adapter_vectors`.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.common.types import ModelCfg
from repro_torch.core.hadamard import adapter_vectors


def layer_distributions(params, cfg: ModelCfg) -> Dict[str, np.ndarray]:
    """Per-layer summary stats of adapter w and b: (n_layers, 5) arrays of
    [mean, std, min, max, median]."""
    vecs = adapter_vectors(params, cfg)

    def stats(x):  # x: (L, d)
        return np.stack(
            [x.mean(1), x.std(1), x.min(1), x.max(1), np.median(x, 1)], axis=1
        )

    return {"w": stats(vecs["w"]), "b": stats(vecs["b"])}


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def cross_task_similarity(task_params: Dict[str, dict], cfg: ModelCfg):
    """Cosine similarity heatmaps per layer between every pair of tasks.

    Returns {'w': (L, T, T), 'b': (L, T, T), 'tasks': [...]}
    For b (init 0) the paper computes similarity of the learned vectors
    directly; near-zero norms are handled by _cosine.
    """
    names = sorted(task_params)
    vecs = {t: adapter_vectors(task_params[t], cfg) for t in names}
    L = next(iter(vecs.values()))["w"].shape[0]
    T = len(names)
    out = {"w": np.zeros((L, T, T)), "b": np.zeros((L, T, T)), "tasks": names}
    for l in range(L):
        for i, ti in enumerate(names):
            for j, tj in enumerate(names):
                out["w"][l, i, j] = _cosine(vecs[ti]["w"][l], vecs[tj]["w"][l])
                out["b"][l, i, j] = _cosine(vecs[ti]["b"][l], vecs[tj]["b"][l])
    return out


def consistency_report(sim) -> Dict[str, float]:
    """Scalar summary used by the Fig-5 benchmark: mean off-diagonal cosine."""
    def mean_offdiag(m):  # (L, T, T)
        L, T, _ = m.shape
        mask = ~np.eye(T, dtype=bool)
        return float(m[:, mask].mean())

    return {
        "w_mean_cross_task_cos": mean_offdiag(sim["w"]),
        "b_mean_cross_task_cos": mean_offdiag(sim["b"]),
    }


def suggest_shared_weight(task_params: Dict[str, dict], cfg: ModelCfg):
    """Shared-adapter proposal: average w across tasks (justified when the
    cross-task cosine of w is ~1), keep per-task b.

    Returns (shared_w (L, d), {task: b (L, d)}).
    """
    names = sorted(task_params)
    ws = np.stack([adapter_vectors(task_params[t], cfg)["w"] for t in names])
    bs = {t: adapter_vectors(task_params[t], cfg)["b"] for t in names}
    return ws.mean(axis=0), bs
