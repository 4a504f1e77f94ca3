"""Activation-statistics calibration for backbone quantization (port of
`repro.quant.calibrate`).

Weight-only quantization needs to know which input channels the data
actually drives: a per-output-channel absmax scale spends grid resolution
on outlier weights even when the activations feeding them are near zero.
The calibration pass runs a few batches through the ordinary forward and
accumulates, per matmul call site ("tag": attn/wq, mlp/wi, ...), the
per-input-channel second moment of the activations.
`quantize_tree(..., stats=...)` then runs an activation-weighted clipping
search per JAX leaf (see qtensor._best_clip).

Collection mechanics: every projection in models/ flows through
`qdense(x, w, ..., tag=...)`. While a `collect_stats()` context is active,
qdense hands x to `observe`, which reduces it on x's device to a (d_in,)
fp32 sum of squares and adds that, widened to fp64, to the tag's running
sum on the same device: no host sync per call. Every layer of a tag adds
to the same sum, as JAX's callback adds each layer of its scan, so the
statistic of a tag is aggregated over the layers that share its JAX leaf.
`result()` reads the sums once, at the end.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

_ACTIVE: Optional["_Collector"] = None


class _Collector:
    def __init__(self):
        self._sumsq: Dict[str, torch.Tensor] = {}
        self._count: Dict[str, int] = {}

    def add(self, tag: str, sumsq: torch.Tensor, count: int) -> None:
        sumsq = sumsq.to(torch.float64)
        if tag in self._sumsq and self._sumsq[tag].shape == sumsq.shape:
            self._sumsq[tag] += sumsq
            self._count[tag] += count
        else:
            self._sumsq[tag] = sumsq
            self._count[tag] = count

    def result(self) -> Dict[str, np.ndarray]:
        """{tag: (d_in,) fp32 mean square}, as numpy on the host."""
        return {
            t: (self._sumsq[t] / max(self._count[t], 1)).to(
                torch.float32).cpu().numpy()
            for t in self._sumsq
        }


def collecting() -> bool:
    return _ACTIVE is not None


@torch.no_grad()
def observe(tag: str, x: torch.Tensor) -> None:
    """Called by qdense under an active collector: reduce the activation to
    a per-input-channel sum of squares, on x's device."""
    col = _ACTIVE
    if col is None:
        return
    n = x.numel() // x.shape[-1]
    sq = x.detach().to(torch.float32).square().sum(
        dim=tuple(range(x.dim() - 1)))
    col.add(tag, sq, n)


class collect_stats:
    """Context manager: activates the collector and yields it.

        with collect_stats() as cal:
            model_forward(...)          # any number of batches
        stats = cal.result()            # {tag: (d_in,) mean square}
    """

    def __enter__(self) -> _Collector:
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("calibration collector already active")
        _ACTIVE = _Collector()
        return _ACTIVE

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None


@torch.no_grad()
def calibrate(cfg, params, batches: Iterable[dict],
              max_batches: int = 8) -> Dict[str, np.ndarray]:
    """Run up to `max_batches` numpy batches (dicts with 'tokens' [+
    'type_ids']) through the family's forward on the params' device and
    return the per-tag activation statistics for
    `quantize_tree(..., stats=...)`."""
    from repro_torch.common import tree as tu
    from repro_torch.models import model as M  # models import qdense

    if cfg.family not in ("decoder", "encoder"):
        raise NotImplementedError(
            f"calibrating a {cfg.family} backbone is not ported: its forward "
            "arrives with the other-families slice")
    device = next(leaf for _, leaf in tu.flatten_with_paths(params)).device

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).long().to(device)

    with collect_stats() as cal:
        for i, batch in enumerate(batches):
            if i >= max_batches:
                break
            tokens = tensor(batch["tokens"])
            if cfg.family == "encoder":
                type_ids = batch.get("type_ids")
                M.forward_encoder(params, cfg, tokens, None if type_ids is None
                                  else tensor(type_ids))
            else:
                # forward_lm (not forward_hidden): an untied head is
                # quantizable too, so its input statistics are collected
                M.forward_lm(params, cfg, tokens)
    return cal.result()
