"""AdamW with decoupled weight decay over the trainable tensors only (port
of `repro.optim.adamw` with fp32 moments).

Trees here are flat dicts {path: tensor} of the trainable leaves. The
update follows the JAX sequence exactly: moments, bias correction,
step = m_hat / (sqrt(v_hat) + eps), plus wd * p for the decayed leaves,
then p -= lr * step. `torch.optim.AdamW` orders the decay differently,
which a parity test would see.

JAX decays every leaf of two or more dims. Its layers' leaves are stacked
on a leading `repeats` dim, so there a layer's adapter and norm vectors are
(repeats, d) and decay too. The port keeps one (d,) tensor per layer, so
the caller names the decayed leaves (`steps.make_state` picks them by
their JAX rank).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from repro_torch.common.types import OptimCfg

Tree = Dict[str, torch.Tensor]


def adamw_init(trainable: Tree, decay: Iterable[str]) -> dict:
    """Zeroed fp32 moments over `trainable`; `decay` names the leaves
    that take weight decay."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in trainable.items()}

    return {"m": zeros(), "v": zeros(), "count": 0,
            "decay": frozenset(decay)}


def global_norm(grads: Tree) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / norm) in fp32: JAX's fp32
    scale promotes a bf16 gradient to fp32, so the product is not rounded
    back to bf16 before AdamW reads it."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g.float() * scale for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(grads: Tree, state: dict, params: Tree, cfg: OptimCfg,
                 lr: float) -> dict:
    """Update `params` in place (the port's state is mutable; JAX returns
    new arrays) and return the new optimizer state."""
    count = state["count"] + 1
    c1 = 1.0 - cfg.b1 ** count
    c2 = 1.0 - cfg.b2 ** count
    new_m, new_v = {}, {}
    for k, p in params.items():
        g32 = grads[k].float()
        m = cfg.b1 * state["m"][k] + (1 - cfg.b1) * g32
        v = cfg.b2 * state["v"][k] + (1 - cfg.b2) * g32.square()
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        p32 = p.float()
        if cfg.weight_decay and k in state["decay"]:
            step = step + cfg.weight_decay * p32
        p.copy_((p32 - lr * step).to(p.dtype))
        new_m[k], new_v[k] = m, v
    return {"m": new_m, "v": new_v, "count": count, "decay": state["decay"]}
