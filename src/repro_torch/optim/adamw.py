"""AdamW with decoupled weight decay over the trainable tensors only (port
of `repro.optim.adamw`), its moments stored as `OptimCfg.m_dtype` /
`v_dtype` name (`optim.qstate`: fp32, bf16 or row-wise int8 with optional
error feedback).

Trees here are flat dicts {path: tensor} of the trainable leaves. The
update follows the JAX sequence exactly: decode the moments (plus their
residuals), moments, the int8 v clamped at 0, bias correction,
step = m_hat / (sqrt(v_hat) + eps), plus wd * p for the decayed leaves,
re-encode the moments, then p -= lr * step. `torch.optim.AdamW` orders
the decay differently, which a parity test would see. With fp32 moments
every encode and decode is the identity.

JAX decays every leaf of two or more dims. Its layers' leaves are stacked
on a leading `repeats` dim, so there a layer's adapter and norm vectors are
(repeats, d) and decay too. The port keeps one (d,) tensor per layer, so
the caller names the decayed leaves (`steps.make_state` picks them by
their JAX rank).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch.common.types import OptimCfg
from repro_torch.dist.api import all_reduce
from repro_torch.optim import qstate

Tree = Dict[str, torch.Tensor]


def adamw_init(trainable: Tree, decay: Iterable[str],
               cfg: Optional[OptimCfg] = None) -> dict:
    """Zeroed moments over `trainable` in `cfg`'s moment dtypes (fp32
    without a cfg); `decay` names the leaves that take weight decay."""
    return qstate.init_opt_state(trainable, cfg or OptimCfg(), decay)


def global_norm(grads: Tree, sharded: Iterable[str] = frozenset()
                ) -> torch.Tensor:
    """The gradients' L2 norm. `sharded` names the leaves that hold one
    model rank's slice each under a mesh: their squared norms are summed
    over the model ranks, every other leaf's counted once."""
    def sq(paths):
        return sum((grads[p].float().square().sum() for p in paths),
                   torch.zeros((), device=next(iter(grads.values())).device))

    part = all_reduce(sq([p for p in grads if p in sharded]), "model")
    return torch.sqrt(part + sq([p for p in grads if p not in sharded]))


def clip_by_global_norm(grads: Tree, max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / norm) in fp32: JAX's fp32
    scale promotes a bf16 gradient to fp32, so the product is not rounded
    back to bf16 before AdamW reads it. norm: the global norm when the
    caller computed it (a sharded gradient's over its ranks)."""
    norm = global_norm(grads) if norm is None else norm
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
    has_me, has_ve = "m_err" in state, "v_err" in state
    new = {key: {} for key in ("m", "v", "m_err", "v_err")
           if key in state}
    for k, p in params.items():
        g32 = grads[k].float()
        m = qstate.decode_moment(state["m"][k])
        if has_me:
            m = m + qstate.decode_moment(state["m_err"][k])
        v = qstate.decode_moment(state["v"][k])
        if has_ve:
            v = v + qstate.decode_moment(state["v_err"][k])
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32.square()
        if cfg.v_dtype == "int8":
            # the residual can put the rebuilt v a hair below zero; clamp
            # before the square root (a no-op in exact arithmetic)
            v = torch.clamp(v, min=0.0)
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        p32 = p.float()
        if cfg.weight_decay and k in state["decay"]:
            step = step + cfg.weight_decay * p32
        new["m"][k], me = qstate.encode_moment(m, cfg.m_dtype, ef=has_me)
        new["v"][k], ve = qstate.encode_moment(v, cfg.v_dtype, ef=has_ve)
        if has_me:
            new["m_err"][k] = me
        if has_ve:
            new["v_err"][k] = ve
        p.copy_((p32 - lr * step).to(p.dtype))
    return dict(new, count=count, decay=state["decay"])
