"""Mixture-of-experts FFN (port of `repro.models.moe`): sort-based capacity
dispatch over routed experts, plus always-on shared experts (DeepSeek-MoE's
fine-grained layout).

JAX splits the tokens into G routing groups, one per data-parallel shard,
so that every device routes its own tokens; the port has no mesh, so G is
1 (`_n_groups`). The group axis is kept all the same, (G, Tg, d) tokens
and a (G, E, cap, d) dispatch buffer, for the distribution slice to fill.

Semantics held to JAX's, route for route:
  * the router's logits in fp32 at full precision (TF32 off for that one
    product, whatever the caller set), softmax, top-k (ties to the lower
    expert, as `lax.top_k`), gates renormalized over the top k (+ 1e-9)
    only under `normalize_weights`;
  * capacity cap = max(1, ceil(Tg * k * capacity_factor / E)); the Tg * k
    routes ordered by expert with a stable sort (`jnp.argsort` is stable),
    each route's place in its expert's queue = its sorted index minus the
    expert's offset, a route past cap dropped to the sink row E * cap;
  * the expert FFNs batched over (group, expert), in the compute dtype;
  * each token's k weighted rows gathered back to their (Tg, k) places and
    summed in a fixed order, the gate cast to the compute dtype first;
  * the shared experts' output added; the load-balancing loss from the
    fp32 probabilities: aux_loss_weight * E * sum(me * ce), me the mean
    probability of each expert, ce the share of tokens whose argmax (the
    first on ties) it is.

Every shape is fixed by (B, S) and the config: no boolean-mask indexing,
no host sync, no shape that depends on the routing. No float scatter-add
either: on CUDA those use atomics, whose order changes from run to run;
the dispatch writes each kept row to its own place, the offsets come from
a search of the sorted experts, and the combine is a gather and a sum in
a fixed order, so two bf16 runs give the same bits.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.types import ModelCfg, MoECfg
from repro_torch.models.layers import (act_fn, dense_init, full_fp32,
                                      gen_device)


def _expert_init(gen: Optional[torch.Generator], shape, dtype):
    """A stack of expert matrices: truncated normal (+-2 std) times 0.02,
    drawn in fp32, stored in `dtype` (JAX's `moe_init`)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen_device(gen))
    if gen is not None:
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(0.02)
    return t.to(dtype)


def moe_init(gen: Optional[torch.Generator], cfg: ModelCfg) -> dict:
    """{"router" (d, E) fp32, "wi"/"wg" (E, d, f), "wo" (E, f, d)} and,
    with shared experts, "shared_wi"/"shared_wg" (d, n_shared * f) and
    "shared_wo" (n_shared * f, d), in the config's parameter dtype."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.n_experts
    p = {"router": dense_init(gen, d, E, torch.float32),
         "wi": _expert_init(gen, (E, d, f), cfg.pdtype),
         "wo": _expert_init(gen, (E, f, d), cfg.pdtype)}
    if cfg.gated_mlp:
        p["wg"] = _expert_init(gen, (E, d, f), cfg.pdtype)
    if m.n_shared:
        sf = m.n_shared * f
        p["shared_wi"] = dense_init(gen, d, sf, cfg.pdtype)
        p["shared_wo"] = dense_init(gen, sf, d, cfg.pdtype)
        if cfg.gated_mlp:
            p["shared_wg"] = dense_init(gen, d, sf, cfg.pdtype)
    return p


def _n_groups(T: int) -> int:
    """Routing groups: JAX's data-parallel shard count, 1 with no mesh."""
    return 1


def capacity(m: MoECfg, Tg: int) -> int:
    """Routes each expert takes from a group of Tg tokens (JAX's
    expression, float capacity factor included)."""
    return int(max(1, -(-Tg * m.top_k * m.capacity_factor // m.n_experts)))


def router_probs(xg: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(Tg, d) -> fp32 softmax over the experts of xg @ router."""
    with full_fp32():
        logits = xg.float() @ router.float()
    return torch.softmax(logits, dim=-1)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest probabilities, largest first,
    ties to the lower index (`lax.top_k`): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_group(xg: torch.Tensor, router: torch.Tensor, m: MoECfg,
                 cap: int, cdt: torch.dtype):
    """One group's dispatch, xg (Tg, d). Returns (buf (E, cap, d), (dest,
    keep, t_sorted, g_sorted, order), probs (Tg, E) fp32): JAX's four
    route arrays in expert order (each route's buffer row, E * cap for a
    dropped one; whether it is kept; its token; its gate), and the sort's
    permutation of the (t, j)-ordered routes, which the combine inverts."""
    Tg, d = xg.shape
    E, k = m.n_experts, m.top_k
    dev = xg.device
    probs = router_probs(xg, router)
    gate_vals, expert_idx = top_k(probs, k)
    if m.normalize_weights:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    flat_e = expert_idx.reshape(-1)
    flat_t = torch.arange(Tg * k, device=dev) // k
    flat_g = gate_vals.reshape(-1)

    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    t_sorted = flat_t[order]
    g_sorted = flat_g[order]

    # each expert's first index in the sorted routes: JAX's exclusive
    # cumsum of the counts, without a bincount (which syncs the host)
    offsets = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    pos_in_e = torch.arange(Tg * k, device=dev) - offsets[e_sorted]
    keep = pos_in_e < cap
    dest = torch.where(keep, e_sorted * cap + pos_in_e,
                       torch.full_like(e_sorted, E * cap))

    # row E * cap is the sink of the dropped routes, sliced off
    buf = torch.zeros((E * cap + 1, d), dtype=cdt, device=dev)
    buf[dest] = xg[t_sorted].to(cdt)
    return buf[:E * cap].view(E, cap, d), (dest, keep, t_sorted, g_sorted,
                                           order), probs


def _combine_group(rows: torch.Tensor, info, Tg: int, k: int,
                   cdt: torch.dtype) -> torch.Tensor:
    """rows (E * cap + 1, d): one group's expert outputs, the last row the
    zero sink. Each route's weighted row lands in its token's (Tg, k)
    place through the inverse of the sort, and a token's k rows are summed
    in top-k order, in cdt."""
    dest, _, _, g_sorted, order = info
    d = rows.shape[-1]
    # route r of the (t, j) order reads the row its sorted copy was given
    dest_tk = torch.empty_like(dest).index_copy_(0, order, dest)
    gate_tk = torch.empty_like(g_sorted).index_copy_(0, order, g_sorted)
    weighted = (rows[dest_tk] * gate_tk[:, None].to(cdt)).view(Tg, k, d)
    y = weighted[:, 0]
    for j in range(1, k):
        y = y + weighted[:, j]
    return y


def moe_apply(p: dict, cfg: ModelCfg, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d) in the compute dtype, aux fp32 scalar)."""
    m: MoECfg = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    cdt = cfg.cdtype

    G = _n_groups(T)
    Tg = T // G
    cap = capacity(m, Tg)
    xg = x.reshape(G, Tg, d)

    routed = [_route_group(xg[g], p["router"], m, cap, cdt) for g in range(G)]
    buf = torch.stack([r[0] for r in routed])  # (G, E, cap, d)
    probs = torch.cat([r[2] for r in routed]).view(T, E)

    # --- aux load-balancing loss (Switch-style, over all T tokens) ---
    me = probs.mean(dim=0)
    top1 = probs.argmax(dim=-1)
    ce = (top1[:, None] == torch.arange(E, device=x.device)).sum(
        dim=0).float() / T
    aux = m.aux_loss_weight * E * torch.sum(me * ce)

    # --- the expert FFNs, batched over groups x experts ---
    act = act_fn(cfg.act)
    h = torch.einsum("gecd,edf->gecf", buf, p["wi"].to(cdt))
    if cfg.gated_mlp:
        h = act(h) * torch.einsum("gecd,edf->gecf", buf, p["wg"].to(cdt))
    else:
        h = act(h)
    out_e = torch.einsum("gecf,efd->gecd", h, p["wo"].to(cdt))

    rows = torch.cat([out_e.reshape(G, E * cap, d),
                      torch.zeros((G, 1, d), dtype=cdt, device=x.device)],
                     dim=1)
    y = torch.stack([_combine_group(rows[g], routed[g][1], Tg, k, cdt)
                     for g in range(G)]).reshape(B, S, d)

    # --- shared (always-on) experts ---
    if "shared_wi" in p:
        xf = x.reshape(T, d)
        hs = xf @ p["shared_wi"].to(cdt)
        if cfg.gated_mlp:
            hs = act(hs) * (xf @ p["shared_wg"].to(cdt))
        else:
            hs = act(hs)
        y = y + (hs @ p["shared_wo"].to(cdt)).reshape(B, S, d)
    return y, aux
