"""RG-LRU recurrent block (port of `repro.models.recurrent`; RecurrentGemma
/ Griffin, arXiv:2402.19427).

Structure per block (temporal-mixing half):
  x -> linear_x -> causal depthwise conv1d -> RG-LRU -> (*) -> linear_out
  x -> linear_y -> GeLU ------------------------------^

RG-LRU: r_t = sigmoid(W_a xc_t), i_t = sigmoid(W_x xc_t)
        log a_t = -c * softplus(L) * r_t           (c = 8)
        h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xc_t)

No Pallas kernel touches the block in JAX, so the port writes it in plain
PyTorch, op for op in JAX's order and dtypes:
  * the depthwise conv sums its taps one by one in the activations' dtype,
    then adds the bias (not `F.conv1d`, which accumulates in fp32 in
    another order, and in bf16 parts from JAX);
  * the gates are fp32 products at full precision (TF32 off, as for the
    MoE router); `gate_a` and `gate_x` are cast to fp32 at every call, as
    JAX casts them;
  * one token (a decode step) takes JAX's closed form; a longer sequence
    takes `jax.lax.associative_scan`'s recursion itself (`_assoc_scan`:
    combine adjacent pairs, recurse, fix the evens, interleave), so the
    fp32 products and sums pair up as JAX's do. Its depth is log2(S)
    levels of whole-tensor ops: no loop over S and no host sync.

Cache protocol (per rec layer): {"h": (B, W) fp32, "conv": (B, cw-1, W)
compute dtype}, the recurrence's state and the last cw-1 inputs of the
conv. Prefill (cache=None) starts from zeros and returns a fresh state;
decode writes the given cache in place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelCfg
from repro_torch.models.layers import dense_init, full_fp32, gen_device

_C = 8.0


def rec_init(gen: Optional[torch.Generator], cfg: ModelCfg) -> dict:
    d, pdt = cfg.d_model, cfg.pdtype
    W = cfg.lru_width or d
    cw = cfg.conv1d_width
    dev = gen_device(gen)
    # a so that a^c lands in ~[0.9, 0.999] at r = 1 (the paper's appendix)
    u = torch.empty((W,), dtype=torch.float32, device=dev)
    conv_w = torch.empty((cw, W), dtype=torch.float32, device=dev)
    if gen is not None:
        u.uniform_(0.9 ** 2, 0.999 ** 2, generator=gen)
        conv_w.normal_(generator=gen)
    a_param = torch.log(torch.exp(-torch.log(u) / (2 * _C)) - 1.0)
    return {
        "in_x": dense_init(gen, d, W, pdt),
        "in_y": dense_init(gen, d, W, pdt),
        "conv_w": (conv_w * 0.02).to(pdt),
        "conv_b": torch.zeros((W,), dtype=pdt, device=dev),
        "a_param": a_param,  # fp32 whatever the parameter dtype
        "gate_a": dense_init(gen, W, W, pdt),
        "gate_x": dense_init(gen, W, W, pdt),
        "gate_a_b": torch.zeros((W,), dtype=pdt, device=dev),
        "gate_x_b": torch.zeros((W,), dtype=pdt, device=dev),
        "out": dense_init(gen, W, d, pdt),
    }


def rec_cache_init(cfg: ModelCfg, batch: int, device,
                   dtype: Optional[torch.dtype] = None) -> dict:
    W = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, W),
                            dtype=dtype or cfg.cdtype, device=device),
    }


def _causal_conv(p: dict, x: torch.Tensor, conv_state: torch.Tensor):
    """Depthwise causal conv, width cw. x: (B, S, W); state: (B, cw-1, W).
    Returns (y, the last cw-1 inputs): a prompt shorter than cw-1 tokens
    keeps part of the incoming state, as in JAX."""
    cw = p["conv_w"].shape[0]
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(cw):  # tap i looks back cw-1-i steps
        y = y + full[:, i:i + S] * p["conv_w"][i].to(x.dtype)
    y = y + p["conv_b"].to(x.dtype)
    new_state = full[:, -(cw - 1):] if cw > 1 else conv_state
    return y, new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0) in JAX's formula."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _combine(lhs, rhs):
    al, bl = lhs
    ar, br = rhs
    return al * ar, bl * ar + br


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 1 (len(even) - len(odd) is
    0 or 1)."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return both if even.shape[1] == n else torch.cat([both, even[:, n:]], 1)


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of `_combine` along dim 1, jax 0.9's `_scan`
    recursion: combine adjacent pairs, scan those, then each even element
    from the odd result before it and the element itself."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _assoc_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                   (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _rg_lru(p: dict, xc: torch.Tensor, h0: torch.Tensor):
    """xc: (B, S, W) fp32 conv output; h0: (B, W) fp32. Returns (h_seq,
    h_last)."""
    with full_fp32():
        r = torch.sigmoid(xc @ p["gate_a"].float() + p["gate_a_b"].float())
        i = torch.sigmoid(xc @ p["gate_x"].float() + p["gate_x_b"].float())
    log_a = -_C * _softplus(p["a_param"]) * r  # (B, S, W)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = beta * (i * xc)
    if xc.shape[1] == 1:
        h = a[:, 0] * h0 + b[:, 0]
        return h[:, None], h
    A, Bc = _assoc_scan(a, b)
    h_seq = Bc + A * h0[:, None, :]
    return h_seq, h_seq[:, -1]


def rec_apply(p: dict, cfg: ModelCfg, x: torch.Tensor,
              cache: Optional[dict] = None):
    """Temporal-mixing block. x: (B, S, d). Returns (y, cache): the given
    cache written in place, or with none (prefill, training) a fresh
    {"h", "conv"} from zeros."""
    cdt = cfg.cdtype
    gx = x @ p["in_x"].to(cdt)
    gy = F.gelu(x @ p["in_y"].to(cdt), approximate="tanh")
    state = (cache if cache is not None
             else rec_cache_init(cfg, x.shape[0], x.device, cdt))
    xc, new_conv = _causal_conv(p, gx, state["conv"])
    h_seq, h_last = _rg_lru(p, xc.float(), state["h"])
    y = (h_seq.to(cdt) * gy) @ p["out"].to(cdt)
    if cache is None:  # copies: the views would hold (B, S, W) buffers
        return y, {"h": h_last.clone(), "conv": new_conv.clone()}
    cache["h"].copy_(h_last)
    cache["conv"].copy_(new_conv)
    return y, cache
