"""RWKV6 "Finch" blocks (port of `repro.models.rwkv`, arXiv:2404.05892):
attention-free token mixing with data-dependent per-channel decay, and
the squared-ReLU channel mix.

Time-mixing recurrence (per head, head size n, matrix state S (n, n)):
    o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + lora_w(x_w,t))), a data-dependent decay in
(0, 1), and the token-shift "ddlerp" low-rank interpolation that makes the
five mixes (w, k, v, r, g).

Where the JAX model computes the recurrence with a jnp einsum at S == 1
and a chunked `lax.scan` at S > 1, the port sends both through
`ops.wkv6` (kernel #8 on the card) from the cache's state: the same
function as `ref.wkv6_ref` with s0. When autograd needs the recurrence's
gradient (training), it goes through `kernels.rwkv6.WKV6`: #8 forward,
and the plain backward over cfg.rwkv_chunk-step chunks, as JAX's trainer
differentiates its chunk-rematted scan; the plain path (impl="ref")
differentiates `ref.wkv6_ref` step by step instead, so that it shares no
code with the backward it is held against. The projections stay `torch.matmul`,
as JAX leaves them to XLA. The dtypes are JAX's: mu_x, mu, w0, u, mu_k and
mu_r are fp32; the decay, r, k and v are fp32 into the recurrence; the
group norm runs in fp32 and its result is cast to the compute dtype.

Cache protocol (per rwkv layer): {"S": (B, H, n, n) fp32, "tm_prev": (B, d),
"cm_prev": (B, d)}, the last two the inputs of the previous token to the
time mix and the channel mix. Prefill (cache=None) starts from zeros and
returns fresh parts; decode writes the given cache in place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelCfg
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rwkv6 import WKV6
from repro_torch.models.layers import dense_init, gen_device

_DDLERP_RANK = 32
_DECAY_RANK = 64
_MIX_NAMES = 5  # w, k, v, r, g


def _draw(gen: Optional[torch.Generator], shape, kind: str, scale: float,
          shift: float = 0.0, dtype=torch.float32) -> torch.Tensor:
    """uniform or normal draws from `gen` times `scale` plus `shift`, made
    in fp32 and stored in `dtype`; uninitialised without a generator."""
    t = torch.empty(shape, dtype=torch.float32, device=gen_device(gen))
    if gen is not None:
        (t.uniform_ if kind == "uniform" else t.normal_)(generator=gen)
        t = t * scale + shift
    return t.to(dtype)


def rwkv_tm_init(gen: Optional[torch.Generator], cfg: ModelCfg) -> dict:
    d, n = cfg.d_model, cfg.rwkv_head_dim
    H, pdt = d // n, cfg.pdtype
    return {
        "mu_x": _draw(gen, (d,), "uniform", 0.5),
        "mu": _draw(gen, (_MIX_NAMES, d), "uniform", 0.5),
        "lora1": dense_init(gen, d, _MIX_NAMES * _DDLERP_RANK, pdt),
        "lora2": _draw(gen, (_MIX_NAMES, _DDLERP_RANK, d), "normal", 0.01,
                       dtype=pdt),
        "w0": _draw(gen, (d,), "normal", 0.5, -0.6),
        "wA": dense_init(gen, d, _DECAY_RANK, pdt),
        "wB": _draw(gen, (_DECAY_RANK, d), "normal", 0.01, dtype=pdt),
        "u": _draw(gen, (H, n), "normal", 0.1),
        "wr": dense_init(gen, d, d, pdt),
        "wk": dense_init(gen, d, d, pdt),
        "wv": dense_init(gen, d, d, pdt),
        "wg": dense_init(gen, d, d, pdt),
        "wo": dense_init(gen, d, d, pdt),
        "ln_x_scale": torch.ones((d,), dtype=pdt, device=gen_device(gen)),
        "ln_x_bias": torch.zeros((d,), dtype=pdt, device=gen_device(gen)),
    }


def rwkv_cm_init(gen: Optional[torch.Generator], cfg: ModelCfg) -> dict:
    d, f, pdt = cfg.d_model, cfg.d_ff, cfg.pdtype
    return {
        "mu_k": _draw(gen, (d,), "uniform", 0.5),
        "mu_r": _draw(gen, (d,), "uniform", 0.5),
        "ck": dense_init(gen, d, f, pdt),
        "cv": dense_init(gen, f, d, pdt),
        "cr": dense_init(gen, d, d, pdt),
    }


def rwkv_cache_init(cfg: ModelCfg, batch: int, device) -> dict:
    d, n = cfg.d_model, cfg.rwkv_head_dim
    return {
        "S": torch.zeros((batch, d // n, n, n), dtype=torch.float32,
                         device=device),
        "tm_prev": torch.zeros((batch, d), dtype=cfg.cdtype, device=device),
        "cm_prev": torch.zeros((batch, d), dtype=cfg.cdtype, device=device),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1}, with `prev` giving position -1."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _group_norm(p: dict, x: torch.Tensor, n: int, eps: float = 1e-5):
    """Per-head LayerNorm of (B, S, d) in heads of n, in fp32."""
    B, S, d = x.shape
    xh = x.reshape(B, S, d // n, n).float()
    mu = xh.mean(-1, keepdim=True)
    var = (xh - mu).square().mean(-1, keepdim=True)
    y = ((xh - mu) * torch.rsqrt(var + eps)).reshape(B, S, d)
    return y * p["ln_x_scale"].float() + p["ln_x_bias"].float()


def rwkv_time_mix(p: dict, cfg: ModelCfg, x: torch.Tensor,
                  cache: Optional[dict] = None, impl: str = "auto"):
    """x: (B, S, d). Returns (y, cache parts {"S", "tm_prev"}); with a
    cache, its "S" and "tm_prev" are written in place and returned."""
    B, S, d = x.shape
    n = cfg.rwkv_head_dim
    H, cdt = d // n, cfg.cdtype
    prev = (cache["tm_prev"] if cache is not None
            else torch.zeros((B, d), dtype=cdt, device=x.device))
    xx = _shift(x, prev) - x

    # ddlerp: data-dependent token-shift mix for the five streams
    xxx = x + xx * p["mu_x"].to(cdt)
    s = torch.tanh(xxx @ p["lora1"].to(cdt)).reshape(B, S, _MIX_NAMES,
                                                     _DDLERP_RANK)
    offs = torch.einsum("bsfr,frd->bsfd", s, p["lora2"].to(cdt))
    mix = p["mu"].to(cdt)[None, None] + offs  # (B, S, 5, d)
    xw, xk, xv, xr, xg = [x + xx * mix[:, :, i] for i in range(_MIX_NAMES)]

    # data-dependent decay, fp32
    dec = p["w0"].float() + (torch.tanh(xw @ p["wA"].to(cdt))
                             @ p["wB"].to(cdt)).float()
    w = torch.exp(-torch.exp(dec))  # (B, S, d) in (0, 1)

    def heads(t):  # (B, S, d) -> a (B, H, S, n) view of (B, S, H, n)
        return t.reshape(B, S, H, n).transpose(1, 2)

    r = heads((xr @ p["wr"].to(cdt)).float())
    k = heads((xk @ p["wk"].to(cdt)).float())
    v = heads((xv @ p["wv"].to(cdt)).float())
    g = F.silu(xg @ p["wg"].to(cdt))
    state = None if cache is None else cache["S"]
    u, w = p["u"].float(), heads(w)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        # training: #8 forward, the plain chunked backward; the plain path
        # differentiates the step-by-step recurrence itself
        o, S_new = (ref.wkv6_ref(r, k, v, w, u, state) if impl == "ref" else
                    WKV6.apply(r, k, v, w, u, state, cfg.rwkv_chunk, impl))
        if state is not None:
            state.copy_(S_new.detach())
    else:
        o, S_new = ops.wkv6(r, k, v, w, u, s0=state, impl=impl)
    o = o.transpose(1, 2).reshape(B, S, d)
    o = _group_norm(p, o, n).to(cdt) * g
    y = o @ p["wo"].to(cdt)
    if cache is None:
        return y, {"S": S_new, "tm_prev": x[:, -1].clone()}
    cache["tm_prev"].copy_(x[:, -1])
    return y, {"S": S_new, "tm_prev": cache["tm_prev"]}


def rwkv_channel_mix(p: dict, cfg: ModelCfg, x: torch.Tensor,
                     cache: Optional[dict] = None):
    """x: (B, S, d). Returns (y, {"cm_prev"}); with a cache, its "cm_prev"
    is written in place and returned."""
    B, S, d = x.shape
    cdt = cfg.cdtype
    prev = (cache["cm_prev"] if cache is not None
            else torch.zeros((B, d), dtype=cdt, device=x.device))
    xx = _shift(x, prev) - x
    xk = x + xx * p["mu_k"].to(cdt)
    xr = x + xx * p["mu_r"].to(cdt)
    h = F.relu(xk @ p["ck"].to(cdt)).square()
    y = torch.sigmoid(xr @ p["cr"].to(cdt)) * (h @ p["cv"].to(cdt))
    if cache is None:
        return y, {"cm_prev": x[:, -1].clone()}
    cache["cm_prev"].copy_(x[:, -1])
    return y, {"cm_prev": cache["cm_prev"]}
