"""Plain PyTorch versions of the ported kernels (the correctness contract).

Each function is the direct, untiled computation of its kernel, mirroring
`repro.kernels.ref`. The CPU path runs them, the CPU tests hold them to the
JAX Pallas kernels, and on the card `chip_smoke.py` holds each CUDA kernel
to its plain version here (through `ops.*(impl="ref")`).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _f32(t):
    return t.to(torch.float32)


def hadamard_ref(x, w, b):
    """y = x*w + b over the trailing dim; fp32 math, out in x.dtype (as
    the Pallas kernel writes it)."""
    return (_f32(x) * _f32(w) + _f32(b)).to(x.dtype)


def hadamard_affine_bwd_ref(g, x, w):
    """The VJP of `hadamard_ref` on rows of (..., d): dx = g*w in g.dtype;
    dw = sum(g*x) and db = sum(g) over every row, fp32 (d,)."""
    d = g.shape[-1]
    g32, x32 = _f32(g).reshape(-1, d), _f32(x).reshape(-1, d)
    dx = (g32 * _f32(w)).to(g.dtype).reshape(g.shape)
    return dx, (g32 * x32).sum(0), g32.sum(0)


def norm_bwd(xn, g_h, scale, eps: float, layernorm: bool):
    """VJP of h = Norm(xn)*scale (+bias) on rows of (n, d), in fp32 as the
    JAX `_fused_bwd` writes it (`repro/kernels/hadamard.py:224-242`).
    Returns (dxn (n, d), dscale (d,), dbias (d,) or None)."""
    xn32, gh32 = _f32(xn), _f32(g_h)
    g = gh32 * _f32(scale)
    if layernorm:
        mu = xn32.mean(-1, keepdim=True)
        var = (xn32 - mu).square().mean(-1, keepdim=True)
        r = torch.rsqrt(var + eps)
        xhat = (xn32 - mu) * r
        dxn = r * (g - g.mean(-1, keepdim=True)
                   - xhat * (g * xhat).mean(-1, keepdim=True))
        return dxn, (gh32 * xhat).sum(0), gh32.sum(0)
    r = torch.rsqrt(xn32.square().mean(-1, keepdim=True) + eps)
    dxn = r * g - xn32 * r ** 3 * (g * xn32).mean(-1, keepdim=True)
    return dxn, (gh32 * xn32 * r).sum(0), None


def fused_adapter_residual_norm_bwd_ref(g_xn, g_h, x, w, b, scale, xn,
                                        eps: float = 1e-6, bias=None,
                                        affine_bwd=hadamard_affine_bwd_ref):
    """VJP of `fused_adapter_residual_norm_ref` from the residuals
    `_fused_fwd` saves, as `_fused_bwd` computes it: the norm VJP, plus the
    incoming g_xn (None counts as zeros), gives gt; then (dx, dw, db) =
    affine_bwd(gt, x, w) and dres = gt. `affine_bwd` is #2's plain version
    here; the autograd Function passes the one `ops` dispatches. Returns
    (dx, dres, dw, db, dscale, dbias) in the dtypes of x, x, w, b, scale
    and bias (None without bias)."""
    d = x.shape[-1]
    dxn, dscale, dbias = norm_bwd(xn.reshape(-1, d), g_h.reshape(-1, d),
                                  scale, eps, bias is not None)
    gt = dxn if g_xn is None else dxn + _f32(g_xn).reshape(-1, d)
    dx, dw, db = affine_bwd(gt, x.reshape(-1, d), w)
    return (dx.reshape(x.shape).to(x.dtype), gt.reshape(x.shape).to(x.dtype),
            dw.to(w.dtype), db.to(b.dtype), dscale.to(scale.dtype),
            None if bias is None else dbias.to(bias.dtype))


def fused_adapter_residual_norm_ref(x, res, w, b, scale, eps: float = 1e-6,
                                    bias=None):
    """x_new = x*w + b + res; h = Norm(x_new)*scale (+bias). RMSNorm, or
    LayerNorm when `bias` is given. fp32 math; returns (x_new, h) in
    x.dtype."""
    xn = _f32(x) * _f32(w) + _f32(b) + _f32(res)
    if bias is not None:
        mu = xn.mean(-1, keepdim=True)
        var = (xn - mu).square().mean(-1, keepdim=True)
        h = (xn - mu) * torch.rsqrt(var + eps) * _f32(scale) + _f32(bias)
    else:
        ms = xn.square().mean(-1, keepdim=True)
        h = xn * torch.rsqrt(ms + eps) * _f32(scale)
    return xn.to(x.dtype), h.to(x.dtype)


def multitask_hadamard_ref(x, w_bank, b_bank, task_ids):
    """y[i] = x[i] * w_bank[tid[i]] + b_bank[tid[i]]; x: (B, S, d), banks
    (T, d), task_ids (B,). fp32 math, output in x.dtype (as the Pallas
    kernel writes it)."""
    w = _f32(w_bank)[task_ids.long()][:, None]
    b = _f32(b_bank)[task_ids.long()][:, None]
    return (_f32(x) * w + b).to(x.dtype)


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None, cap: float = 0.0):
    """Dense attention. q: (B, H, Sq, D); k, v: (B, KH, Skv, D) with
    H = KH*G; query head h reads kv head h // G (the repeat
    `ops.flash_attention(impl="jnp")` does in JAX). Queries are
    right-aligned at i + (Skv - Sq). Returns q.dtype."""
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    kr = _f32(k).repeat_interleave(G, dim=1)
    vr = _f32(v).repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", _f32(q), kr) * scale
    if cap:
        s = torch.tanh(s / cap) * cap
    qp = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kp = torch.arange(Skv, device=q.device)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (qp - kp < window)
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def attention_bwd_ref(g, q, k, v, out, *, causal: bool = True,
                      window: Optional[int] = None,
                      scale: Optional[float] = None, cap: float = 0.0):
    """The VJP of `attention_ref` from its output, as the JAX flash
    backward's `tile_ds` writes it (`repro/models/flash.py:182-282`) over
    one tile that holds every key: P is recomputed from q and k, and
    delta = sum(g*out) per query row. Returns (dq, dk, dv) in the dtypes
    of q, k, v; a kv head's dk/dv sum over its G query heads."""
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    q32, g32 = _f32(q), _f32(g)
    kr = _f32(k).repeat_interleave(G, dim=1)
    vr = _f32(v).repeat_interleave(G, dim=1)
    s_raw = torch.einsum("bhqd,bhkd->bhqk", q32, kr) * scale
    s = torch.tanh(s_raw / cap) * cap if cap else s_raw
    qp = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kp = torch.arange(Skv, device=q.device)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (qp - kp < window)
    p = torch.softmax(torch.where(m, s, torch.full_like(s, NEG_INF)), dim=-1)
    delta = (g32 * _f32(out)).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", g32, vr)
    ds = p * (dp - delta)
    if cap:
        ds = ds * (1.0 - torch.tanh(s_raw / cap).square())
    ds = torch.where(m, ds, torch.zeros_like(ds))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g32)
    dk = dk.reshape(B, KH, G, Skv, D).sum(2)
    dv = dv.reshape(B, KH, G, Skv, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def paged_attention_ref(q, k_pool, v_pool, tables, kv_lens, *,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, cap: float = 0.0,
                        k_scales=None, v_scales=None):
    """Decode attention read through a block table.

    q: (B, H, D), or (B, H, Sq, D) for Sq right-aligned queries; pools
    (num_blocks, page, KH, D), int8 with per-token scales (num_blocks,
    page, KH, 1) when k_scales/v_scales are given; tables (B, nbt) block
    ids; kv_lens (B,) valid length through the last query (linear) or the
    last query's write position (ring window). Query i sits at
    kv_lens - Sq + i (linear) / kv_lens - (Sq - 1) + i (window), and a
    windowed key's position is p = wp - ((wp - li) mod ring) with floor
    mod. Returns fp32 of q's shape."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, :, None]
    B, H, sq, D = q.shape
    page, KH = k_pool.shape[1], k_pool.shape[2]
    nbt = tables.shape[1]
    size = nbt * page
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    tl = tables.long()

    def gather(pool, scales):
        g = _f32(pool[tl])  # (B, nbt, page, KH, D)
        if scales is not None:
            g = g * _f32(scales[tl])
        return g.reshape(B, size, KH, D).repeat_interleave(G, dim=2)

    k = gather(k_pool, k_scales)
    v = gather(v_pool, v_scales)
    s = torch.einsum("bhqd,bkhd->bhqk", _f32(q), k) * scale
    if cap:
        s = torch.tanh(s / cap) * cap
    li = torch.arange(size, device=q.device)[None, None, :]  # (1, 1, size)
    qi = torch.arange(sq, device=q.device)[None, :]  # (1, Sq)
    lens = kv_lens.long()[:, None]
    if window is None:
        qpos = lens - sq + qi  # (B, Sq)
        valid = li <= qpos[..., None]
    else:
        ring = min(window, size)
        wp = lens[..., None]  # (B, 1, 1)
        p = wp - torch.remainder(wp - li, ring)  # floor mod, as jnp's %
        qpos = lens - (sq - 1) + qi
        valid = (li < ring) & (p >= 0) & (p <= qpos[..., None])
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v)
    return out[:, :, 0] if squeeze else out
