"""Self-attention with GQA, RoPE and qk-norm over a contiguous slot cache
(port of `repro.models.attention`, the decoder-serving subset).

Cache protocol (per attention layer):
  prefill: cache=None, cache_len=L -> (y, fresh cache (B, L, KH, D) x2)
  decode:  cache=dict, write_pos=(B,) -> (y, the same cache, written in
           place at each row's write position)

Prefill attends through `ops.flash_attention`. Decode attends through
`ops.paged_attention`: a contiguous (B, L, KH, D) cache already is a block
pool of B*L/page pages, so each row's block table is the fixed run
b*nbt + arange(nbt) and kv_lens = write_pos + 1. That is exactly the
per-row-valid-length attention the JAX decode computes.

`apply_attn` returns the attention output before the Hadamard adapter: the
block applies it together with the residual add and the norm that follows
(`models/program.py`). The windowed ring cache, the paged pool,
cross-attention and the LoRA/IA3 hooks arrive with later slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.types import ModelCfg, Slot
from repro_torch.kernels import ops
from repro_torch.kernels.attention import FlashAttention
from repro_torch.kernels.hadamard import HadamardAffine
from repro_torch.models.layers import (apply_rope, dense, dense_init,
                                      gen_device, rms_head_norm)

# tokens per page of the decode cache's block-pool view
DECODE_PAGE = 16


def attn_init(gen: torch.Generator, cfg: ModelCfg) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": dense_init(gen, d, qd, cfg.pdtype),
        "wk": dense_init(gen, d, kvd, cfg.pdtype),
        "wv": dense_init(gen, d, kvd, cfg.pdtype),
        "wo": dense_init(gen, qd, d, cfg.pdtype),
    }
    dev = gen_device(gen)
    if cfg.attn_bias:
        p["bq"] = torch.zeros((qd,), dtype=cfg.pdtype, device=dev)
        p["bk"] = torch.zeros((kvd,), dtype=cfg.pdtype, device=dev)
        p["bv"] = torch.zeros((kvd,), dtype=cfg.pdtype, device=dev)
        p["bo"] = torch.zeros((d,), dtype=cfg.pdtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=cfg.pdtype, device=dev)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=cfg.pdtype, device=dev)
    return p


def check_slot(slot: Slot) -> None:
    if slot.kind != "attn" or slot.moe or slot.cross_attn:
        raise NotImplementedError(
            f"slot {slot} is not ported: the first slice serves dense "
            "self-attention decoders; recurrent, RWKV, MoE and cross-attention "
            "blocks arrive with the other-families slice")
    if slot.window is not None:
        raise NotImplementedError(
            "local-window attention needs the windowed ring cache, which "
            "arrives with a later slice")


def decode_tables(batch: int, cache_len: int, device) -> torch.Tensor:
    """Block tables of a contiguous (batch, cache_len) cache viewed as a
    pool of DECODE_PAGE-token pages: row b owns pages b*nbt .. b*nbt+nbt-1."""
    if cache_len % DECODE_PAGE:
        raise ValueError(f"decode cache length {cache_len} must be a multiple "
                         f"of the page size {DECODE_PAGE}")
    nbt = cache_len // DECODE_PAGE
    rows = torch.arange(batch, dtype=torch.int32, device=device)[:, None]
    return rows * nbt + torch.arange(nbt, dtype=torch.int32, device=device)


def apply_hadamard(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Plain Eq. 5 affine on the feature dim; (B, d) w/b broadcast over the
    sequence (one adapter per request)."""
    w, b = w.to(y.dtype), b.to(y.dtype)
    if w.dim() == 2:
        w, b = w[:, None], b[:, None]
    return y * w + b


def apply_attn(p: dict, cfg: ModelCfg, slot: Slot, x: torch.Tensor, *,
               q_pos: torch.Tensor, cache: Optional[dict] = None,
               cache_len: Optional[int] = None,
               write_pos: Optional[torch.Tensor] = None,
               kv_lens: Optional[torch.Tensor] = None,
               tables: Optional[torch.Tensor] = None,
               concat_adapter: Optional[tuple] = None, causal: bool = True,
               impl: str = "auto"):
    """x: (B, S, d). Prefill (cache_len given), a cache-free forward
    (neither given; the encoder passes causal=False) or decode (cache and
    write_pos (B,) given, S == 1; kv_lens and tables as `decode_tables`
    builds them, shared by every layer). concat_adapter: (w, b) of an
    'attn_concat' Hadamard adapter, applied on Concat(heads) before W_O:
    one (d,) adapter through `HadamardAffine` (kernels #1/#2), per-row
    (B, d) rows in plain torch. Returns (y, cache)."""
    check_slot(slot)
    B, S, _ = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = cfg.cdtype

    q = dense(x, p["wq"], cdt)
    k = dense(x, p["wk"], cdt)
    v = dense(x, p["wv"], cdt)
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KH, Dh)
    v = v.reshape(B, S, KH, Dh)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    kpos = q_pos if write_pos is None else write_pos[:, None]
    if cfg.pos == "rope":
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, kpos, cfg.rope_theta)
    scale = cfg.query_scale if cfg.query_scale is not None else Dh ** -0.5

    if cache is not None:  # decode: write in place, attend over the pool
        if S != 1 or write_pos is None:
            raise ValueError("decode takes one token per row and write_pos")
        rows = torch.arange(B, device=x.device)
        cache["k"][rows, write_pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, write_pos] = v[:, 0].to(cache["v"].dtype)
        L = cache["k"].shape[1]
        pool_shape = (B * L // DECODE_PAGE, DECODE_PAGE, KH, Dh)
        out = ops.paged_attention(
            q[:, 0], cache["k"].view(pool_shape), cache["v"].view(pool_shape),
            tables, kv_lens, scale=scale, cap=cfg.attn_softcap, impl=impl)
        out = out.to(cdt).reshape(B, 1, H * Dh)
        new_cache = cache
    else:  # prefill (or a cache-free forward)
        out = FlashAttention.apply(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal, None, scale, cfg.attn_softcap, impl)
        out = out.transpose(1, 2).reshape(B, S, H * Dh)
        new_cache = None
        if cache_len is not None:
            if cache_len < S:
                raise ValueError(f"cache_len {cache_len} < prompt length {S}")
            new_cache = {
                "k": torch.zeros((B, cache_len, KH, Dh), dtype=cdt,
                                 device=x.device),
                "v": torch.zeros((B, cache_len, KH, Dh), dtype=cdt,
                                 device=x.device),
            }
            new_cache["k"][:, :S] = k
            new_cache["v"][:, :S] = v

    if concat_adapter is not None:
        w, b = concat_adapter
        out = (apply_hadamard(out, w, b) if w.dim() == 2
               else HadamardAffine.apply(out, w, b, impl))
    y = dense(out, p["wo"], cdt)
    if "bo" in p:
        y = y + p["bo"].to(cdt)
    return y, new_cache
