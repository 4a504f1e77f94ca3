"""Self-attention with GQA, RoPE, qk-norm, local windows and soft-capping
over a contiguous slot cache or a paged block pool (port of
`repro.models.attention`, the decoder-serving subset).

Cache protocol (per attention layer):
  prefill: cache=None, cache_len=L -> (y, fresh cache (B, size, KH, D)
           x2), size = L, or min(window, L) for a windowed layer: a ring
           whose slot p % size holds position p, the last min(size, S)
           prompt tokens written
  decode, verify, extend: cache = a block pool {"k", "v"} of (num_blocks,
           page, KH, D), each a tensor or an int8/e4m3 `QTensor` with
           per-token fp32 scales (num_blocks, page, KH, 1); write_pos (B,
           S) -> (y, the same pool, K/V of logical position li written in
           place at (tables[b, li // page], li % page)), li = the position,
           or the position mod the ring for a windowed layer, whose ring
           lies in the first ring // page table entries

Prefill attends through `ops.flash_attention` (causal, the layer's window,
the config's soft-cap and query scale). Every step with a cache attends
through `ops.paged_attention`, straight on the pool: a contiguous
(B, L, KH, D) slot cache already is a pool of B*L/page pages whose row b
owns the fixed run b*nbt + arange(nbt) (`decode_tables`; page =
`decode_page(L)`, DECODE_PAGE or the largest divisor of it that divides a
short ring), and a paged pool comes with the block tables an allocator
handed out. The S queries of a row sit at its write positions,
right-aligned under kv_lens: the last write + 1 for a full-range layer,
the last write itself for a windowed one (the kernel's ring convention,
`kernels/ref.paged_attention_ref`). S = 1 is a decode step, S = k+1 a
speculative verify, a page-padded prompt suffix a prefix-cache extend.
A quantized pool takes `quantize_kv(k, mode)` at every write, JAX's
per-token rule, and #5 widens it to fp32 in place (JAX's gather casts the
dequantized K/V to the compute dtype first: one rounding apart at bf16).

Under a mesh of model degree M (`dist.api`), a rank runs its config's
n_heads/M and n_kv_heads/M (`dist.sharding.local_cfg`) on its column
shards of wq/wk/wv and its row shard of wo: the input passes `f`
(`copy_to_model`), the output projection's partial sums meet in `g`
(`reduce_from_model`) before `bo`, and a replicated leaf read per head (an
`attn_concat` adapter's rows, IA3's scales, LoRA's B) takes the rank's
slice through `split_to_model`. Without a mesh each is the identity.

`apply_attn` returns the attention output before the Hadamard adapter: the
block applies it together with the residual add and the norm that follows
(`models/program.py`). The LoRA and IA3 baselines reach inside attention
through hooks, as in JAX: LoRA adds its low-rank deltas to q and v before
the biases; IA3 scales k and v per channel after rope and before the cache
stores them (a per-channel scale does not commute with rope's pairwise
rotation).

Cross-attention (an encdec decoder's `cross_attn` slot, JAX's
`is_cross` branch): K/V come from the encoder output `kv_x`, with no RoPE
on q or k and no k_norm, and the mask is never causal. Prefill (or a
cache-free forward) attends through #4 non-causally, queries over every
encoder frame whatever their count, and prefill returns {"ck", "cv"} (B,
S_enc, KH, D), built once; a decode step reads them through #5 without the
K/V projections: `cross_view` shows the cache as a pool of
`decode_page(S_enc)`-token pages with kv_lens = S_enc on every row, so
each query, right-aligned at the last key, sees every frame.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.common.types import ModelCfg, Slot
from repro_torch.dist.api import (copy_to_model, reduce_from_model,
                                  split_to_model)
from repro_torch.kernels import ops
from repro_torch.kernels.attention import FlashAttention
from repro_torch.kernels.hadamard import HadamardAffine
from repro_torch.models.layers import (apply_rope, dense_init, gen_device,
                                      rms_head_norm)
from repro_torch.quant.qtensor import (QTensor, _storage_dtype, is_qtensor,
                                      qdense, quantize_kv)

# tokens per page of the decode cache's block-pool view
DECODE_PAGE = 16


def attn_init(gen: torch.Generator, cfg: ModelCfg,
              cross: bool = False) -> dict:
    """A block's attention leaves; a cross-attention block (`cross`) has
    no q_norm/k_norm, as in JAX."""
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
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=cfg.pdtype, device=dev)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=cfg.pdtype, device=dev)
    return p


def check_slot(slot: Slot) -> None:
    if (slot.kind not in ("attn", "rec", "rwkv")
            or (slot.kind == "rwkv" and (slot.moe or slot.cross_attn))):
        raise NotImplementedError(
            f"slot {slot} is not ported: the port runs self-attention "
            "(full-range or windowed) and RG-LRU blocks, each with a dense "
            "or mixture-of-experts FFN and optionally a cross-attention "
            "sublayer, and RWKV6 blocks with their channel mix; an RWKV6 "
            "block with experts or cross-attention is not ported")


def cache_size(slot: Slot, cache_len: int) -> int:
    """A layer's cache length: cache_len, or the ring of a windowed layer,
    min(window, cache_len)."""
    return cache_len if slot.window is None else min(slot.window, cache_len)


def decode_page(cache_len: int) -> int:
    """The page of a contiguous cache of cache_len tokens viewed as a pool:
    DECODE_PAGE, or for a ring that it does not divide (a window of 12,
    say) the largest divisor of DECODE_PAGE that divides the ring (#5
    takes any page)."""
    return math.gcd(cache_len, DECODE_PAGE)


def decode_tables(batch: int, cache_len: int, device) -> torch.Tensor:
    """Block tables of a contiguous (batch, cache_len) cache viewed as a
    pool of `decode_page(cache_len)`-token pages: row b owns pages
    b*nbt .. b*nbt+nbt-1."""
    nbt = cache_len // decode_page(cache_len)
    rows = torch.arange(batch, dtype=torch.int32, device=device)[:, None]
    return rows * nbt + torch.arange(nbt, dtype=torch.int32, device=device)


def pool_view(cache: dict) -> dict:
    """A contiguous (B, L, KH, D) slot cache as a pool of
    `decode_page(L)`-token pages, sharing its storage: writes through the
    view land in the cache."""
    B, L, KH, D = cache["k"].shape
    page = decode_page(L)
    shape = (B * L // page, page, KH, D)
    return {"k": cache["k"].view(shape), "v": cache["v"].view(shape)}


def cross_view(cache: dict, tables: torch.Tensor,
               kv_lens: torch.Tensor) -> dict:
    """A cross-attention layer's {"ck", "cv"} (B, S_enc, KH, D) as the
    pool a decode step reads through #5: `pool_view`'s pages with the
    tables of `decode_tables(B, S_enc)` and kv_lens = S_enc on every row
    (the caller makes both once a step; every cross layer shares them)."""
    view = pool_view({"k": cache["ck"], "v": cache["cv"]})
    return {"ck": view["k"], "cv": view["v"], "tables": tables,
            "kv_lens": kv_lens}


_QUANT_MODE = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}


def write_pool(pool: dict, tables: torch.Tensor, write_pos: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor,
               ring: Optional[int] = None) -> None:
    """K/V (B, S, KH, D) of logical positions write_pos (B, S) into their
    pages, in place; with `ring` (a windowed layer) position p lands at
    ring slot p % ring. A quantized pool quantizes each token and head on
    its own (`quantize_kv`: absmax over D), as JAX's decode write does; its
    payload is written as bytes, which every backend indexes (float8
    included)."""
    page = (pool["k"].values if is_qtensor(pool["k"]) else pool["k"]).shape[1]
    li = write_pos if ring is None else write_pos % ring
    blk = tables.gather(1, li // page).long()
    off = li % page
    for name, x in (("k", k), ("v", v)):
        leaf = pool[name]
        if is_qtensor(leaf):
            qt = quantize_kv(x, _QUANT_MODE[leaf.values.dtype])
            leaf.values.view(torch.uint8)[blk, off] = \
                qt.values.view(torch.uint8)
            leaf.scales[blk, off] = qt.scales
        else:
            leaf[blk, off] = x.to(leaf.dtype)


def pool_init(cfg: ModelCfg, num_blocks: int, page: int,
              quant: Optional[str], device) -> dict:
    """One attention layer's zeroed block pool: K/V (num_blocks, page, KH,
    D) in cfg.cdtype, or with `quant` ('int8'/'fp8') QTensors whose scales
    start at 1.0, as JAX's `group_pool_init` makes them."""
    shape = (num_blocks, page, cfg.n_kv_heads, cfg.head_dim)

    def leaf():
        if quant is None:
            return torch.zeros(shape, dtype=cfg.cdtype, device=device)
        return QTensor(torch.zeros(shape, dtype=_storage_dtype(quant),
                                   device=device),
                       torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                                  device=device))

    return {"k": leaf(), "v": leaf()}


def apply_hadamard(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Plain Eq. 5 affine on the feature dim; (B, d) w/b broadcast over the
    sequence (one adapter per request)."""
    w, b = w.to(y.dtype), b.to(y.dtype)
    if w.dim() == 2:
        w, b = w[:, None], b[:, None]
    return y * w + b


def _lora_delta(x, a, b, alpha: float, rank: int):
    return (x @ a.to(x.dtype)) @ b.to(x.dtype) * (alpha / rank)


def apply_attn(p: dict, cfg: ModelCfg, slot: Slot, x: torch.Tensor, *,
               q_pos: torch.Tensor, cache: Optional[dict] = None,
               cache_len: Optional[int] = None,
               write_pos: Optional[torch.Tensor] = None,
               kv_lens: Optional[torch.Tensor] = None,
               tables: Optional[torch.Tensor] = None,
               concat_adapter: Optional[tuple] = None,
               adapter: Optional[dict] = None, causal: bool = True,
               kv_x: Optional[torch.Tensor] = None, impl: str = "auto"):
    """x: (B, S, d). Prefill (cache_len given), a cache-free forward
    (neither given; the encoder passes causal=False) or a step over a
    block pool (cache, write_pos (B, S), the block tables (B, nbt) int32
    and kv_lens (B,) int32 = write_pos[:, -1] + 1, shared by every
    full-range layer; a windowed layer hands #5 write_pos[:, -1] itself,
    the last query's write position; q_pos = write_pos). concat_adapter: (w, b) of an
    'attn_concat' Hadamard adapter, applied on Concat(heads) before W_O:
    one (d,) adapter through `HadamardAffine` (kernels #1/#2), per-row
    (B, d) rows in plain torch. adapter: the block's LoRA or IA3 leaves
    (cfg.adapter.kind says which). kv_x (B, S_enc, d): the encoder output
    a cross-attention sublayer attends over, at prefill or in a cache-free
    forward; a cross decode step passes `cross_view`'s pool as cache.
    Returns (y, cache)."""
    check_slot(slot)
    if kv_x is not None or (cache is not None and "ck" in cache):
        return _apply_cross(p, cfg, x, kv_x=kv_x, cache=cache,
                            cache_len=cache_len, impl=impl)
    B, S, _ = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = cfg.cdtype
    acfg = cfg.adapter
    lora = adapter if adapter is not None and acfg.kind == "lora" else None
    ia3 = adapter if adapter is not None and acfg.kind == "ia3" else None

    x = copy_to_model(x)  # a column-parallel region under a mesh
    q = qdense(x, p["wq"], cdt, impl, tag="attn/wq")
    k = qdense(x, p["wk"], cdt, impl, tag="attn/wk")
    v = qdense(x, p["wv"], cdt, impl, tag="attn/wv")
    if lora is not None:  # replicated leaves: A whole, B's rank columns
        q = q + _lora_delta(x, copy_to_model(lora["qa"]),
                            split_to_model(lora["qb"]), acfg.lora_alpha,
                            acfg.lora_rank)
        v = v + _lora_delta(x, copy_to_model(lora["va"]),
                            split_to_model(lora["vb"]), acfg.lora_alpha,
                            acfg.lora_rank)
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KH, Dh)
    v = v.reshape(B, S, KH, Dh)
    if cfg.qk_norm:
        q = rms_head_norm(copy_to_model(p["q_norm"]), q, cfg.norm_eps)
        k = rms_head_norm(copy_to_model(p["k_norm"]), k, cfg.norm_eps)
    if cfg.pos == "rope":
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    if ia3 is not None:
        k = k * split_to_model(ia3["lk"]).to(cdt).reshape(KH, Dh)
        v = v * split_to_model(ia3["lv"]).to(cdt).reshape(KH, Dh)
    scale = cfg.query_scale if cfg.query_scale is not None else Dh ** -0.5

    if cache is not None:  # write in place, attend over the pool
        if write_pos is None or tuple(write_pos.shape) != (B, S):
            raise ValueError(f"a step over a pool takes write_pos ({B}, {S})")
        ks, vs = cache["k"], cache["v"]
        quant = is_qtensor(ks)
        ring = None
        if slot.window is not None:
            page = (ks.values if quant else ks).shape[1]
            ring = min(slot.window, tables.shape[1] * page)
            kv_lens = write_pos[:, -1].to(torch.int32)
        write_pool(cache, tables, write_pos, k, v, ring)
        qh = q[:, 0] if S == 1 else q.transpose(1, 2).contiguous()
        out = ops.paged_attention(
            qh, ks.values if quant else ks, vs.values if quant else vs,
            tables, kv_lens, window=slot.window, scale=scale,
            cap=cfg.attn_softcap,
            k_scales=ks.scales if quant else None,
            v_scales=vs.scales if quant else None, impl=impl)
        if S > 1:
            out = out.transpose(1, 2)
        out = out.to(cdt).reshape(B, S, H * Dh)
        new_cache = cache
    else:  # prefill (or a cache-free forward)
        out = FlashAttention.apply(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal, slot.window, scale, cfg.attn_softcap, impl)
        out = out.transpose(1, 2).reshape(B, S, H * Dh)
        new_cache = None
        if cache_len is not None:
            if cache_len < S:
                raise ValueError(f"cache_len {cache_len} < prompt length {S}")
            size = cache_size(slot, cache_len)
            new_cache = {
                name: torch.zeros((B, size, KH, Dh), dtype=cdt,
                                  device=x.device) for name in ("k", "v")}
            # the last min(size, S) tokens: a ring holds position p at slot
            # p % size, a full-range cache at p
            tail = min(size, S)
            at = torch.arange(S - tail, S, device=x.device) % size
            new_cache["k"][:, at] = k[:, S - tail:]
            new_cache["v"][:, at] = v[:, S - tail:]

    if concat_adapter is not None:  # the rank's heads of its rows
        w, b = (split_to_model(t) for t in concat_adapter)
        out = (apply_hadamard(out, w, b) if w.dim() == 2
               else HadamardAffine.apply(out, w, b, impl))
    # row-parallel: the partial sums meet before the bias, added once
    y = reduce_from_model(qdense(out, p["wo"], cdt, impl, tag="attn/wo"))
    if "bo" in p:
        y = y + p["bo"].to(cdt)
    return y, new_cache


def _apply_cross(p: dict, cfg: ModelCfg, x: torch.Tensor, *,
                 kv_x: Optional[torch.Tensor], cache: Optional[dict],
                 cache_len: Optional[int], impl: str):
    """Cross-attention, JAX's `is_cross` branch of `apply_attn`: queries
    from x, K/V from the encoder output kv_x (no RoPE, no k_norm; a block's
    adapter never reaches it), non-causal. With cache (`cross_view`) a
    decode step reads the stored K/V through #5; else #4 attends over
    kv_x, and with cache_len the fresh {"ck", "cv"} come back."""
    B, S, _ = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = cfg.cdtype
    q = qdense(x, p["wq"], cdt, impl, tag="attn/wq")
    if "bq" in p:
        q = q + p["bq"].to(cdt)
    q = q.reshape(B, S, H, Dh)
    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
    scale = cfg.query_scale if cfg.query_scale is not None else Dh ** -0.5
    new_cache = None
    if cache is not None:
        qh = q[:, 0] if S == 1 else q.transpose(1, 2).contiguous()
        out = ops.paged_attention(qh, cache["ck"], cache["cv"],
                                  cache["tables"], cache["kv_lens"],
                                  scale=scale, cap=cfg.attn_softcap,
                                  impl=impl)
        if S > 1:
            out = out.transpose(1, 2)
        out = out.to(cdt).reshape(B, S, H * Dh)
        new_cache = cache
    else:
        k = qdense(kv_x, p["wk"], cdt, impl, tag="attn/wk")
        v = qdense(kv_x, p["wv"], cdt, impl, tag="attn/wv")
        if "bk" in p:
            k = k + p["bk"].to(cdt)
            v = v + p["bv"].to(cdt)
        k = k.reshape(B, -1, KH, Dh)
        v = v.reshape(B, -1, KH, Dh)
        out = FlashAttention.apply(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), False,
            None, scale, cfg.attn_softcap, impl)
        out = out.transpose(1, 2).reshape(B, S, H * Dh)
        if cache_len is not None:
            new_cache = {"ck": k, "cv": v}
    y = qdense(out, p["wo"], cdt, impl, tag="attn/wo")
    if "bo" in p:
        y = y + p["bo"].to(cdt)
    return y, new_cache
