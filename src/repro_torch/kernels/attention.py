"""Wrappers of the attention CUDA kernels, the port of
`repro.kernels.attention`: flash attention for prefill
(`csrc/flash_attention.cu`) and paged decode attention
(`csrc/paged_attention.cu`). Their plain versions are
`ref.attention_ref` and `ref.paged_attention_ref`; `ops` picks between
them by device. `FlashAttention` is the autograd Function of the forward,
with the tiled plain-PyTorch backward of the JAX flash module
(`flash_attention_bwd`)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import check_dtype, check_inputs, launch, ptr
from repro_torch.kernels.ref import NEG_INF

FLASH = "flash_attention"
PAGED = "paged_attention"
ACT_DTYPES = (torch.float32, torch.bfloat16)
POOL_DTYPES = (torch.float32, torch.bfloat16, torch.int8,
               torch.float8_e4m3fn)
# pools that take per-token fp32 scales (a quantized KV block)
QUANT_POOL_DTYPES = (torch.int8, torch.float8_e4m3fn)
FLASH_HEAD_DIMS = (64, 128, 256)
PAGED_HEAD_DIMS = (64, 128, 256)
SMEM_LIMIT = 227 * 1024
# paged_attention.cu: keys per split of the flash-decoding grid, and the
# warps of a split's block
PAGED_SPLIT_KEYS = 32
PAGED_WARPS = 4
# the JAX flash backward's tiles (`repro/models/flash.py:319`)
Q_CHUNK, KV_CHUNK = 512, 1024


def _check_window(name, window):
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None (got {window})")
    return -1 if window is None else int(window)


def flash_shapes(q, k, v, causal: bool = True):
    """The #4 wrapper's shape checks, on any device: q (B, H, Sq, D) over
    k, v (B, KH, Skv, D), H a multiple of KH, D in FLASH_HEAD_DIMS; a
    causal call needs Sq <= Skv (its queries are right-aligned over the
    keys, and the kernel skips key tiles past the diagonal, which would
    leave a row of Sq > Skv without a key), a non-causal one reads every
    key whatever Sq is (a decoder of more tokens than the encoder's frames
    cross-attends so). Returns (B, H, KH, Sq, Skv, D)."""
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{FLASH}: q, k, v must share one dtype "
                        f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{FLASH}: want q (B,H,Sq,D) and k, v (B,KH,Skv,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KH:
        raise ValueError(f"{FLASH}: q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"{FLASH}: head_dim {D} not in {FLASH_HEAD_DIMS}")
    if causal and Sq > Skv:
        raise ValueError(f"{FLASH}: causal Sq {Sq} > Skv {Skv} (queries are "
                         "right-aligned over the keys)")
    return B, H, KH, Sq, Skv, D


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, cap: float = 0.0,
                    return_lse: bool = False):
    """q: (B, H, Sq, D); k, v: (B, KH, Skv, D) with H = KH*G, D in {64,
    128, 256} and, for a causal call, Sq <= Skv (`flash_shapes`). Inputs
    may be strided views (a transposed (B, S, H, D) projection, say) as
    long as the last dim is contiguous and every row starts on 16 bytes.
    Returns q.dtype of shape (B, H, Sq, D), laid out in memory as (B, Sq,
    H, D) so that merging the heads back is free; with return_lse also
    each row's fp32 log-sum-exp (B, H, Sq), the residual of the backward.
    CUDA only."""
    check_inputs(FLASH, q, k, v, contiguous=False)
    code = check_dtype(FLASH, "q", q, ACT_DTYPES)
    B, H, KH, Sq, Skv, D = flash_shapes(q, k, v, causal)
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{FLASH}: {name}'s last dim must be contiguous")
        if t.data_ptr() % 16 or any(st % per16 for st in t.stride()[:3]):
            raise ValueError(f"{FLASH}: {name}'s rows must start on 16 bytes "
                             f"(strides {t.stride()})")
    win = _check_window(FLASH, window)
    scale = float(scale) if scale is not None else D ** -0.5
    out = torch.empty((B, Sq, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_long * 12)(*(s for t in (q, k, v, out)
                                     for s in t.stride()[:3]))
    launch(FLASH, "rt_flash_attention",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ptr(lse),
           B, H, KH, Sq, Skv, D, ctypes.addressof(strides), scale,
           float(cap), int(bool(causal)), win, code)
    return (out, lse) if return_lse else out


def _max_rows(D: int, itemsize: int) -> int:
    """paged_attention.cu's `Layout::RBIG`: the query rows a block takes
    when it takes more than 2, as many as 64 fp32 registers per lane hold
    (a lane loads 16 bytes of D values at a time, up to 32 lanes a key)."""
    vec = 16 // itemsize
    return 64 // (vec * (D // (vec * min(D // vec, 32))))


def paged_split_plan(B: int, H: int, KH: int, sq: int, D: int, page: int,
                     nbt: int, window: Optional[int] = None,
                     kv_dtype=torch.bfloat16) -> dict:
    """The flash-decoding grid of `paged_attention.cu`, from shapes alone
    (kv_lens stays on the card): each row's pages cut into splits of
    `pages_per_split` (PAGED_SPLIT_KEYS keys), the last split ending at
    page nbt - 1 (or the ring's last page); the G*Sq query rows of a kv
    head in chunks of `rows_per_block` (2, or as many as 64 fp32 registers
    per lane hold); `blocks` of the first kernel; the (B, H, Sq, splits,
    D + 2) fp32 scratch of the partials (acc, m, l); the shared memory of a
    block, in bytes, where its warps merge."""
    if D not in PAGED_HEAD_DIMS:
        raise ValueError(f"{PAGED}: head_dim {D} not in {PAGED_HEAD_DIMS}")
    size = nbt * page
    ring = min(window, size) if window is not None else size
    n_pages = -(-ring // page)
    pps = max(1, PAGED_SPLIT_KEYS // page)
    splits = -(-n_pages // pps)
    R = (H // KH) * sq
    rows = 2 if R <= 2 else _max_rows(D, kv_dtype.itemsize)
    chunks = -(-R // rows)
    return {"pages_per_split": pps, "splits": splits, "rows_per_block": rows,
            "row_chunks": chunks, "blocks": splits * KH * chunks * B,
            "ring": ring, "scratch_shape": (B, H, sq, splits, D + 2),
            "smem_bytes": 4 * PAGED_WARPS * rows * (D + 2)}


def paged_attention(q, k_pool, v_pool, tables, kv_lens, *,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, cap: float = 0.0,
                    k_scales=None, v_scales=None):
    """q: (B, H, D) or (B, H, Sq, D), fp32 or bf16; pools (num_blocks,
    page, KH, D), fp32/bf16, or int8 or e4m3 with fp32 per-token scales
    (num_blocks, page, KH, 1), D in {64, 128, 256}; tables (B, nbt) int32,
    a valid block id in every entry; kv_lens (B,) int32, as
    `ref.paged_attention_ref` reads them. A query row that sees no key
    (linear: kv_len - Sq + i < 0, kv_len = 0 included; ring window: no
    slot holds a position in [0, its own]) gives the fp32 mean of V,
    dequantized, over every one of the nbt*page keys its table names, as
    the Pallas kernel does. Such a row is summed by one block of the
    combine kernel, each thread walking all nbt*page keys in order with a
    table lookup a key: its time grows with the whole table, not with
    kv_len, so a caller that sends many of them at long contexts should
    time it first. Returns fp32 of q's shape. CUDA only."""
    check_inputs(PAGED, q, k_pool, v_pool, tables, kv_lens, k_scales,
                 v_scales)
    q_code = check_dtype(PAGED, "q", q, ACT_DTYPES)
    kv_code = check_dtype(PAGED, "k_pool", k_pool, POOL_DTYPES)
    squeeze = q.dim() == 3
    q4 = q[:, :, None] if squeeze else q
    if q4.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape \
            or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"{PAGED}: want q (B,H[,Sq],D) and matching pools "
                         f"(num_blocks,page,KH,D); got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, H, sq, D = q4.shape
    _, page, KH, Dk = k_pool.shape
    if Dk != D or H % KH:
        raise ValueError(f"{PAGED}: q {tuple(q.shape)} does not fit pool "
                         f"{tuple(k_pool.shape)}")
    quant = k_scales is not None
    if (k_pool.dtype in QUANT_POOL_DTYPES) != quant \
            or (v_scales is None) == quant:
        raise ValueError(f"{PAGED}: int8 or e4m3 pools need k_scales and "
                         "v_scales, and only int8 or e4m3 pools take them")
    if quant:
        want = tuple(k_pool.shape[:3]) + (1,)
        for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
            if tuple(s.shape) != want or s.dtype != torch.float32:
                raise ValueError(f"{PAGED}: {name} must be fp32 {want}; got "
                                 f"{s.dtype} {tuple(s.shape)}")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != B:
        raise ValueError(f"{PAGED}: tables must be int32 ({B}, nbt)")
    if kv_lens.dtype != torch.int32 or tuple(kv_lens.shape) != (B,):
        raise ValueError(f"{PAGED}: kv_lens must be int32 ({B},)")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{PAGED}: {name} must start on 16 bytes")
    nbt = tables.shape[1]
    win = _check_window(PAGED, window)
    plan = paged_split_plan(B, H, KH, sq, D, page, nbt, window, k_pool.dtype)
    if plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(f"{PAGED}: {plan['rows_per_block']} query rows per "
                         f"block x D={D} need {plan['smem_bytes']} B of "
                         f"shared memory (> {SMEM_LIMIT})")
    scale = float(scale) if scale is not None else D ** -0.5
    out = torch.empty((B, H, sq, D), dtype=torch.float32, device=q.device)
    part = torch.empty(plan["scratch_shape"], dtype=torch.float32,
                       device=q.device)
    launch(PAGED, "rt_paged_attention",
           q4.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
           ptr(k_scales), ptr(v_scales), tables.data_ptr(),
           kv_lens.data_ptr(), out.data_ptr(), part.data_ptr(), B, H, KH, sq,
           D, page, nbt, win, plan["ring"], scale, float(cap),
           plan["pages_per_split"], plan["splits"], plan["rows_per_block"],
           q_code, kv_code)
    return out[:, :, 0] if squeeze else out


def flash_attention_bwd(g, q, k, v, out, lse, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, cap: float = 0.0,
                        q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK):
    """The VJP of flash attention from its output and log-sum-exp, tile by
    tile as the JAX flash backward (`_flash_bwd_impl`,
    `repro/models/flash.py:182-282`) computes it: for each (q chunk, kv
    chunk) tile P is recomputed from q, k and lse, dS = P*(dP - delta)
    (times the soft-cap's derivative), dq accumulates over the kv chunks in
    order and dk, dv over the q chunks in order. Memory grows with the tile,
    (B, H, q_chunk, kv_chunk) fp32, not with Sq*Skv. Tiles masked for every
    query are skipped (their P and dS are exactly 0). Plain PyTorch, as the
    JAX backward is jnp. Shapes as `flash_attention`; lse (B, H, Sq) fp32.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    f32, dev = torch.float32, q.device
    q5 = q.to(f32).reshape(B, KH, G, Sq, D)
    g5 = g.to(f32).reshape(B, KH, G, Sq, D)
    delta = (g5 * out.to(f32).reshape(B, KH, G, Sq, D)).sum(-1)
    lse5 = lse.to(f32).reshape(B, KH, G, Sq)
    k32, v32 = k.to(f32), v.to(f32)
    dq = torch.zeros((B, KH, G, Sq, D), dtype=f32, device=dev)
    dk = torch.zeros((B, KH, Skv, D), dtype=f32, device=dev)
    dv = torch.zeros((B, KH, Skv, D), dtype=f32, device=dev)
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    for i0 in range(0, Sq, qc):
        i1 = min(i0 + qc, Sq)
        q_i, g_i = q5[..., i0:i1, :], g5[..., i0:i1, :]
        lse_i, dl_i = lse5[..., i0:i1, None], delta[..., i0:i1, None]
        qp = torch.arange(i0, i1, device=dev)[:, None] + (Skv - Sq)
        for j0 in range(0, Skv, kc):
            j1 = min(j0 + kc, Skv)
            kp = torch.arange(j0, j1, device=dev)[None, :]
            valid = torch.ones((i1 - i0, j1 - j0), dtype=torch.bool,
                               device=dev)
            if causal:
                valid &= kp <= qp
            if window is not None:
                valid &= qp - kp < window
            if causal and j0 > i1 - 1 + (Skv - Sq) or \
                    window is not None and i0 + (Skv - Sq) - (j1 - 1) >= window:
                continue  # masked for every query of the tile
            k_j, v_j = k32[:, :, j0:j1], v32[:, :, j0:j1]
            p = torch.einsum("bkgqd,bksd->bkgqs", q_i, k_j).mul_(scale)
            t = None
            if cap:
                t = torch.tanh(p / cap)
                p = t * cap
            p = p.masked_fill_(~valid, NEG_INF).sub_(lse_i).exp_()
            ds = torch.einsum("bkgqd,bksd->bkgqs", g_i, v_j)
            ds = ds.sub_(dl_i).mul_(p)
            if cap:
                ds = ds.mul_(1.0 - t.square_())
                del t
            ds = ds.masked_fill_(~valid, 0.0)
            dq[..., i0:i1, :] += torch.einsum("bkgqs,bksd->bkgqd", ds,
                                              k_j).mul_(scale)
            dk[:, :, j0:j1] += torch.einsum("bkgqs,bkgqd->bksd", ds,
                                            q_i).mul_(scale)
            dv[:, :, j0:j1] += torch.einsum("bkgqs,bkgqd->bksd", p, g_i)
            del p, ds
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Attention with forward #4 (`flash_attention`). The TPU kernel has no
    VJP; the JAX trainer differentiates through the jnp flash backward of
    `repro/models/flash.py`, so the backward here is plain PyTorch too,
    tiled as that one is (`flash_attention_bwd`: P recomputed tile by tile
    from q, k and the forward's log-sum-exp, delta from the saved output).

    apply(q, k, v, causal, window, scale, cap, impl); shapes as
    `flash_attention`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True,
                window: Optional[int] = None, scale: Optional[float] = None,
                cap: float = 0.0, impl: str = "auto"):
        from repro_torch.kernels import ops  # ops imports this module

        kw = dict(causal=causal, window=window, scale=scale, cap=cap)
        if not any(ctx.needs_input_grad[:3]):
            return ops.flash_attention(q, k, v, impl=impl, **kw)
        out, lse = ops.flash_attention(q, k, v, impl=impl, return_lse=True,
                                       **kw)
        ctx.kw = kw
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(g, q, k, v, out, lse, **ctx.kw)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None, None, None, None, None)
