"""Wrappers of the attention CUDA kernels, the port of
`repro.kernels.attention`: flash attention for prefill
(`csrc/flash_attention.cu`) and paged decode attention
(`csrc/paged_attention.cu`). Their plain versions are
`ref.attention_ref` and `ref.paged_attention_ref`; `ops` picks between
them by device."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import check_dtype, check_inputs, launch, ptr
from repro_torch.kernels.ref import attention_bwd_ref

FLASH = "flash_attention"
PAGED = "paged_attention"
ACT_DTYPES = (torch.float32, torch.bfloat16)
POOL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
FLASH_HEAD_DIMS = (64, 128, 256)
SMEM_LIMIT = 227 * 1024


def _check_window(name, window):
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None (got {window})")
    return -1 if window is None else int(window)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, cap: float = 0.0):
    """q: (B, H, Sq, D); k, v: (B, KH, Skv, D) with H = KH*G and
    Sq <= Skv; D in {64, 128, 256}. Inputs may be strided views (a
    transposed (B, S, H, D) projection, say) as long as the last dim is
    contiguous. Returns q.dtype of shape (B, H, Sq, D), laid out in memory
    as (B, Sq, H, D) so that merging the heads back is free. CUDA only."""
    check_inputs(FLASH, q, k, v, contiguous=False)
    code = check_dtype(FLASH, "q", q, ACT_DTYPES)
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
    if Sq > Skv:
        raise ValueError(f"{FLASH}: Sq {Sq} > Skv {Skv} (queries are "
                         "right-aligned over the keys)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{FLASH}: {name}'s last dim must be contiguous")
    win = _check_window(FLASH, window)
    scale = float(scale) if scale is not None else D ** -0.5
    out = torch.empty((B, Sq, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_long * 12)(*(s for t in (q, k, v, out)
                                     for s in t.stride()[:3]))
    launch(FLASH, "rt_flash_attention",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           B, H, KH, Sq, Skv, D, ctypes.addressof(strides), scale,
           float(cap), int(bool(causal)), win, code)
    return out


def paged_attention(q, k_pool, v_pool, tables, kv_lens, *,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, cap: float = 0.0,
                    k_scales=None, v_scales=None):
    """q: (B, H, D) or (B, H, Sq, D), fp32 or bf16; pools (num_blocks,
    page, KH, D), fp32/bf16, or int8 with fp32 per-token scales
    (num_blocks, page, KH, 1); tables (B, nbt) int32; kv_lens (B,) int32,
    at least Sq (every query sees a key). Returns fp32 of q's shape. CUDA
    only."""
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
    if (k_pool.dtype == torch.int8) != quant or (v_scales is None) == quant:
        raise ValueError(f"{PAGED}: int8 pools need k_scales and v_scales, "
                         "and only int8 pools take them")
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
    nbt = tables.shape[1]
    win = _check_window(PAGED, window)
    ring = min(window, nbt * page) if window is not None else nbt * page
    R = (H // KH) * sq
    smem = 4 * (2 * R * D + page * (2 * D + 1) + R * page + 3 * R)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{PAGED}: {R} query rows per kv head x D={D}, "
                         f"page {page} need {smem} B of shared memory "
                         f"(> {SMEM_LIMIT})")
    scale = float(scale) if scale is not None else D ** -0.5
    out = torch.empty((B, H, sq, D), dtype=torch.float32, device=q.device)
    launch(PAGED, "rt_paged_attention",
           q4.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
           ptr(k_scales), ptr(v_scales), tables.data_ptr(),
           kv_lens.data_ptr(), out.data_ptr(), B, H, KH, sq, D, page, nbt,
           win, ring, scale, float(cap), q_code, kv_code)
    return out[:, :, 0] if squeeze else out


class FlashAttention(torch.autograd.Function):
    """Attention with forward #4 (`flash_attention`). The TPU kernel has no
    VJP; the JAX trainer differentiates through the jnp flash backward of
    `repro/models/flash.py`, so the backward here is plain PyTorch too
    (`ref.attention_bwd_ref`: P recomputed from q and k, delta from the
    saved output).

    apply(q, k, v, causal, window, scale, cap, impl); shapes as
    `flash_attention`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True,
                window: Optional[int] = None, scale: Optional[float] = None,
                cap: float = 0.0, impl: str = "auto"):
        from repro_torch.kernels import ops  # ops imports this module

        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  scale=scale, cap=cap, impl=impl)
        ctx.kw = dict(causal=causal, window=window, scale=scale, cap=cap)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = attention_bwd_ref(g, q, k, v, out, **ctx.kw)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None, None, None, None, None)
