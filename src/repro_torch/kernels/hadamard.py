"""Wrappers of the Hadamard-adapter CUDA kernels, the port of
`repro.kernels.hadamard`: the fused adapter-residual-norm forward
(`csrc/fused_adapter_norm.cu`) and the plain affine forward and backward
(`csrc/hadamard_affine.cu`). Their plain versions are in `ref`; `ops`
picks between them by device.

The autograd Functions at the bottom are the counterparts of the JAX
`custom_vjp`s (`_had_fwd`/`_had_bwd`, `_fused_fwd`/`_fused_bwd`). They
call `ops.*` with the caller's `impl`, so on the CPU the same Function runs
the plain versions and its backward is tested there.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels._build import (SMS, aligned16, check_dtype,
                                        check_inputs, full_vec, launch, ptr)
from repro_torch.kernels.ref import fused_adapter_residual_norm_bwd_ref

NAME = "fused_adapter_norm"
AFFINE = "hadamard_affine"
AFFINE_BWD = "hadamard_affine_bwd"
ACT_DTYPES = (torch.float32, torch.bfloat16)
VEC_DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 56 * 1024  # split_row: the fp32 row must fit the block's shared memory

# fused_adapter_norm.cu's kernels, by the code its C entry point takes
NORM_KERNELS = {"warp_row": 0, "split_row": 1}
WARP_ROW_WARPS = (1, 2, 4)  # warp_row: the warps a row may span
MAX_LANE_ELEMS = 32        # warp_row: elements of a row a lane holds, at most
WARP_ROW_THREADS = 128     # warp_row: threads of a block, at most
SPLIT_LANE_VECS = 4        # split_row: vectors of a row a thread aims at

# hadamard_affine.cu's grid (affine_plan, affine_bwd_plan)
AFFINE_LANES = 32      # threads across a column tile, a vector each
AFFINE_MAX_WARPS = 8   # warps down a block's rows, at most
AFFINE_UNROLLS = (2, 4)  # rows a thread has in flight: the kernels' instances
AFFINE_BLOCKS_PER_SM = 4      # #1
AFFINE_BWD_BLOCKS_PER_SM = 2  # #2: fewer chunks for the last block to sum


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fused_norm_plan(n: int, d: int, dtype=torch.bfloat16,
                    aligned: bool = True) -> dict:
    """The launch of `fused_adapter_norm.cu` for n rows of d elements of
    `dtype`, from shapes alone: the kernel, `vec` (elements a load: 16
    bytes, or 1 where d is not a multiple of that or `aligned` is False, a
    pointer that takes no 16-byte access), `warps_per_row`,
    `rows_per_block` and `blocks`, which the C entry point launches as they
    are (it refuses a plan that does not cover every row once).

    `warp_row` holds a row in registers, at most MAX_LANE_ELEMS elements a
    lane, on the fewest of WARP_ROW_WARPS warps that split it into whole
    16-byte vectors a lane: 1 warp for qwen3's 1024 bf16 and bert-base's
    768 fp32, 2 for rwkv6's 2048 bf16. Rows share a block, up to
    WARP_ROW_THREADS threads, only as far as the rows still give every SM
    a block. Other widths (ragged, over 4096, or vec = 1) take `split_row`:
    a block a row, the fp32 row in shared memory, warps enough for
    SPLIT_LANE_VECS vectors a thread, at most 32."""
    full = full_vec(dtype)
    vec = full if aligned and d % full == 0 else 1
    if vec > 1:
        for wpr in WARP_ROW_WARPS:
            lanes = 32 * wpr
            if d % (lanes * vec) == 0 and d // lanes <= MAX_LANE_ELEMS:
                rpb = max(1, min(WARP_ROW_THREADS // lanes, n // SMS))
                return dict(kernel="warp_row", vec=vec, warps_per_row=wpr,
                            rows_per_block=rpb, blocks=_cdiv(n, rpb))
    wpr = min(32, max(1, _cdiv(d // vec, 32 * SPLIT_LANE_VECS)))
    return dict(kernel="split_row", vec=vec, warps_per_row=wpr,
                rows_per_block=1, blocks=n)


def _check_vec(name: str, what: str, v: torch.Tensor, d: int) -> int:
    if tuple(v.shape) != (d,):
        raise ValueError(f"{name}: {what} must have shape ({d},), got "
                         f"{tuple(v.shape)}")
    return check_dtype(name, what, v, VEC_DTYPES)


def fused_adapter_residual_norm(x, res, w, b, scale, *, eps: float = 1e-6,
                                bias: Optional[torch.Tensor] = None,
                                plan: Optional[dict] = None):
    """x_new = x*w + b + res; h = RMSNorm(x_new)*scale, or
    LayerNorm(x_new)*scale + bias when `bias` is given. x, res: (..., d)
    of one dtype (fp32 or bf16); w, b, scale[, bias]: (d,) fp32 or bf16.
    Returns (x_new, h) in x.dtype. CUDA tensors only. The launch is
    `fused_norm_plan`'s, 16-byte loads where every pointer allows them, or
    `plan` where one is given (to time another; the C entry point refuses
    a plan that does not cover every row once)."""
    check_inputs(NAME, x, res, w, b, scale, bias)
    code = check_dtype(NAME, "x", x, ACT_DTYPES)
    if res.dtype != x.dtype or res.shape != x.shape:
        raise ValueError(f"{NAME}: res must match x ({x.shape}, {x.dtype}); "
                         f"got {tuple(res.shape)}, {res.dtype}")
    d = x.shape[-1]
    if not 0 < d <= MAX_D:
        raise ValueError(f"{NAME}: feature dim {d} outside (0, {MAX_D}]")
    vecs = {"w": w, "b": b, "scale": scale, "bias": bias}
    codes = {what: 0 if v is None else _check_vec(NAME, what, v, d)
             for what, v in vecs.items()}
    xn = torch.empty_like(x)
    h = torch.empty_like(x)
    n = x.numel() // d
    plan = plan or fused_norm_plan(n, d, x.dtype,
                                   aligned16(x, res, w, b, scale, bias, xn, h))
    launch(NAME, "rt_fused_adapter_norm",
           x.data_ptr(), res.data_ptr(), w.data_ptr(), codes["w"],
           b.data_ptr(), codes["b"], scale.data_ptr(), codes["scale"],
           ptr(bias), codes["bias"], xn.data_ptr(), h.data_ptr(),
           n, d, float(eps), code, NORM_KERNELS[plan["kernel"]], plan["vec"],
           plan["warps_per_row"], plan["rows_per_block"], plan["blocks"])
    return xn, h


def affine_grid(n: int, d: int, vec: int, blocks_per_sm: int) -> dict:
    """The grid of `hadamard_affine.cu`'s kernels over n rows of d: column
    tiles of AFFINE_LANES vectors of `vec`; AFFINE_MAX_WARPS warps down a
    block's rows, one a row below that many rows (no warp without a row);
    row chunks of `rows_per_block` (a multiple of the warps) such that the
    blocks come to about `blocks_per_sm` an SM, and no more chunks than
    give every thread two rows; `unroll`, the rows a thread has in flight,
    4 where a thread has 16 rows or more, else 2 (what timed fastest at
    every seam of the two kernels). n == 0: one chunk of no rows."""
    tiles = _cdiv(d // vec, AFFINE_LANES)
    warps = max(1, min(AFFINE_MAX_WARPS, n))
    chunks = max(1, min(_cdiv(n, 2 * warps),
                        _cdiv(blocks_per_sm * SMS, tiles)))
    rows = warps * _cdiv(_cdiv(max(n, 1), chunks), warps)
    chunks = max(1, _cdiv(n, rows))
    unroll = AFFINE_UNROLLS[-1] if rows // warps >= 16 else AFFINE_UNROLLS[0]
    return dict(vec=vec, warps=warps, unroll=unroll, rows_per_block=rows,
                tile_cols=AFFINE_LANES * vec, col_tiles=tiles, chunks=chunks,
                blocks=chunks * tiles)


def affine_plan(n: int, d: int, dtype=torch.bfloat16,
                aligned: bool = True) -> dict:
    """The launch of #1 (`affine_fwd_kernel`) for n rows of d elements of
    `dtype`, from shapes alone: `vec` (16 bytes: 8 bf16, 4 fp32; 1 where d
    is not a multiple of that or `aligned` is False, a pointer off the
    16-byte grid), `warps`, `unroll`, `rows_per_block`, `chunks` and
    `blocks` (`affine_grid`'s, AFFINE_BLOCKS_PER_SM blocks an SM), which
    the C entry point launches as they are (it refuses a plan that does not
    cover every row and column once). gemma2-27b's 2-row decode: 18 blocks
    of 2 warps; its 4160-row prefill: 522 blocks of 8 warps, 18 rows a
    thread, 4 in flight; bert-base's 4096 rows of 768 fp32: 516 blocks, 6
    rows a thread, 2 in flight."""
    full = full_vec(dtype)
    vec = full if aligned and d % full == 0 else 1
    return affine_grid(n, d, vec, AFFINE_BLOCKS_PER_SM)


def affine_bwd_plan(n: int, d: int, g_dtype=torch.float32,
                    x_dtype=torch.bfloat16, aligned: bool = True) -> dict:
    """The launch of #2 (`affine_bwd_kernel`) for g, x of n rows of d, as
    `affine_plan` with `vec` 16 bytes of the wider of g and x (4 with any
    fp32 operand, 8 for bf16 alone), AFFINE_BWD_BLOCKS_PER_SM blocks an SM,
    and `partial`, the shape of the fp32 scratch of per-chunk sums, (chunks,
    2, d). Fewer blocks an SM than #1: each chunk is a partial that the last
    block of its column tile sums. whisper-tiny's seam (12000, 384): 252
    blocks, 3 tiles of 84 chunks of 144 rows, 4 in flight a thread."""
    full = 16 // max(g_dtype.itemsize, x_dtype.itemsize)
    vec = full if aligned and d % full == 0 else 1
    plan = affine_grid(n, d, vec, AFFINE_BWD_BLOCKS_PER_SM)
    return dict(plan, partial=(plan["chunks"], 2, d))


def _plan_args(plan: dict):
    return (plan["vec"], plan["warps"], plan["unroll"],
            plan["rows_per_block"], plan["chunks"], plan["blocks"])


def hadamard_affine(x, w, b):
    """y = x*w + b over the trailing dim. x: (..., d) fp32 or bf16,
    contiguous; w, b: (d,) fp32 or bf16. fp32 math, y in x.dtype. CUDA
    tensors only. The launch is `affine_plan`'s, 16-byte loads where x, y,
    w and b allow them."""
    check_inputs(AFFINE, x, w, b)
    code = check_dtype(AFFINE, "x", x, ACT_DTYPES)
    d = x.shape[-1]
    w_code, b_code = _check_vec(AFFINE, "w", w, d), _check_vec(AFFINE, "b", b, d)
    y = torch.empty_like(x)
    n = x.numel() // max(d, 1)
    plan = affine_plan(n, d, x.dtype, aligned16(x, y, w, b))
    launch(AFFINE, "rt_hadamard_affine", x.data_ptr(), w.data_ptr(), w_code,
           b.data_ptr(), b_code, y.data_ptr(), n, d, code, *_plan_args(plan))
    return y


def hadamard_affine_bwd(g, x, w):
    """The VJP of `hadamard_affine`: (dx = g*w in g.dtype, dw = sum(g*x),
    db = sum(g)), the sums fp32 (d,) over every row. g, x: (..., d) of one
    shape, each fp32 or bf16, contiguous; w: (d,). CUDA tensors only. One
    launch of `affine_bwd_plan`'s plan, which sums in a fixed order, so
    dw/db are the same on every run."""
    check_inputs(AFFINE_BWD, g, x, w)
    g_code = check_dtype(AFFINE_BWD, "g", g, ACT_DTYPES)
    x_code = check_dtype(AFFINE_BWD, "x", x, ACT_DTYPES)
    if g.shape != x.shape:
        raise ValueError(f"{AFFINE_BWD}: g {tuple(g.shape)} must match x "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    w_code = _check_vec(AFFINE_BWD, "w", w, d)
    n = x.numel() // max(d, 1)
    dx = torch.empty_like(g)
    dw = torch.empty((d,), dtype=torch.float32, device=g.device)
    db = torch.empty_like(dw)
    plan = affine_bwd_plan(n, d, g.dtype, x.dtype, aligned16(g, x, dx, w))
    partial = torch.empty(plan["partial"], dtype=torch.float32,
                          device=g.device)
    launch(AFFINE_BWD, "rt_hadamard_affine_bwd", g.data_ptr(), g_code,
           x.data_ptr(), x_code, w.data_ptr(), w_code, dx.data_ptr(),
           dw.data_ptr(), db.data_ptr(), partial.data_ptr(), n, d,
           *_plan_args(plan))
    return dx, dw, db


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def _ops():
    from repro_torch.kernels import ops  # ops imports this module

    return ops


class HadamardAffine(torch.autograd.Function):
    """y = x*w + b: forward #1 (`hadamard_affine`), backward #2
    (`hadamard_affine_bwd`), as `_had_fwd`/`_had_bwd`."""

    @staticmethod
    def forward(ctx, x, w, b, impl: str = "auto"):
        x = x.contiguous()
        ctx.impl, ctx.b_dtype = impl, b.dtype
        ctx.save_for_backward(x, w)
        return _ops().hadamard(x, w, b, impl=impl)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw, db = _ops().hadamard_affine_bwd(g.contiguous(), x, w,
                                                impl=ctx.impl)
        need = ctx.needs_input_grad
        return (dx.to(x.dtype) if need[0] else None,
                dw.to(w.dtype) if need[1] else None,
                db.to(ctx.b_dtype) if need[2] else None, None)


class FusedAdapterResidualNorm(torch.autograd.Function):
    """(x_new, h) = (x*w + b + res, Norm(x_new)*scale [+bias]): forward #3
    (`fused_adapter_norm`). The backward, as `_fused_bwd`, is the norm VJP
    in plain torch (jnp in JAX, outside any Pallas kernel), then #2 for
    dx/dw/db; dres = gt. An incoming gradient of None (an output the
    caller discards) counts as zeros.

    apply(x, res, w, b, scale, bias, eps, impl); bias None -> RMSNorm."""

    @staticmethod
    def forward(ctx, x, res, w, b, scale, bias=None, eps: float = 1e-6,
                impl: str = "auto"):
        x = x.contiguous()
        xn, h = _ops().fused_adapter_norm(x, res, w, b, scale, bias=bias,
                                          eps=eps, impl=impl)
        ctx.eps, ctx.impl = eps, impl
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w, b, scale, bias, xn)
        return xn, h

    @staticmethod
    def backward(ctx, g_xn, g_h):
        x, w, b, scale, bias, xn = ctx.saved_tensors
        grads = fused_adapter_residual_norm_bwd_ref(
            g_xn, torch.zeros_like(xn) if g_h is None else g_h, x, w, b,
            scale, xn, eps=ctx.eps, bias=bias,
            affine_bwd=functools.partial(_ops().hadamard_affine_bwd,
                                         impl=ctx.impl))
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad)) \
            + (None, None)
