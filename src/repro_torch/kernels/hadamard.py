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

from repro_torch.kernels._build import (check_dtype, check_inputs, launch,
                                        library, ptr)
from repro_torch.kernels.ref import fused_adapter_residual_norm_bwd_ref

NAME = "fused_adapter_norm"
AFFINE = "hadamard_affine"
AFFINE_BWD = "hadamard_affine_bwd"
ACT_DTYPES = (torch.float32, torch.bfloat16)
VEC_DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 56 * 1024  # the fp32 row must fit the block's shared memory


def _check_vec(name: str, what: str, v: torch.Tensor, d: int) -> int:
    if tuple(v.shape) != (d,):
        raise ValueError(f"{name}: {what} must have shape ({d},), got "
                         f"{tuple(v.shape)}")
    return check_dtype(name, what, v, VEC_DTYPES)


def fused_adapter_residual_norm(x, res, w, b, scale, *, eps: float = 1e-6,
                                bias: Optional[torch.Tensor] = None):
    """x_new = x*w + b + res; h = RMSNorm(x_new)*scale, or
    LayerNorm(x_new)*scale + bias when `bias` is given. x, res: (..., d)
    of one dtype (fp32 or bf16); w, b, scale[, bias]: (d,) fp32 or bf16.
    Returns (x_new, h) in x.dtype. CUDA tensors only."""
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
    launch(NAME, "rt_fused_adapter_norm",
           x.data_ptr(), res.data_ptr(), w.data_ptr(), codes["w"],
           b.data_ptr(), codes["b"], scale.data_ptr(), codes["scale"],
           ptr(bias), codes["bias"], xn.data_ptr(), h.data_ptr(),
           x.numel() // d, d, float(eps), code)
    return xn, h


def hadamard_affine(x, w, b):
    """y = x*w + b over the trailing dim. x: (..., d) fp32 or bf16,
    contiguous; w, b: (d,) fp32 or bf16. fp32 math, y in x.dtype. CUDA
    tensors only."""
    check_inputs(AFFINE, x, w, b)
    code = check_dtype(AFFINE, "x", x, ACT_DTYPES)
    d = x.shape[-1]
    y = torch.empty_like(x)
    launch(AFFINE, "rt_hadamard_affine", x.data_ptr(),
           w.data_ptr(), _check_vec(AFFINE, "w", w, d),
           b.data_ptr(), _check_vec(AFFINE, "b", b, d),
           y.data_ptr(), x.numel() // max(d, 1), d, code)
    return y


def hadamard_affine_bwd(g, x, w):
    """The VJP of `hadamard_affine`: (dx = g*w in g.dtype, dw = sum(g*x),
    db = sum(g)), the sums fp32 (d,) over every row. g, x: (..., d) of one
    shape, each fp32 or bf16, contiguous; w: (d,). CUDA tensors only. The
    kernel sums in a fixed order, so dw/db are the same on every run."""
    check_inputs(AFFINE_BWD, g, x, w)
    g_code = check_dtype(AFFINE_BWD, "g", g, ACT_DTYPES)
    x_code = check_dtype(AFFINE_BWD, "x", x, ACT_DTYPES)
    if g.shape != x.shape:
        raise ValueError(f"{AFFINE_BWD}: g {tuple(g.shape)} must match x "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    w_code = _check_vec(AFFINE_BWD, "w", w, d)
    n = x.numel() // max(d, 1)
    chunk = library().rt_hadamard_affine_chunk_rows()
    dx = torch.empty_like(g)
    dw = torch.empty((d,), dtype=torch.float32, device=g.device)
    db = torch.empty_like(dw)
    partial = torch.empty(((n + chunk - 1) // chunk, 2, d),
                          dtype=torch.float32, device=g.device)
    launch(AFFINE_BWD, "rt_hadamard_affine_bwd", g.data_ptr(), g_code,
           x.data_ptr(), x_code, w.data_ptr(), w_code, dx.data_ptr(),
           dw.data_ptr(), db.data_ptr(), partial.data_ptr(), n, d)
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
