"""Wrapper of the fused dequantize + matmul CUDA kernel
(`csrc/dequant_matmul.cu`), the port of `repro.kernels.quant`. Its plain
version is `ref.dequant_matmul_ref`; `ops.dequant_matmul` picks between
them by device.

`DequantMatmul` is the counterpart of the JAX `custom_vjp`
(`_dqmm_fwd`/`_dqmm_bwd`): the forward is the kernel (or, on the CPU, its
plain version), the backward is dx in plain PyTorch, as `_dqmm_bwd` is jnp;
the frozen values and scales get no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check_dtype, check_inputs, launch
from repro_torch.kernels.ref import dequant_matmul_bwd_ref

NAME = "dequant_matmul"
ACT_DTYPES = (torch.float32, torch.bfloat16)
VALUE_DTYPES = (torch.int8, torch.float8_e4m3fn)


def dequant_matmul(x, values, scales):
    """y = x @ (values * scales), fp32 sums, y in x.dtype. x: (M, K) fp32
    or bf16; values: (K, N) int8 or float8_e4m3fn; scales: (1, N) or (N,)
    fp32, one per output column. All contiguous, CUDA tensors only."""
    check_inputs(NAME, x, values, scales)
    x_code = check_dtype(NAME, "x", x, ACT_DTYPES)
    v_code = check_dtype(NAME, "values", values, VALUE_DTYPES)
    check_dtype(NAME, "scales", scales, (torch.float32,))
    if x.dim() != 2 or values.dim() != 2 or x.shape[1] != values.shape[0]:
        raise ValueError(f"{NAME}: x (M, K) and values (K, N) must agree on "
                         f"K; got {tuple(x.shape)} and {tuple(values.shape)}")
    M, K = x.shape
    N = values.shape[1]
    if scales.numel() != N or scales.shape[-1] != N:
        raise ValueError(f"{NAME}: scales must be (1, {N}) or ({N},); got "
                         f"{tuple(scales.shape)}")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    launch(NAME, "rt_dequant_matmul", x.data_ptr(), x_code,
           values.data_ptr(), v_code, scales.data_ptr(), y.data_ptr(),
           M, K, N)
    return y


def _ops():
    from repro_torch.kernels import ops  # ops imports this module

    return ops


class DequantMatmul(torch.autograd.Function):
    """y = x @ (values * scales): forward #7 (`dequant_matmul`), backward
    dx = ((g * scales) @ valuesᵀ) in plain PyTorch, as `_dqmm_bwd`.

    apply(x, values, scales, impl)."""

    @staticmethod
    def forward(ctx, x, values, scales, impl: str = "auto"):
        ctx.save_for_backward(values, scales)
        return _ops().dequant_matmul(x.contiguous(), values, scales,
                                     impl=impl)

    @staticmethod
    def backward(ctx, g):
        values, scales = ctx.saved_tensors
        dx = dequant_matmul_bwd_ref(g, values, scales)
        return dx if ctx.needs_input_grad[0] else None, None, None, None
