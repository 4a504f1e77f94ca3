"""Wrapper of the fused adapter-residual-norm CUDA kernel
(`csrc/fused_adapter_norm.cu`), the port of `repro.kernels.hadamard`'s
fused forward. Its plain version is `ref.fused_adapter_residual_norm_ref`;
`ops.fused_adapter_norm` picks between them by device."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import check_dtype, check_inputs, launch, ptr

NAME = "fused_adapter_norm"
ACT_DTYPES = (torch.float32, torch.bfloat16)
VEC_DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 56 * 1024  # the fp32 row must fit the block's shared memory


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
    codes = {}
    for what, v in vecs.items():
        if v is None:
            codes[what] = 0
            continue
        if tuple(v.shape) != (d,):
            raise ValueError(f"{NAME}: {what} must have shape ({d},), got "
                             f"{tuple(v.shape)}")
        codes[what] = check_dtype(NAME, what, v, VEC_DTYPES)
    xn = torch.empty_like(x)
    h = torch.empty_like(x)
    launch(NAME, "rt_fused_adapter_norm",
           x.data_ptr(), res.data_ptr(), w.data_ptr(), codes["w"],
           b.data_ptr(), codes["b"], scale.data_ptr(), codes["scale"],
           ptr(bias), codes["bias"], xn.data_ptr(), h.data_ptr(),
           x.numel() // d, d, float(eps), code)
    return xn, h
