"""Wrapper of the RWKV6 WKV recurrence CUDA kernel (`csrc/wkv6.cu`), the
port of `repro.kernels.rwkv6`. Its plain version is `ref.wkv6_ref`;
`ops.wkv6` picks between them by device.

Beyond the Pallas kernel, which starts from a zero state and returns only
`o`, the kernel takes the state in and hands the final state out: prefill
passes the state to decode, and decode carries it from tick to tick in
the cache, as the JAX model's cache does."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check_dtype, check_inputs, launch, ptr

NAME = "wkv6"
ACT_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64)  # the kernel's template instances


def wkv6(r, k, v, w, u, s0=None):
    """The recurrence of `ref.wkv6_ref` on CUDA tensors.

    r, k, v, w: (B, H, T, n), one dtype (fp32 or bf16), any strides with
    the last dim contiguous (the model passes (B, T, H, n) tensors
    transposed); n in HEAD_DIMS. u: (H, n) fp32. s0: the (B, H, n, n) fp32
    state to start from, or None for zeros. Returns (o, state): o (B, H,
    T, n) in r.dtype, laid out (B, T, H, n) in memory; the final fp32
    state, written over s0 when given (the decode cache is updated in
    place), else a new tensor."""
    check_inputs(NAME, r, k, v, w, u, s0, contiguous=False)
    code = check_dtype(NAME, "r", r, ACT_DTYPES)
    if r.dim() != 4:
        raise ValueError(f"{NAME}: r must be (B, H, T, n), got "
                         f"{tuple(r.shape)}")
    B, H, T, n = r.shape
    if n not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head size {n} is not one the kernel is "
                         f"built for {HEAD_DIMS}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.dtype != r.dtype or t.shape != r.shape or t.stride(3) != 1:
            raise ValueError(f"{NAME}: {name} must be {r.dtype} "
                             f"{tuple(r.shape)} with a contiguous last dim; "
                             f"got {t.dtype} {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if u.dtype != torch.float32 or tuple(u.shape) != (H, n) \
            or not u.is_contiguous():
        raise ValueError(f"{NAME}: u must be a contiguous fp32 ({H}, {n}); "
                         f"got {u.dtype} {tuple(u.shape)}")
    if s0 is not None and (s0.dtype != torch.float32 or tuple(s0.shape)
                           != (B, H, n, n) or not s0.is_contiguous()):
        raise ValueError(f"{NAME}: s0 must be a contiguous fp32 "
                         f"{(B, H, n, n)}; got {s0.dtype} {tuple(s0.shape)}")
    o = torch.empty((B, T, H, n), dtype=r.dtype, device=r.device).transpose(1, 2)
    state = s0 if s0 is not None else torch.empty(
        (B, H, n, n), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_long * 15)(*[s for t in (r, k, v, w, o)
                                     for s in t.stride()[:3]])
    launch(NAME, "rt_wkv6", r.data_ptr(), k.data_ptr(), v.data_ptr(),
           w.data_ptr(), u.data_ptr(), ptr(s0), state.data_ptr(), o.data_ptr(),
           B, H, T, n, strides, code)
    return o, state
