"""Dispatch layer over the kernels (port of `repro.kernels.ops`).

impl, resolved per call from the first tensor argument:
  'auto'    a CPU tensor takes the plain PyTorch version (`ref`), a CUDA
            tensor takes the hand-written kernel - and a failure there
            raises; nothing falls back to the plain version
  'kernel'  the CUDA kernel; raises on a tensor that is not on CUDA
  'ref'     the plain version on whatever device the tensor is on; what
            `chip_smoke.py` and the tests compare a kernel against. The
            serving path never passes it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import attention as _attn
from repro_torch.kernels import hadamard as _had
from repro_torch.kernels import multitask as _mt
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import rwkv6 as _rwkv6
from repro_torch.kernels import sparse as _sparse

IMPLS = ("auto", "kernel", "ref")


def use_kernel(t: torch.Tensor, impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref":
        return False
    if t.device.type == "cuda":
        return True
    if impl == "kernel" or t.device.type != "cpu":
        raise ValueError(f"no kernel for a tensor on {t.device}: the kernels "
                         "run on CUDA tensors")
    return False


def hadamard(x, w, b, impl: str = "auto"):
    """y = x*w + b over the trailing dim, out in x.dtype; see
    `ref.hadamard_ref`."""
    if use_kernel(x, impl):
        return _had.hadamard_affine(x, w, b)
    return ref.hadamard_ref(x, w, b)


def hadamard_affine_bwd(g, x, w, impl: str = "auto"):
    """(dx = g*w, dw = sum(g*x), db = sum(g)), the sums fp32 over every
    row; see `ref.hadamard_affine_bwd_ref`."""
    if use_kernel(g, impl):
        return _had.hadamard_affine_bwd(g, x, w)
    return ref.hadamard_affine_bwd_ref(g, x, w)


def fused_adapter_norm(x, res, w, b, scale, bias=None, eps: float = 1e-6,
                       impl: str = "auto"):
    """(x*w + b + res, Norm(that)*scale[+bias]); see
    `ref.fused_adapter_residual_norm_ref`."""
    if use_kernel(x, impl):
        return _had.fused_adapter_residual_norm(x, res, w, b, scale, eps=eps,
                                                bias=bias)
    return ref.fused_adapter_residual_norm_ref(x, res, w, b, scale, eps=eps,
                                               bias=bias)


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, cap: float = 0.0,
                    impl: str = "auto", return_lse: bool = False):
    """q (B, H, Sq, D) over k, v (B, KH, Skv, D), GQA by kv head h // G;
    with return_lse also each row's fp32 (B, H, Sq) log-sum-exp. See
    `ref.attention_ref`."""
    if use_kernel(q, impl):
        return _attn.flash_attention(q, k, v, causal=causal, window=window,
                                     scale=scale, cap=cap,
                                     return_lse=return_lse)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, cap=cap, return_lse=return_lse)


def paged_attention(q, k_pool, v_pool, tables, kv_lens,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, cap: float = 0.0,
                    k_scales=None, v_scales=None, impl: str = "auto"):
    """Decode attention through a block table; fp32 out. See
    `ref.paged_attention_ref`."""
    if use_kernel(q, impl):
        return _attn.paged_attention(q, k_pool, v_pool, tables, kv_lens,
                                     window=window, scale=scale, cap=cap,
                                     k_scales=k_scales, v_scales=v_scales)
    return ref.paged_attention_ref(q, k_pool, v_pool, tables, kv_lens,
                                   window=window, scale=scale, cap=cap,
                                   k_scales=k_scales, v_scales=v_scales)


def multitask_hadamard(x, w_bank, b_bank, task_ids, impl: str = "auto"):
    """y[i] = x[i]*w_bank[tid[i]] + b_bank[tid[i]]; see
    `ref.multitask_hadamard_ref`."""
    if use_kernel(x, impl):
        return _mt.multitask_hadamard(x, w_bank, b_bank, task_ids)
    return ref.multitask_hadamard_ref(x, w_bank, b_bank, task_ids)


def masked_multitask_hadamard(x, w_bank, b_bank, gate, task_ids,
                              impl: str = "auto"):
    """y[i] = x[i] + gate[t]*(x[i]*(w_bank[t]-1) + b_bank[t]), t clamped
    into each bank's rows; see `ref.masked_multitask_hadamard_ref`."""
    if use_kernel(x, impl):
        return _sparse.masked_multitask_hadamard(x, w_bank, b_bank, gate,
                                                 task_ids)
    return ref.masked_multitask_hadamard_ref(x, w_bank, b_bank, gate,
                                             task_ids)


def dequant_matmul(x, values, scales, impl: str = "auto"):
    """x @ (values * scales) with int8/fp8 values and per-output-column
    fp32 scales, fp32 sums, out in x.dtype; see `ref.dequant_matmul_ref`."""
    if use_kernel(x, impl):
        return _quant.dequant_matmul(x, values, scales)
    return ref.dequant_matmul_ref(x, values, scales)


def wkv6(r, k, v, w, u, s0=None, impl: str = "auto"):
    """The RWKV6 recurrence over (B, H, T, n) r, k, v, w from the state s0
    (zeros when None); see `ref.wkv6_ref`. Returns (o in r.dtype, the final
    fp32 state). A given s0 is updated in place to the final state and
    returned (the decode cache); a caller that keeps s0 passes a copy."""
    if use_kernel(r, impl):
        return _rwkv6.wkv6(r, k, v, w, u, s0=s0)
    o, state = ref.wkv6_ref(r, k, v, w, u, s0)
    return o, (state if s0 is None else s0.copy_(state))
