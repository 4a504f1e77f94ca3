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
                    impl: str = "auto"):
    """q (B, H, Sq, D) over k, v (B, KH, Skv, D), GQA by kv head h // G;
    see `ref.attention_ref`."""
    if use_kernel(q, impl):
        return _attn.flash_attention(q, k, v, causal=causal, window=window,
                                     scale=scale, cap=cap)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, cap=cap)


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
