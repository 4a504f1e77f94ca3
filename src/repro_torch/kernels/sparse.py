"""Wrapper of the masked multi-task Hadamard CUDA kernel
(`csrc/masked_multitask_hadamard.cu`), the port of `repro.kernels.sparse`,
and its autograd Function. The plain version is
`ref.masked_multitask_hadamard_ref`; `ops.masked_multitask_hadamard`
picks between them by device.

The kernel serves a bank whose pruned tenants' rows are gated off
(`AdapterBank.gates()`): y = x + g[t]*(x*(w[t]-1) + b[t]). The w, b and
gate row counts may differ (a shared-w bank has one w row); each task id
is clamped into each, as the JAX serving tick's `select_tasks` clamps.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (aligned16, check_dtype, check_inputs,
                                        full_vec, launch)

NAME = "masked_multitask_hadamard"
ACT_DTYPES = (torch.float32, torch.bfloat16)
BANK_DTYPES = (torch.float32, torch.bfloat16)
MAX_THREADS = 256  # threads of a block, at most


def masked_plan(B: int, S: int, d: int, dtype=torch.bfloat16,
                aligned: bool = True) -> dict:
    """The launch of `masked_multitask_hadamard.cu` and of
    `multitask_hadamard.cu` (one layout: a thread a vector of x, a request
    blockIdx.y) for x (B, S, d) of `dtype`, from shapes alone: `vec` (elements a thread: one 16-byte
    load, or 1 where d is not a multiple of that or `aligned` is False, a
    pointer that takes no 16-byte access), `threads` a block and `blocks`
    in all, B * blocks_per_request, which the C entry point launches as
    they are (it refuses a plan that does not cover every element once).

    A block spans a row of d (128 threads for 1024 bf16, 256 for fp32), at
    most MAX_THREADS: a 4-slot decode tick runs a block per request, a
    128-token prefill ~128 blocks, about one an SM."""
    full = full_vec(dtype)
    vec = full if aligned and d % full == 0 else 1
    vecs = S * d // vec  # vectors of a request
    row = min(vecs, -(-d // vec))  # vectors of a row, at most the request's
    threads = min(MAX_THREADS, 32 * -(-row // 32))
    return dict(vec=vec, threads=threads, blocks=B * -(-vecs // threads))


def masked_multitask_hadamard(x, w_bank, b_bank, gate, task_ids):
    """y[i] = x[i] + gate[t]*(x[i]*(w_bank[t] - 1) + b_bank[t]), t =
    task_ids[i] clamped into each bank's rows. x: (B, S, d) fp32 or bf16;
    w_bank: (Tw, d), b_bank: (Tb, d) fp32 or bf16; gate: (Tg,) fp32;
    task_ids: (B,) int32. fp32 math, y in x.dtype. CUDA tensors only. The
    launch is `masked_plan`'s, 16-byte loads where every pointer allows
    them."""
    check_inputs(NAME, x, w_bank, b_bank, gate, task_ids)
    code = check_dtype(NAME, "x", x, ACT_DTYPES)
    w_code = check_dtype(NAME, "w_bank", w_bank, BANK_DTYPES)
    b_code = check_dtype(NAME, "b_bank", b_bank, BANK_DTYPES)
    if x.dim() != 3:
        raise ValueError(f"{NAME}: x must be (B, S, d), got {tuple(x.shape)}")
    B, S, d = x.shape
    for what, bank in (("w_bank", w_bank), ("b_bank", b_bank)):
        if bank.dim() != 2 or bank.shape[1] != d or bank.shape[0] < 1:
            raise ValueError(f"{NAME}: {what} must be (T, {d}) with T >= 1; "
                             f"got {tuple(bank.shape)}")
    if gate.dtype != torch.float32 or gate.dim() != 1 or gate.numel() < 1:
        raise ValueError(f"{NAME}: gate must be fp32 (T,); got {gate.dtype} "
                         f"{tuple(gate.shape)}")
    if task_ids.dtype != torch.int32 or tuple(task_ids.shape) != (B,):
        raise ValueError(f"{NAME}: task_ids must be int32 ({B},); got "
                         f"{task_ids.dtype} {tuple(task_ids.shape)}")
    y = torch.empty_like(x)
    plan = masked_plan(B, S, d, x.dtype, aligned16(x, y, w_bank, b_bank))
    launch(NAME, "rt_masked_multitask_hadamard",
           x.data_ptr(), w_bank.data_ptr(), w_code, w_bank.shape[0],
           b_bank.data_ptr(), b_code, b_bank.shape[0], gate.data_ptr(),
           gate.shape[0], task_ids.data_ptr(), y.data_ptr(), B, S, d, code,
           plan["vec"], plan["threads"], plan["blocks"])
    return y


def masked_multitask_hadamard_bwd(dy, x, w_bank, gate, task_ids, impl):
    """The VJP of the masked multitask op, as the JAX `_bwd` of
    `kernels/sparse.py` computes it: dx runs the forward op on dy with
    b = 0 (dy + g*(dy*(w-1)) = (g*w + 1 - g)*dy); dw and db are the
    gate-weighted fp32 sums over S of dy*x and dy per request, summed per
    task by a one-hot matmul (a fixed order: no atomics, the same bits on
    every run). Returns (dx in x.dtype, dw, db) with dw/db fp32 (T, d)."""
    from repro_torch.kernels import ops  # ops imports this module

    T = w_bank.shape[0]
    b0 = torch.zeros((T, w_bank.shape[1]), dtype=w_bank.dtype,
                     device=w_bank.device)
    dx = ops.masked_multitask_hadamard(dy, w_bank, b0, gate, task_ids,
                                       impl=impl)
    ids = task_ids.long()
    g = gate.to(torch.float32)[ids][:, None]  # (B, 1)
    dy32 = dy.to(torch.float32)
    per_w = g * (dy32 * x.to(torch.float32)).sum(1)  # (B, d)
    per_b = g * dy32.sum(1)
    onehot = (ids[None, :] == torch.arange(T, device=ids.device)[:, None]
              ).to(torch.float32)  # (T, B)
    return dx.to(x.dtype), onehot @ per_w, onehot @ per_b


class MaskedMultitaskHadamard(torch.autograd.Function):
    """y = x + g[t]*(x*(w[t]-1) + b[t]): forward #9
    (`masked_multitask_hadamard`), the backward as the JAX custom VJP
    (`masked_multitask_hadamard_bwd`). The gate and the task ids get no
    gradient. The backward takes the Pallas VJP's shapes: w, b and gate
    of one row count T.

    apply(x, w_bank, b_bank, gate, task_ids, impl)."""

    @staticmethod
    def forward(ctx, x, w_bank, b_bank, gate, task_ids, impl: str = "auto"):
        from repro_torch.kernels import ops

        x = x.contiguous()
        ctx.impl, ctx.b_dtype = impl, b_bank.dtype
        ctx.save_for_backward(x, w_bank, gate, task_ids)
        ctx.rows = (w_bank.shape[0], b_bank.shape[0], gate.shape[0])
        return ops.masked_multitask_hadamard(x, w_bank, b_bank, gate,
                                             task_ids, impl=impl)

    @staticmethod
    def backward(ctx, dy):
        x, w_bank, gate, task_ids = ctx.saved_tensors
        if len(set(ctx.rows)) != 1:
            raise ValueError(
                f"{NAME}: the backward needs w, b and gate of one row count "
                f"(got {ctx.rows}); a shared-w bank serves, it does not train")
        dx, dw, db = masked_multitask_hadamard_bwd(
            dy.contiguous(), x, w_bank, gate, task_ids, ctx.impl)
        need = ctx.needs_input_grad
        return (dx if need[0] else None,
                dw.to(w_bank.dtype) if need[1] else None,
                db.to(ctx.b_dtype) if need[2] else None, None, None, None)
