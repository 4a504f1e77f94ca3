"""Wrapper of the batched multi-task Hadamard CUDA kernel
(`csrc/multitask_hadamard.cu`), the port of `repro.kernels.multitask`. Its
plain version is `ref.multitask_hadamard_ref`; `ops.multitask_hadamard`
picks between them by device. The launch is `sparse.masked_plan`'s: the
kernel has the masked multitask kernel's layout, a thread a 16-byte
vector of x and a block along a row."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (aligned16, check_dtype, check_inputs,
                                        launch)
from repro_torch.kernels.sparse import masked_plan

NAME = "multitask_hadamard"
ACT_DTYPES = (torch.float32, torch.bfloat16)
BANK_DTYPES = (torch.float32, torch.bfloat16)


def multitask_hadamard(x, w_bank, b_bank, task_ids):
    """y[i] = x[i] * w_bank[tid[i]] + b_bank[tid[i]]. x: (B, S, d) fp32 or
    bf16; banks: (T, d) fp32 or bf16, T >= 1; task_ids: (B,) int32 in
    [0, T) (the kernel clamps one outside). The product and the sum are
    each rounded in fp32, as the plain version computes them; y in
    x.dtype. CUDA tensors only."""
    check_inputs(NAME, x, w_bank, b_bank, task_ids)
    code = check_dtype(NAME, "x", x, ACT_DTYPES)
    w_code = check_dtype(NAME, "w_bank", w_bank, BANK_DTYPES)
    b_code = check_dtype(NAME, "b_bank", b_bank, BANK_DTYPES)
    if x.dim() != 3:
        raise ValueError(f"{NAME}: x must be (B, S, d), got {tuple(x.shape)}")
    B, S, d = x.shape
    if w_bank.dim() != 2 or w_bank.shape[1] != d or w_bank.shape[0] < 1 \
            or b_bank.shape != w_bank.shape:
        raise ValueError(f"{NAME}: banks must be (T, {d}) with T >= 1; got "
                         f"{tuple(w_bank.shape)}, {tuple(b_bank.shape)}")
    if task_ids.dtype != torch.int32 or tuple(task_ids.shape) != (B,):
        raise ValueError(f"{NAME}: task_ids must be int32 ({B},); got "
                         f"{task_ids.dtype} {tuple(task_ids.shape)}")
    y = torch.empty_like(x)
    plan = masked_plan(B, S, d, x.dtype, aligned16(x, y, w_bank, b_bank))
    launch(NAME, "rt_multitask_hadamard",
           x.data_ptr(), w_bank.data_ptr(), w_code, b_bank.data_ptr(), b_code,
           task_ids.data_ptr(), y.data_ptr(), B, S, d, w_bank.shape[0], code,
           plan["vec"], plan["threads"], plan["blocks"])
    return y
