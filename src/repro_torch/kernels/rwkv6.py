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

# wkv6.cu's kernels, by the code its C entry point takes
KERNELS = {"step": 0, "chunked": 1}
CHUNKED_MIN_T = 16   # from this many steps on, the chunked form
CHUNK = 16           # steps of a chunk, L (the chunked kernel's template)
COL_GROUP = 16       # value columns of the state a chunked block owns


def wkv6_plan(B: int, H: int, T: int, n: int) -> dict:
    """The launch of `wkv6.cu` for (B, H, T, n) inputs, from shapes alone:
    the kernel, its chunk L, the value columns of the state a block owns
    (`col_group`) and the `blocks`, which the C entry point launches as
    they are (it refuses a plan that does not give every (b, h) and column
    one block).

    T < CHUNKED_MIN_T (decode: T = 1) takes `step`: a block of n threads
    per (b, h), thread j holding column j of the state, the T steps one
    after another. Longer T takes `chunked`: a block per (b, h, group of
    COL_GROUP value columns), walking T in windows of 64 steps, each
    window's chunks of L = CHUNK steps computed in parallel and only the
    state's carry from chunk to chunk in sequence (T / L elementwise
    steps, not T dependent sweeps). L = 32 timed slower than 16 at every T
    from 64 to 256 on an H100: a chunk's pair sums grow as L^2."""
    if n not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head size {n} is not one the kernel is "
                         f"built for {HEAD_DIMS}")
    if T < CHUNKED_MIN_T:
        return dict(kernel="step", chunk=0, col_group=n, blocks=B * H)
    return dict(kernel="chunked", chunk=CHUNK, col_group=COL_GROUP,
                blocks=B * H * (n // COL_GROUP))


def wkv6(r, k, v, w, u, s0=None):
    """The recurrence of `ref.wkv6_ref` on CUDA tensors.

    r, k, v, w: (B, H, T, n), one dtype (fp32 or bf16), any strides with
    the last dim contiguous (the model passes (B, T, H, n) tensors
    transposed); n in HEAD_DIMS; the kernel is `wkv6_plan`'s. u: (H, n)
    fp32. s0: the (B, H, n, n) fp32 state to start from, or None for
    zeros. Returns (o, state): o (B, H,
    T, n) in r.dtype, laid out (B, T, H, n) in memory; the final fp32
    state, written over s0 when given (the decode cache is updated in
    place), else a new tensor."""
    check_inputs(NAME, r, k, v, w, u, s0, contiguous=False)
    code = check_dtype(NAME, "r", r, ACT_DTYPES)
    if r.dim() != 4:
        raise ValueError(f"{NAME}: r must be (B, H, T, n), got "
                         f"{tuple(r.shape)}")
    B, H, T, n = r.shape
    plan = wkv6_plan(B, H, T, n)
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
           B, H, T, n, strides, code, KERNELS[plan["kernel"]], plan["chunk"],
           plan["col_group"], plan["blocks"])
    return o, state
