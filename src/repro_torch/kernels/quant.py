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

from repro_torch.kernels._build import SMS, check_dtype, check_inputs, launch
from repro_torch.kernels.ref import dequant_matmul_bwd_ref

NAME = "dequant_matmul"
ACT_DTYPES = (torch.float32, torch.bfloat16)
VALUE_DTYPES = (torch.int8, torch.float8_e4m3fn)

# dequant_matmul.cu's kernels, by the code its C entry point takes
KERNELS = {"ffma_small": 0, "ffma_tiled": 1, "mma_stream": 2, "mma_tiled": 3}
MAX_SMALL_M = 8      # rows that take the decode kernels
MAX_CLUSTER = 8      # the portable cluster size: the split-K ranks
STRIP = 128          # mma_stream and ffma_small: columns of a block
STREAM_WARPS = 4     # mma_stream: warps of a block, each a K part
STREAM_K = 16        # mma_stream: K rows a warp takes per MMA step
STREAM_BLOCKS = 96   # mma_stream: blocks the K split aims at
TILE = (64, 64)      # mma_tiled: block tile (dequant_matmul.cu's TiledLayout)
TILE_K = 64          # mma_tiled: K depth of a tile (dequant_matmul.cu's BK)
TILED_BLOCKS = 330   # mma_tiled: blocks the K split aims at
# ffma_small's fixed K split: 8 cluster ranks of 8 warps; ffma_tiled's
# 32 x 64 tiles
FFMA_CLUSTER, FFMA_WARPS, FFMA_TILE = 8, 8, (32, 64)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dequant_matmul_plan(M: int, K: int, N: int, x_dtype=torch.bfloat16,
                        v_dtype=torch.int8) -> dict:
    """The launch of `dequant_matmul.cu` for y (M, N) = x (M, K) @ values
    (K, N), from shapes and dtypes alone: the kernel, its `grid`, its
    `cluster` size and `k_per_part`, the K rows of one part, which the C
    entry point launches as they are (it refuses a plan that does not cover
    every output and K row once). `tile` is the (rows, columns) of y a
    block owns, for reading; the kernel fixes it.

    fp32 x stays on the FFMA units (bf16 or TF32 tensor cores would break
    its 1e-5-of-max-|y| tolerance): `ffma_small` for M <= 8 (K cut into
    FFMA_CLUSTER x FFMA_WARPS parts), `ffma_tiled` above. bf16 x runs on
    the tensor cores (`mma.sync` m16n8k16, fp32 sums; every int8 and e4m3
    value is exact in bf16):
      `mma_stream`, M <= 8: blocks of STREAM_WARPS warps on a STRIP-column
        strip, K cut into cluster x warps contiguous parts of `k_per_part`
        rows (whole MMA steps); the parts' sums added in a fixed order
        through distributed shared memory. The cluster is the smallest that
        puts STREAM_BLOCKS blocks on the card, capped at MAX_CLUSTER and at
        one MMA step a warp.
      `mma_tiled`, M > 8: TILE output tiles, K split over the `cluster`
        ranks of a thread-block cluster (k_per_part rows each, a multiple
        of TILE_K), summed in rank order: the smallest split that puts
        TILED_BLOCKS blocks on the card, capped at MAX_CLUSTER and at two K
        tiles a rank.
    STREAM_BLOCKS and TILED_BLOCKS are the fills that timed fastest on an
    H100 at qwen3-0.6b's shapes (a second pass over more K splits timed
    slower than the cluster alone), not a full wave of SMS.
    Every output is written once, by one block; no atomics."""
    if x_dtype not in ACT_DTYPES or v_dtype not in VALUE_DTYPES:
        raise TypeError(f"{NAME}: no kernel for x {x_dtype}, values {v_dtype}")
    if x_dtype == torch.float32:
        if M <= MAX_SMALL_M:
            return dict(kernel="ffma_small", tensor_cores=False,
                        tile=(M, STRIP), grid=(_cdiv(N, STRIP), FFMA_CLUSTER, 1),
                        cluster=FFMA_CLUSTER,
                        k_per_part=_cdiv(K, FFMA_CLUSTER * FFMA_WARPS))
        bm, bn = FFMA_TILE
        return dict(kernel="ffma_tiled", tensor_cores=False, tile=FFMA_TILE,
                    grid=(_cdiv(N, bn), _cdiv(M, bm), 1), cluster=1,
                    k_per_part=K)
    if M <= MAX_SMALL_M:
        strips = _cdiv(N, STRIP)
        steps = _cdiv(K, STREAM_K)
        most = max(1, min(MAX_CLUSTER, steps // STREAM_WARPS))
        cluster = min(most, _cdiv(STREAM_BLOCKS, strips))
        return dict(kernel="mma_stream", tensor_cores=True, tile=(M, STRIP),
                    grid=(strips, cluster, 1), cluster=cluster,
                    k_per_part=STREAM_K * _cdiv(steps, cluster * STREAM_WARPS))
    ktiles = _cdiv(K, TILE_K)
    bm, bn = TILE
    tiles = _cdiv(M, bm) * _cdiv(N, bn)
    most = max(1, min(MAX_CLUSTER, ktiles // 2))
    cluster = min(most, _cdiv(TILED_BLOCKS, tiles))
    return dict(kernel="mma_tiled", tensor_cores=True, tile=TILE,
                grid=(_cdiv(N, bn), _cdiv(M, bm), cluster), cluster=cluster,
                k_per_part=TILE_K * _cdiv(ktiles, cluster))


def dequant_matmul(x, values, scales):
    """y = x @ (values * scales), fp32 sums, y in x.dtype. x: (M, K) fp32
    or bf16; values: (K, N) int8 or float8_e4m3fn; scales: (1, N) or (N,)
    fp32, one per output column. All contiguous, CUDA tensors only. The
    launch is `dequant_matmul_plan`'s."""
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
    plan = dequant_matmul_plan(M, K, N, x.dtype, values.dtype)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    launch(NAME, "rt_dequant_matmul", x.data_ptr(), x_code,
           values.data_ptr(), v_code, scales.data_ptr(), y.data_ptr(),
           M, K, N, KERNELS[plan["kernel"]], *plan["grid"], plan["cluster"],
           plan["k_per_part"])
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
