"""int8 gradient compression with error feedback (port of
`repro.optim.compression`).

Simulates a compressed data-parallel all-reduce: each gradient is
quantized to int8 with one scale per leaf before the (logical) reduction,
and the quantization error is carried to the next step, so the scheme is
unbiased over time (EF-SGD).

JAX's scale is one per leaf of its tree, where a group's per-layer
leaves are stacked on a leading dim; the port keeps one tensor per layer.
So `compress` takes one absmax over each group of port leaves that make
one JAX leaf (`group_of`, `convert.jax_path` in the train step), and
quantizes every leaf of the group with that scale; each port leaf keeps
its own fp32 error buffer. The quantization is JAX's jitted one
(`quantize_jitted`, `residual_of`), so the payloads and the errors are
JAX's byte for byte.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.quant.qtensor import quantize_jitted, residual_of

Tree = Dict[str, torch.Tensor]


def ef_init(trainable: Tree) -> Tree:
    """Zeroed fp32 error buffers over `trainable`."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in trainable.items()}


@torch.no_grad()
def compress(grads: Tree, err: Tree,
             group_of: Optional[Callable[[str], str]] = None
             ) -> Tuple[Tree, Tree]:
    """(compressed grads, new errors): each gradient plus its carried error,
    int8 fake-quantized with one scale per group (`group_of(path)`; by
    default each leaf is its own group), fp32; the new error is what the
    quantization dropped."""
    group_of = group_of or (lambda p: p)
    corrected = {k: g.to(torch.float32) + err[k] for k, g in grads.items()}
    groups: Dict[str, list] = {}
    for k in corrected:
        groups.setdefault(group_of(k), []).append(k)
    new_g, new_e = {}, {}
    for keys in groups.values():
        absmax = torch.stack([corrected[k].abs().amax() for k in keys]).amax()
        for k in keys:
            x = corrected[k]
            q = quantize_jitted(x, "int8", axis=None, absmax=absmax)
            new_g[k] = q.dequantize(torch.float32)
            new_e[k] = residual_of(x, q)
    return new_g, new_e
