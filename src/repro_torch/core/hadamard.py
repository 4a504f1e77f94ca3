"""Hadamard-adapter operations a deployment needs (port of
`repro.core.hadamard`, the serving subset): static multi-task banks and
synthetic task variants.

`select_tasks` has no port: the bank stays stacked and the multitask
kernel (`kernels/multitask.py`) reads each request's row straight out of
it. Folding, deltas and the registry helpers come with later slices.
"""
from __future__ import annotations

import re
import zlib
from typing import List

import torch

from repro_torch.common import tree as tu

ADAPTER_RE = re.compile(r"/adapter/")


def build_bank(param_list: List[dict]) -> dict:
    """Stack T tasks' params into a bank: each layer's adapter leaves
    (d,) -> (T, d). Every other leaf must be shared and is taken from
    task 0."""
    flat = [dict(tu.flatten_with_paths(p)) for p in param_list]

    def stack(path, leaf):
        if ADAPTER_RE.search("/" + path):
            return torch.stack([f[path] for f in flat], dim=-2)
        return leaf

    return tu.map_with_path(stack, param_list[0])


def perturb_adapters(params: dict, seed: int, scale: float = 0.05,
                     leaves=("w", "b")) -> dict:
    """A synthetic 'fine-tuned' task variant: every Hadamard adapter leaf
    shifted by scale * N(0, 1). Each leaf draws from its own CPU generator
    seeded by (seed, crc32 of its path), so a variant is the same on every
    device. Returns a new tree; `params` is not modified."""
    pat = re.compile(r"/adapter/(%s)$" % "|".join(leaves))

    def one(path, leaf):
        if not pat.search("/" + path):
            return leaf
        g = torch.Generator().manual_seed(
            (int(seed) * 1_000_003 + zlib.crc32(path.encode())) % (1 << 63))
        noise = torch.randn(leaf.shape, generator=g, dtype=torch.float32)
        return (leaf.float() + scale * noise.to(leaf.device)).to(leaf.dtype)

    return tu.map_with_path(one, params)
