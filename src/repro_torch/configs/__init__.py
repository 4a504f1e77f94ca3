"""Architecture registry: --arch <id> resolution for launchers and tests.

The port carries the architectures its slices serve; the other `repro`
configs arrive with the slices that run them.
"""
from __future__ import annotations

from repro_torch.common.types import ModelCfg
from repro_torch.configs import qwen3_0_6b

ASSIGNED = {
    "qwen3-0.6b": qwen3_0_6b,
}


def list_archs():
    return sorted(ASSIGNED)


def get(name: str) -> ModelCfg:
    if name in ASSIGNED:
        return ASSIGNED[name].config()
    raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")


def get_smoke(name: str) -> ModelCfg:
    if name in ASSIGNED:
        return ASSIGNED[name].smoke()
    raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
