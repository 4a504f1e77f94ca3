"""Cost-measurement mode (port of `repro.common.costmode`).

The dry run (`launch/dryrun.py`) counts a step's FLOPs with
`torch.utils.flop_counter.FlopCounterMode` over parameters and inputs on
the meta device, which hold shapes and no storage. Inside `cost_mode_ctx`:

  * `kernels.ops.use_kernel` sends a meta tensor to the kernel's plain
    version, whose operations the counter sees (outside it a meta tensor
    raises, as any tensor off the CPU and the card does);
  * the collectives of `dist.api` count their bytes and move none.

JAX's `scan_unroll` has no counterpart: JAX needs it because XLA's cost
analysis counts a while-loop body once, but the port's layers are a
Python loop, which a FLOP counter sees in full.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar

_COST_MODE: ContextVar = ContextVar("repro_torch_cost_mode", default=False)


def cost_mode() -> bool:
    return _COST_MODE.get()


@contextlib.contextmanager
def cost_mode_ctx(enabled: bool = True):
    token = _COST_MODE.set(enabled)
    try:
        yield
    finally:
        _COST_MODE.reset(token)
