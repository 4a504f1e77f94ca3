"""Learning-rate schedules (port of `repro.optim.schedule`): pure
functions of the step counter."""
from __future__ import annotations

import math

from repro_torch.common.types import OptimCfg


def lr_at(cfg: OptimCfg, step: int) -> float:
    """The learning rate of step `step` (0-based: the trainer evaluates it
    at the step count before its increment)."""
    step = float(step)
    peak = cfg.lr
    warm = max(cfg.warmup_steps, 1)
    total = max(cfg.total_steps, warm + 1)
    if step < warm:
        # (step+1)/warm: step 0 trains at peak/warm, not 0 (and at peak
        # when warmup is disabled)
        return peak * min(1.0, (step + 1.0) / warm)
    frac = min(max((step - warm) / (total - warm), 0.0), 1.0)
    floor = peak * cfg.min_lr_ratio
    if cfg.schedule == "constant":
        return peak
    if cfg.schedule == "linear":
        return peak + (floor - peak) * frac
    return floor + 0.5 * (peak - floor) * (1 + math.cos(math.pi * frac))
