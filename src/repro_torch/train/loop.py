"""Training loops (port of `repro.train.loop`): the single-stage runner
(with its checkpoint cadence), evaluation and the paper's two-stage
recipe, with the straggler watchdog.

Batches come from the data as numpy dicts and move to the state's device
here. Each step ends in a device sync, so its wall time is the step's own
and not that of an asynchronous launch.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.common import tree as tu
from repro_torch.common.device import resolve_device
from repro_torch.common.types import ModelCfg, TrainCfg
from repro_torch.core import peft
from repro_torch.models import model as M
from repro_torch.sparse.importance import gated_param_count, mask_gate
from repro_torch.train import metrics as metrics_mod
from repro_torch.train.steps import (build_eval_step, build_train_step,
                                     make_state, merged_params, state_tree)


class StepWatchdog:
    """EWMA step-time tracker: flags straggler steps (the detection signal a
    cluster scheduler needs for mitigation at real scale)."""

    def __init__(self, factor: float = 2.0, alpha: float = 0.1):
        self.ewma = None
        self.factor = factor
        self.alpha = alpha
        self.stragglers = []

    def observe(self, step: int, dt: float):
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.factor * self.ewma
        if slow:
            self.stragglers.append((step, dt, self.ewma))
            # clamp the baseline update for flagged steps: folding the
            # straggler sample itself into the EWMA drags the baseline
            # toward the pathology, so a run of consecutive stragglers
            # raises its own detection threshold until it stops firing.
            # The baseline may still drift up (a real regime change - e.g.
            # a longer sequence bucket - should eventually be accepted),
            # but never by more than the flagging threshold per step.
            dt = self.factor * self.ewma
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on `device`; integer arrays become int64
    (index tensors), float arrays keep their dtype."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(params) -> torch.device:
    return next(leaf for _, leaf in tu.flatten_with_paths(params)).device


def run_train(state, step_fn, batches: Iterable, *, steps: int,
              log_every: int = 0, manager=None, save_every: int = 0,
              watchdog: Optional[StepWatchdog] = None,
              log: Callable[[str], None] = print):
    """Run `steps` steps. Returns (state, history): one dict of floats per
    step, its metrics plus `step_s`, the step's wall time up to a device
    sync. With a `manager` (`checkpoint.CheckpointManager`) and
    `save_every`, every save_every-th step of this run saves the state
    (`steps.state_tree`) under the state's step count, as JAX does."""
    device = _device_of(state["params"])
    history = []
    it = iter(batches)
    for i in range(steps):
        batch = to_device(next(it), device)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        _sync(device)
        dt = time.perf_counter() - t0
        if watchdog is not None and watchdog.observe(i, dt):
            log(f"[watchdog] straggler step {i}: {dt:.3f}s "
                f"(ewma {watchdog.ewma:.3f}s)")
        hm = {k: float(v) for k, v in m.items()}
        hm["step_s"] = dt
        history.append(hm)
        if log_every and (i + 1) % log_every == 0:
            log(f"step {i+1}/{steps} loss={hm['loss']:.4f} "
                f"gnorm={hm['grad_norm']:.3f}")
        if manager is not None and save_every and (i + 1) % save_every == 0:
            manager.save(state["step"], state_tree(state))
    return state, history


def evaluate(cfg: ModelCfg, params, eval_batches,
             metric: str = "acc") -> float:
    ev = build_eval_step(cfg)
    device = _device_of(params)
    preds, labels = [], []
    for batch in eval_batches:
        preds.append(ev(params, to_device(batch, device)).cpu().numpy())
        labels.append(np.asarray(batch["labels"]))
    return metrics_mod.metric_fn(metric)(
        np.concatenate(preds), np.concatenate(labels))


def overlay_by_path(dst, src):
    """Copy every leaf of src into dst where paths coincide (stage-1 head
    reload into the stage-2 tree, which additionally contains adapters)."""
    src_leaves = dict(tu.flatten_with_paths(src))
    return tu.map_with_path(lambda path, v: src_leaves.get(path, v), dst)


def run_stage2(base_cfg: ModelCfg, strategy_name: Union[str, peft.Strategy],
               data, stage2: TrainCfg, stage1_params, *, metric: str = "acc",
               seed: int = 0, layer_mask=None,
               log: Callable[[str], None] = print) -> Dict:
    """Stage 2 of the recipe: inject the strategy's adapter (a registry
    name, or a `peft.Strategy` such as Table 4's `ablation_strategy`) into
    a fresh tree (made from seed + 1, as JAX makes it from the second key),
    reload the backbone and trained head of `stage1_params`, and tune the
    strategy's leaves. Returns params, cfg, final_metric, param_stats and
    history.

    layer_mask: an (n_layers,) bool mask (`sparse`) gating the stage's
    gradients: the adapters of masked-off layers stay at the identity
    (paper Table 5, and the pruned 0.022 % variant trained from the
    start), and param_stats counts only the surviving layers."""
    strat = (strategy_name if isinstance(strategy_name, peft.Strategy)
             else peft.strategy(strategy_name))
    device = _device_of(stage1_params)
    cfg2 = peft.attach(base_cfg, strat)
    params2 = M.init_params(torch.Generator(device=device).manual_seed(seed + 1),
                            cfg2)  # fresh tree containing adapters
    params2 = overlay_by_path(params2, stage1_params)  # backbone + head
    state2 = make_state(None, cfg2, strat, stage2.optim, params=params2)
    step2 = build_train_step(cfg2, stage2.optim, microbatch=stage2.microbatch,
                             layer_mask=layer_mask)
    state2, hist2 = run_train(
        state2, step2, data.train_batches(stage2.steps, stage2.batch_size,
                                          seed=stage2.seed + 1),
        steps=stage2.steps, log_every=stage2.log_every, log=log)
    params2 = merged_params(state2)
    m2 = evaluate(cfg2, params2, data.eval_batches(stage2.batch_size), metric)
    mask = peft.trainable_mask(params2, strat, 2, cfg=cfg2)
    stats = peft.param_stats(params2, mask)
    if layer_mask is not None:
        n = gated_param_count(params2, mask,
                              mask_gate(params2, cfg2, layer_mask))
        stats = dict(stats, trainable=n,
                     fraction=n / max(stats["total"], 1),
                     percent=100.0 * n / max(stats["total"], 1))
    log(f"[stage2] {strat.name} {metric}={m2:.4f} "
        f"trainable={stats['trainable']} ({stats['percent']:.4f}%)")
    return {"params": params2, "cfg": cfg2, "final_metric": m2,
            "param_stats": stats, "history": hist2}


def two_stage_finetune(
    seed: int,
    base_cfg: ModelCfg,
    strategy_name: str,
    data,  # object with .train_batches(n, bs, seed) and .eval_batches(bs)
    *,
    stage1: TrainCfg,
    stage2: TrainCfg,
    metric: str = "acc",
    pretrained_params=None,
    layer_mask=None,
    log: Callable[[str], None] = print,
    device=None,
) -> Dict:
    """The paper's recipe (§3.2). Returns a dict with params, cfg,
    stage1_metric, final_metric, param_stats, history and stage1_params
    (the tuned head on the backbone, what stage 2 starts from).
    layer_mask gates stage 2's gradients (`run_stage2`).

    The backbone comes from `pretrained_params` (a stage-1 tree: no
    adapter), else it is made from `seed` on `device` (cuda unless the
    caller names one). Stage 1 draws its batches from stage1.seed, stage 2
    from stage2.seed + 1, as in JAX."""
    strat = peft.strategy(strategy_name)

    # ---- stage 1: classifier only, no adapter in the tree ----
    head_only = peft.strategy("classifier_only")
    cfg1 = peft.attach(base_cfg, head_only)
    if pretrained_params is None:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        pretrained_params = M.init_params(gen, cfg1)
    state1 = make_state(None, cfg1, head_only, stage1.optim,
                        params=pretrained_params)
    step1 = build_train_step(cfg1, stage1.optim, microbatch=stage1.microbatch)
    state1, hist1 = run_train(
        state1, step1, data.train_batches(stage1.steps, stage1.batch_size,
                                          seed=stage1.seed),
        steps=stage1.steps, log_every=stage1.log_every, log=log)
    params1 = merged_params(state1)
    m1 = evaluate(cfg1, params1, data.eval_batches(stage1.batch_size), metric)
    log(f"[stage1] classifier-only {metric}={m1:.4f}")

    if not strat.two_stage:
        return {"params": params1, "stage1_metric": m1, "final_metric": m1,
                "cfg": cfg1, "stage1_params": params1,
                "history": {"stage1": hist1}}

    # ---- stage 2: inject adapter, reload head, tune adapter + norms ----
    res = run_stage2(base_cfg, strategy_name, data, stage2, params1,
                     metric=metric, seed=seed, layer_mask=layer_mask, log=log)
    return dict(res, stage1_metric=m1, stage1_params=params1,
                history={"stage1": hist1, "stage2": res["history"]})
