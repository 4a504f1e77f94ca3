"""Train-step builder (port of `repro.train.steps`): PEFT partition,
clipping, AdamW.

The state is a dict:
  step:      int, steps taken
  params:    the whole parameter tree; the leaves the strategy's mask
             selects have requires_grad=True, every other leaf False, so
             autograd reaches only what is trained
  trainable: {path: tensor}, the same tensor objects as in `params`
  opt:       AdamW moments over `trainable`
A step updates the state in place and returns it.

Gradient accumulation (`microbatch`), gradient compression, quantized
moments are not ported yet and raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common import tree as tu
from repro_torch.common.types import ModelCfg, OptimCfg
from repro_torch.convert import jax_ndim
from repro_torch.core import peft
from repro_torch.models import model as M
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                    clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import lr_at
from repro_torch.train.losses import loss_for

_LATER = "the optimizer-state slice (gradient compression, quantized moments)"


def check_optim(ocfg: OptimCfg) -> None:
    """Raise on an OptimCfg option the port does not run yet."""
    default = OptimCfg()
    for name in ("compress_grads", "m_dtype", "v_dtype"):
        if getattr(ocfg, name) != getattr(default, name):
            raise NotImplementedError(
                f"OptimCfg.{name}={getattr(ocfg, name)!r} is not ported yet; "
                f"it arrives with {_LATER}")


def make_state(gen: Optional[torch.Generator], cfg: ModelCfg,
               strat: peft.Strategy, ocfg: OptimCfg, stage: int = 2,
               params=None) -> dict:
    """A fresh train state. Given `params`, the state holds copies of them
    (the step updates in place; the caller's tree stays as it was), else
    new parameters from `gen`."""
    check_optim(ocfg)
    if params is None:
        params = M.init_params(gen, cfg)
    else:
        params = tu.map_with_path(lambda _, t: t.detach().clone(), params)
    flags = dict(tu.flatten_with_paths(
        peft.trainable_mask(params, strat, stage, cfg=cfg)))
    trainable = {}
    for path, leaf in tu.flatten_with_paths(params):
        leaf.requires_grad_(flags[path])
        if flags[path]:
            trainable[path] = leaf
    # weight decay where JAX decays: leaves of rank >= 2 in its layout
    decay = [p for p, t in trainable.items() if jax_ndim(p, t) >= 2]
    return {"step": 0, "params": params, "trainable": trainable,
            "opt": adamw_init(trainable, decay)}


def merged_params(state: dict) -> dict:
    return state["params"]


def loss_and_grads(cfg: ModelCfg, state: dict, batch: dict,
                   impl: str = "auto"):
    """(loss, metrics, grads) of one batch: grads {path: tensor} over the
    state's trainable leaves, unclipped."""
    paths = list(state["trainable"])
    leaves = [state["trainable"][p] for p in paths]
    loss, metrics = loss_for(cfg)(cfg, state["params"], batch, impl=impl)
    # a leaf the loss never reads (an encoder's final_norm under bitfit)
    # gets a zero gradient, as jax.grad gives it
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, metrics, {p: torch.zeros_like(t) if g is None else g
                           for p, t, g in zip(paths, leaves, grads)}


def build_train_step(cfg: ModelCfg, ocfg: OptimCfg, *, microbatch: int = 0):
    """Returns step(state, batch) -> (state, metrics), metrics a dict of
    0-dim tensors (loss, grad_norm and the loss's own scalars) and the
    step's learning rate."""
    if microbatch:
        raise NotImplementedError("gradient accumulation (microbatch) is not "
                                  "ported yet; it arrives with decoder-LM "
                                  "fine-tuning")
    check_optim(ocfg)
    loss_for(cfg)  # a family the port does not train raises here

    def step(state, batch):
        loss, metrics, grads = loss_and_grads(cfg, state, batch)
        if ocfg.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, ocfg.grad_clip)
        else:
            gnorm = global_norm(grads)
        lr = lr_at(ocfg, state["step"])
        state["opt"] = adamw_update(grads, state["opt"], state["trainable"],
                                    ocfg, lr)
        state["step"] += 1
        scalars = {k: v.detach() for k, v in metrics.items() if v.dim() == 0}
        return state, dict(scalars, loss=loss.detach(), grad_norm=gnorm,
                           lr=lr)

    return step


def build_eval_step(cfg: ModelCfg):
    """Returns eval(params, batch) -> predictions (class ids, or logit 0 of
    a regression config)."""
    if cfg.family != "encoder":
        raise NotImplementedError("the port evaluates encoder classifiers; "
                                  "decoder-LM eval arrives with decoder-LM "
                                  "fine-tuning")

    @torch.no_grad()
    def eval_step(params, batch):
        logits, _, _ = M.forward_encoder(params, cfg, batch["tokens"],
                                         batch.get("type_ids"))
        if cfg.is_regression:
            return logits[..., 0].float()
        return logits.argmax(-1)

    return eval_step
