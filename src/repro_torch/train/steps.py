"""Train-step builder (port of `repro.train.steps`): PEFT partition,
gradient accumulation, gating, gradient compression, clipping, AdamW;
QPEFT (a quantized frozen trunk under a trainable adapter).

The state is a dict:
  step:      int, steps taken
  params:    the whole parameter tree; the leaves the strategy's mask
             selects have requires_grad=True, every other leaf False, so
             autograd reaches only what is trained (a quantized leaf is a
             QTensor, frozen by construction)
  trainable: {path: tensor}, the same tensor objects as in `params`
  opt:       AdamW moments over `trainable`, in OptimCfg's moment dtypes
             (`optim.qstate`), with their int8 residuals under EF
  err:       gradient compression's error buffers (only when
             OptimCfg.compress_grads is set)
A step updates the state in place and returns it. `state_tree` is what a
checkpoint of it holds, `restore_state` puts one back.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.common import tree as tu
from repro_torch.common.types import ModelCfg, OptimCfg
from repro_torch.convert import jax_ndim, jax_path
from repro_torch.core import peft
from repro_torch.models import model as M
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                    clip_by_global_norm, global_norm)
from repro_torch.optim.compression import compress, ef_init
from repro_torch.optim.schedule import lr_at
from repro_torch.quant import is_qtensor, quantize_tree
from repro_torch.sparse.importance import mask_gate
from repro_torch.train.losses import loss_for

def _copy(leaf):
    if is_qtensor(leaf):
        return type(leaf)(leaf.values.clone(), leaf.scales.clone())
    return leaf.detach().clone()


def make_state(gen: Optional[torch.Generator], cfg: ModelCfg,
               strat: peft.Strategy, ocfg: OptimCfg, stage: int = 2,
               params=None, quant: Optional[str] = None,
               quant_stats=None) -> dict:
    """A fresh train state. Given `params`, the state holds copies of them
    (the step updates in place; the caller's tree stays as it was), else
    new parameters from `gen`.

    quant="int8"/"fp8" enables QPEFT, as in JAX: after the PEFT partition
    the frozen leaves alone are quantized (`quantize_tree`, with the
    activation-weighted clips of `quant_stats` from `calibrate` when
    given, one clip per JAX leaf), so the forward streams int8/fp8 weights
    through the dequant matmul (#7) while the trainable leaves keep their
    dtype and exact gradients. It raises ValueError when a trainable leaf
    is already quantized, or when nothing was quantized (a strategy that
    trains the backbone matmuls). OptimCfg's moment dtypes shape the
    AdamW state; compress_grads adds the error buffers `err`."""
    if params is None:
        params = M.init_params(gen, cfg)
    else:
        params = tu.map_with_path(lambda _, t: _copy(t), params)
    mask = peft.trainable_mask(params, strat, stage, cfg=cfg)
    flags = dict(tu.flatten_with_paths(mask))
    if quant:
        if any(is_qtensor(leaf) and flags[path]
               for path, leaf in tu.flatten_with_paths(params)):
            raise ValueError("trainable subtree contains quantized leaves")
        trained, frozen = tu.partition(params, mask)
        frozen = quantize_tree(frozen, quant, stats=quant_stats, cfg=cfg)
        if not any(is_qtensor(leaf)
                   for _, leaf in tu.flatten_with_paths(frozen)):
            raise ValueError(
                f"quant={quant!r} quantized nothing: strategy "
                f"{strat.name!r} trains the backbone matmuls (QPEFT needs "
                "a frozen trunk)")
        params = tu.merge(trained, frozen)
    trainable = {}
    for path, leaf in tu.flatten_with_paths(params):
        if is_qtensor(leaf):
            continue
        leaf.requires_grad_(flags[path])
        if flags[path]:
            trainable[path] = leaf
    # weight decay where JAX decays: leaves of rank >= 2 in its layout
    decay = [p for p, t in trainable.items() if jax_ndim(p, t) >= 2]
    state = {"step": 0, "params": params, "trainable": trainable,
             "opt": adamw_init(trainable, decay, ocfg)}
    if ocfg.compress_grads:
        state["err"] = ef_init(trainable)
    return state


def state_tree(state: dict) -> dict:
    """What a checkpoint of the state holds, as a nested dict of tensors
    for `checkpoint.store`: the step, the trainable leaves by path, the
    AdamW moments in their stored dtypes (an int8 moment as its QTensor),
    their residuals and the count, and compression's error buffers. The
    frozen trunk is not written: no step changes it, and `make_state`
    rebuilds it from the same seed (and calibration) before
    `restore_state` puts a checkpoint back."""
    def scalar(n):
        return torch.tensor(n, dtype=torch.int32)

    opt = state["opt"]
    tree = {"step": scalar(state["step"]),
            "trainable": dict(state["trainable"]),
            "opt": {k: dict(opt[k]) for k in ("m", "v", "m_err", "v_err")
                    if k in opt}}
    tree["opt"]["count"] = scalar(opt["count"])
    if "err" in state:
        tree["err"] = dict(state["err"])
    return tree


_INTEROP = ("reading another layout (a checkpoint the JAX package wrote, "
            "its layers stacked) arrives with the checkpoint-interop slice")


@torch.no_grad()
def restore_state(state: dict, restored: dict) -> dict:
    """Put a loaded checkpoint (`state_tree`'s layout, from
    `CheckpointManager.restore`) into `state`, in place: each trainable
    leaf takes the checkpoint's values by path, cast to its dtype on its
    device; each moment, residual and error buffer takes them as stored
    (a QTensor's values and scales); the step and the optimizer's count
    take the checkpoint's. Returns the state.

    The checkpoint must hold exactly the state's paths at the state's
    shapes, or ValueError: a checkpoint of another strategy or model, or
    one the JAX package wrote, would otherwise resume at its step with
    fresh adapters and moments. So must its optimizer state be stored as
    the state's is: another moment dtype, error feedback or
    compress_grads raises ValueError too."""
    live = dict(tu.flatten_with_paths(state_tree(state)))
    flat = dict(tu.flatten_with_paths(restored))
    missing = sorted(set(live) - set(flat))
    extra = sorted(set(flat) - set(live))
    if missing or extra:
        raise ValueError(
            f"checkpoint does not hold this train state: {len(missing)} of "
            f"its paths missing (first {missing[:2]}), {len(extra)} paths "
            f"not in it (first {extra[:2]}); the optimizer's layout (moment "
            f"dtypes, error feedback, compress_grads) must match too; "
            f"{_INTEROP}")
    shapes = [p for p, t in live.items()
              if tuple(flat[p].shape) != tuple(t.shape)]
    if shapes:
        raise ValueError(f"checkpoint shapes differ from the state's at "
                         f"{shapes[:2]}; {_INTEROP}")
    stored = [p for p, t in live.items()
              if p.startswith(("opt/", "err/")) and _kind(flat[p]) != _kind(t)]
    if stored:
        raise ValueError(
            f"checkpoint's optimizer state is stored otherwise at "
            f"{stored[:2]}: {_kind(flat[stored[0]])}, the state's "
            f"{_kind(live[stored[0]])} (another OptimCfg's moment dtypes)")
    for path, t in live.items():
        if path in ("step", "opt/count"):
            continue
        if is_qtensor(t):
            t.values.copy_(flat[path].values)
            t.scales.copy_(flat[path].scales)
        else:
            t.copy_(flat[path])
    state["step"] = int(flat["step"])
    state["opt"]["count"] = int(flat["opt/count"])
    return state


def _kind(leaf) -> str:
    """How a leaf is stored: its dtype, or a QTensor's values' dtype."""
    if is_qtensor(leaf):
        return f"QTensor[{str(leaf.values.dtype).removeprefix('torch.')}]"
    return str(leaf.dtype).removeprefix("torch.")


def merged_params(state: dict) -> dict:
    return state["params"]


def loss_and_grads(cfg: ModelCfg, state: dict, batch: dict,
                   impl: str = "auto", loss_fn: Optional[Callable] = None):
    """(loss, metrics, grads) of one batch under `loss_fn` (the config
    family's loss by default): grads {path: tensor} over the state's
    trainable leaves, unclipped."""
    paths = list(state["trainable"])
    leaves = [state["trainable"][p] for p in paths]
    loss, metrics = (loss_fn or loss_for(cfg))(cfg, state["params"], batch,
                                               impl=impl)
    # a leaf the loss never reads (an encoder's final_norm under bitfit)
    # gets a zero gradient, as jax.grad gives it; so does every leaf when
    # the loss reads none (LoRA or IA3 over RWKV6 blocks, where no op reads
    # their leaves)
    grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
             if loss.requires_grad else [None] * len(leaves))
    return loss, metrics, {p: torch.zeros_like(t) if g is None else g
                           for p, t, g in zip(paths, leaves, grads)}


def build_train_step(cfg: ModelCfg, ocfg: OptimCfg, *, microbatch: int = 0,
                     gate=None, layer_mask=None,
                     loss_fn: Optional[Callable] = None):
    """Returns step(state, batch) -> (state, metrics), metrics a dict of
    0-dim tensors (loss, grad_norm and the loss's own scalars) and the
    step's learning rate. loss_fn(cfg, params, batch, impl=) -> (loss,
    metrics) replaces the config family's loss (MLM pretraining passes
    `pretrain.mlm_loss`).

    microbatch=n accumulates the gradient over n slices of the batch's
    leading dim (every entry: tokens, labels and an encdec batch's frames
    or a VLM batch's patches), as JAX's scan does: each slice's gradients
    add up in fp32,
    the sum is scaled by 1/n, and the loss and metrics are the slices'
    means.

    gate (a tree over the params, `peft.layer_gate`) or layer_mask (a
    host-side (n_layers,) bool mask, whose gate `sparse.mask_gate` makes)
    multiplies each gradient by its leaf's gate after the gradients are
    computed and before the clip, as JAX does. A gated-off leaf is not
    frozen: AdamW still updates it with a zero gradient, so weight decay
    moves its decayed leaves (an adapter's w, a norm's scale), as in
    JAX.

    In JAX's order, the gated gradients are then compressed (when the
    state holds `err`: int8 with one scale per JAX leaf, error carried),
    clipped by their global norm, and handed to AdamW."""
    if gate is not None and layer_mask is not None:
        raise ValueError("pass either gate or layer_mask, not both")
    gates = None if gate is None else dict(tu.flatten_with_paths(gate))

    def gate_of(state):
        nonlocal gates
        if gates is None and layer_mask is not None:
            gates = dict(tu.flatten_with_paths(
                mask_gate(state["params"], cfg, layer_mask)))
        return gates

    def compute_grads(state, batch):
        if not microbatch:
            return loss_and_grads(cfg, state, batch, loss_fn=loss_fn)
        n = microbatch
        acc = {p: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for p, t in state["trainable"].items()}
        acc_l, mets = None, []
        for j in range(n):
            mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[j]
                  for k, v in batch.items()}
            loss, metrics, grads = loss_and_grads(cfg, state, mb,
                                                  loss_fn=loss_fn)
            acc = {p: acc[p] + grads[p] for p in acc}
            loss = loss.detach()
            acc_l = loss if acc_l is None else acc_l + loss
            mets.append({k: v.detach() for k, v in metrics.items()
                         if v.dim() == 0})
        means = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        return (acc_l / n, means,
                {p: g * (1.0 / n) for p, g in acc.items()})

    def step(state, batch):
        loss, metrics, grads = compute_grads(state, batch)
        g_tree = gate_of(state)
        if g_tree is not None:
            grads = {p: g * g_tree[p] for p, g in grads.items()}
        if "err" in state:
            grads, state["err"] = compress(
                grads, state["err"], group_of=lambda p: jax_path(p, cfg))
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
    """Returns eval(params, batch) -> predictions: class ids (or logit 0 of
    a regression config) of an encoder, each position's argmax token of a
    decoder LM or a VLM (whose batch passes its "patches", as JAX's eval
    step does). JAX's eval step runs `forward_lm`, which takes no frames,
    so an encdec config is refused."""
    if cfg.family == "encdec":
        raise ValueError("an encdec model has no eval step: JAX's runs "
                         "forward_lm, which takes no audio frames")

    @torch.no_grad()
    def eval_step(params, batch):
        if cfg.family in ("decoder", "vlm"):
            return M.forward_lm(params, cfg, batch["tokens"],
                                patches=batch.get("patches")).argmax(-1)
        logits, _, _ = M.forward_encoder(params, cfg, batch["tokens"],
                                         batch.get("type_ids"))
        if cfg.is_regression:
            return logits[..., 0].float()
        return logits.argmax(-1)

    return eval_step
