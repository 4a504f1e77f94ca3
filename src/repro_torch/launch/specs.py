"""Meta-device stand-ins for every (arch x shape) cell, and the step
functions the dry run counts (port of `repro.launch.specs`).

JAX's `jax.ShapeDtypeStruct`s become tensors on the meta device: shapes
and dtypes, no storage, so nothing here allocates memory. `build_step_fn`
gives the same three step kinds as JAX's: a train step (the family's loss,
its gradients, the clip and AdamW), a prefill, and a greedy decode step.
The port's decode step takes per-row positions (B,), where JAX's takes one
scalar; the batch is the same.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.types import ModelCfg, OptimCfg, ShapeSpec
from repro_torch.core import peft
from repro_torch.models import model as M
from repro_torch.train.losses import loss_for
from repro_torch.train.steps import build_train_step, make_state

I64 = torch.long
META = torch.device("meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def params_shapes(cfg: ModelCfg) -> dict:
    """The parameter tree on the meta device."""
    with torch.device(META):
        return M.init_params(None, cfg)


def state_shapes(cfg: ModelCfg, strat: peft.Strategy, ocfg: OptimCfg,
                 params=None) -> dict:
    """A train state on the meta device (given `params`, over those)."""
    with torch.device(META):
        return make_state(None, cfg, strat, ocfg,
                          params=params_shapes(cfg) if params is None
                          else params)


def input_specs(cfg: ModelCfg, spec: ShapeSpec) -> Dict:
    """Model-input stand-ins for one shape, keyed as the family's batch."""
    B, S = spec.global_batch, spec.seq_len
    cdt = cfg.cdtype
    if spec.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            st = S - cfg.n_image_tokens
            out = {"tokens": _meta((B, st), I64),
                   "patches": _meta((B, cfg.n_image_tokens, cfg.d_model),
                                    cdt)}
            if spec.kind == "train":
                out["labels"] = _meta((B, st), I64)
            return out
        if cfg.family == "encdec":
            out = {"frames": _meta((B, cfg.n_audio_frames, cfg.d_model), cdt),
                   "tokens": _meta((B, S), I64)}
            if spec.kind == "train":
                out["labels"] = _meta((B, S), I64)
            return out
        if cfg.family == "encoder":
            out = {"tokens": _meta((B, S), I64),
                   "type_ids": _meta((B, S), I64)}
            if spec.kind == "train":
                out["labels"] = _meta((B,), I64)
            return out
        out = {"tokens": _meta((B, S), I64)}
        if spec.kind == "train":
            out["labels"] = _meta((B, S), I64)
        return out

    # decode: one new token against a cache of seq_len
    init = (M.init_encdec_caches if cfg.family == "encdec"
            else M.init_decode_caches)
    return {"caches": init(cfg, B, S, META),
            "token": _meta((B, 1), I64),
            "pos": _meta((B,), I64)}


def build_step_fn(cfg: ModelCfg, spec: ShapeSpec,
                  ocfg: OptimCfg = OptimCfg(), microbatch: int = 0):
    """(fn, kind), kind in {'train', 'prefill', 'decode'}: train
    fn(state, batch), prefill fn(params, batch), decode fn(params, caches,
    token, pos) -> (next tokens (B,), caches)."""
    if spec.kind == "train":
        loss_for(cfg)
        return build_train_step(cfg, ocfg, microbatch=microbatch), "train"

    if spec.kind == "prefill":
        S = spec.seq_len

        if cfg.family == "encdec":
            def fn(params, batch):
                return M.prefill_encdec(params, cfg, batch["frames"],
                                        batch["tokens"], cache_len=S)
        elif cfg.family == "vlm":
            def fn(params, batch):
                return M.prefill_lm(params, cfg, batch["tokens"],
                                    cache_len=S, patches=batch["patches"])
        else:
            def fn(params, batch):
                return M.prefill_lm(params, cfg, batch["tokens"],
                                    cache_len=S)
        return fn, "prefill"

    decode = M.decode_encdec if cfg.family == "encdec" else M.decode_lm

    def fn(params, caches, token, pos):
        logits, caches = decode(params, cfg, caches, token, pos)
        return logits[:, -1].argmax(-1), caches
    return fn, "decode"
