"""Blocks of the layer stack (port of `repro.models.program`).

Where the JAX package stacks each group's parameters on a leading
`repeats` dim and runs the group with `lax.scan`, the port keeps a flat
list of per-layer parameter dicts and runs a Python loop over it
(`models/model.py`); `convert.py` unstacks a JAX tree into that list.

The adapter seam. In the pre-LN block the JAX code computes, in turn, the
attention output with the Hadamard adapter applied last, the residual add,
and the ffn norm:  a = attn(h)*w + b;  x = x + a;  h = ffn_norm(x).  In
the post-LN (BERT) block it is  x = attn_norm(x + attn(x)*w + b).  Both
are exactly `fused_adapter_residual_norm` in its norm form, so the block
hands the pre-adapter attention output to `FusedAdapterResidualNorm`
(kernel #3 forward; its backward runs kernel #2). With a multi-task bank
(adapter leaves (T, d)) the pre-LN block calls `ops.multitask_hadamard`
with the per-row task ids, then adds the residual and normalises in plain
torch. The 'attn_concat' placement goes through `apply_attn` (kernels
#1/#2); every other block shape (post-norms, no adapter) takes the plain
path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.types import ModelCfg, Slot
from repro_torch.kernels import ops
from repro_torch.kernels.hadamard import FusedAdapterResidualNorm
from repro_torch.models.attention import apply_attn, apply_hadamard, attn_init
from repro_torch.models.layers import (apply_mlp, apply_norm, gen_device,
                                      mlp_init, norm_init)


def adapter_init(cfg: ModelCfg, slot: Slot, device) -> Optional[dict]:
    a = cfg.adapter
    if not a.enabled:
        return None
    if a.kind != "hadamard":
        raise NotImplementedError(
            f"adapter kind {a.kind!r} is not ported: the serving slice "
            "carries the paper's Hadamard adapter")
    dim = cfg.q_dim if a.position == "attn_concat" else cfg.d_model
    # w=1, b=0: the identity - "equivalent to not adding any adapter"
    return {"w": torch.ones((dim,), dtype=torch.float32, device=device),
            "b": torch.zeros((dim,), dtype=torch.float32, device=device)}


def block_init(gen: torch.Generator, cfg: ModelCfg, slot: Slot) -> dict:
    dev = gen_device(gen)
    p = {"attn_norm": norm_init(cfg, dev), "ffn_norm": norm_init(cfg, dev),
         "attn": attn_init(gen, cfg), "mlp": mlp_init(gen, cfg)}
    if cfg.post_norms:
        p["post_attn_norm"] = norm_init(cfg, dev)
        p["post_ffn_norm"] = norm_init(cfg, dev)
    ad = adapter_init(cfg, slot, dev)
    if ad is not None:
        p["adapter"] = ad
    return p


def block_apply(p: dict, cfg: ModelCfg, slot: Slot, x: torch.Tensor, *,
                q_pos: torch.Tensor, cache: Optional[dict] = None,
                cache_len: Optional[int] = None,
                write_pos: Optional[torch.Tensor] = None,
                kv_lens: Optional[torch.Tensor] = None,
                tables: Optional[torch.Tensor] = None,
                task_ids: Optional[torch.Tensor] = None, causal: bool = True,
                impl: str = "auto"):
    """One block, pre-LN or post-LN (`cfg.ln_placement`). Returns (x,
    cache). task_ids (B,) int32 select each row's bank row when the
    adapter leaves are a (T, d) bank."""
    if cfg.ln_placement == "post":
        return _post_ln_block(p, cfg, slot, x, q_pos=q_pos, causal=causal,
                              impl=impl), None
    acfg = cfg.adapter
    ad = p.get("adapter") if acfg.kind == "hadamard" else None
    bank = ad is not None and ad["w"].dim() == 2
    if bank and task_ids is None:
        raise ValueError("a multi-task bank needs per-row task_ids")
    concat = None
    if ad is not None and acfg.position == "attn_concat":
        concat = ((ad["w"][task_ids.long()], ad["b"][task_ids.long()])
                  if bank else (ad["w"], ad["b"]))

    h = apply_norm(p["attn_norm"], cfg, x)
    a, cache = apply_attn(p["attn"], cfg, slot, h, q_pos=q_pos, cache=cache,
                          cache_len=cache_len, write_pos=write_pos,
                          kv_lens=kv_lens, tables=tables,
                          concat_adapter=concat, causal=causal, impl=impl)
    ffn_norm = p["ffn_norm"]
    if ad is not None and acfg.position == "attn_out" and not cfg.post_norms:
        if bank:
            a = ops.multitask_hadamard(a, ad["w"], ad["b"], task_ids,
                                       impl=impl)
            x = x + a
            h = apply_norm(ffn_norm, cfg, x)
        else:
            x, h = FusedAdapterResidualNorm.apply(
                a, x, ad["w"], ad["b"], ffn_norm["scale"],
                ffn_norm.get("bias"), cfg.norm_eps, impl)
    else:
        if ad is not None and acfg.position == "attn_out":
            a = (apply_hadamard(a, ad["w"][task_ids.long()],
                                ad["b"][task_ids.long()])
                 if bank else apply_hadamard(a, ad["w"], ad["b"]))
        if cfg.post_norms:
            a = apply_norm(p["post_attn_norm"], cfg, a)
        x = x + a
        h = apply_norm(ffn_norm, cfg, x)

    f = apply_mlp(p["mlp"], cfg, h)
    if cfg.post_norms:
        f = apply_norm(p["post_ffn_norm"], cfg, f)
    return x + f, cache


def _post_ln_block(p: dict, cfg: ModelCfg, slot: Slot, x: torch.Tensor, *,
                   q_pos: torch.Tensor, causal: bool, impl: str):
    """BERT-style: sublayer -> residual add -> LayerNorm, as
    `repro/models/program.py:138-153`; no cache (the encoder trains and
    classifies whole sequences)."""
    acfg = cfg.adapter
    ad = p.get("adapter") if acfg.kind == "hadamard" else None
    if ad is not None and ad["w"].dim() != 1:
        raise NotImplementedError("post-LN blocks take one adapter, not a "
                                  "multi-task bank")
    concat = ((ad["w"], ad["b"]) if ad is not None
              and acfg.position == "attn_concat" else None)
    a, _ = apply_attn(p["attn"], cfg, slot, x, q_pos=q_pos,
                      concat_adapter=concat, causal=causal, impl=impl)
    attn_norm = p["attn_norm"]  # "A": the attention-output norm
    if ad is not None and acfg.position == "attn_out":
        _, x = FusedAdapterResidualNorm.apply(
            a, x, ad["w"], ad["b"], attn_norm["scale"], attn_norm.get("bias"),
            cfg.norm_eps, impl)
    else:
        x = apply_norm(attn_norm, cfg, x + a)
    # "N": the post-intermediate norm
    return apply_norm(p["ffn_norm"], cfg, x + apply_mlp(p["mlp"], cfg, x))
