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
with the per-row task ids, or, given the layer's row gates of a hot-swap
bank, `ops.masked_multitask_hadamard`, then adds the residual and
normalises in plain torch. The gathers of the other placements clamp each
task id into the leaf's rows (`core.hadamard.select_rows`), so a shared-w
bank's single w row serves every request there too. The 'attn_concat'
placement goes through `apply_attn` (kernels #1/#2).

With post-norms (gemma2) the JAX block runs the adapter, then
`post_attn_norm`, then the residual add (`repro/models/program.py:
155-179`): a norm sits between the adapter and the add, so #3's fused form
cannot apply. One adapter runs `HadamardAffine` (#1), a static bank #6 and
a gated hot-swap bank #9 with its layer's gate, as in the pre-LN block;
the post-norm, the add and the ffn norm follow in plain torch.

The baselines (paper Table 3) sit where JAX puts them: LoRA's and IA3's
hooks inside `apply_attn`, IA3's ffn scale inside `apply_mlp`, and
Houlsby's bottleneck around each sublayer's output before the residual
add, which #3's fused seam (adapter, add, norm) cannot take: a block
whose adapter is not Hadamard takes the unfused seam.

An RWKV6 block (`models/rwkv.py`) has the same seam: its time-mix output
takes the place of the attention output, and its channel mix that of the
MLP. JAX applies the Hadamard adapter to the time-mix output under any
position (`repro/models/program.py:171-174` tests only the kind), and so
does the port; the adapter's size is d_model there. Houlsby's bottlenecks
wrap the time-mix and the channel-mix outputs, as in JAX's pre-LN block;
LoRA's and IA3's leaves exist there and train, but no rwkv op reads them
(they only take weight decay), as in JAX. Its cache is the layer's
recurrent state, written in place at decode.

An RG-LRU block (`models/recurrent.py`, recurrentgemma) has the seam
too: JAX applies the Hadamard adapter to the rec output under any
position (`repro/models/program.py:165-170`), d_model wide, and so does
the port, through `_residual_seam` (#3 for one adapter, #6 for a static
bank, #9 for a gated hot-swap bank); Houlsby's bottlenecks wrap the rec
and the FFN outputs. A rec block holds no "attn" leaf, so folding skips
it and its adapter stays live. Its cache is the layer's recurrent state
{"h", "conv"}, written in place at decode.

A `moe` slot's FFN is the mixture of experts of `models/moe.py` in place
of the MLP, as in JAX's `block_apply`: the seam and the adapter stay as
they are, and the experts' load-balancing loss comes back as the block's
aux, which `models.model._run_layers` sums over the layers.

A `cross_attn` slot (whisper's decoder) adds a cross-attention sublayer
after the self-attention residual, as `repro/models/program.py:181-187`:
h = cross_norm(x); x = x + cross(h, enc_out); h = ffn_norm(x). So the
norm that follows the adapter and the self-attention residual is
`cross_norm`, not `ffn_norm`: the seam (#3 for one adapter) normalises by
the norm that actually follows, and after the cross residual comes a plain
add and `ffn_norm`, with no adapter (JAX passes `adapter=None` to the
cross block). Its cache: the self-attention {"k", "v"} beside the
encoder's {"ck", "cv"}; a decode step hands the block `cross_view`'s pool
under "cross".
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelCfg, Slot
from repro_torch.core.hadamard import select_rows
from repro_torch.kernels import ops
from repro_torch.kernels.hadamard import (FusedAdapterResidualNorm,
                                          HadamardAffine)
from repro_torch.models.attention import apply_attn, attn_init
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                      gen_device, mlp_init, norm_init)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.recurrent import rec_apply, rec_init
from repro_torch.models.rwkv import (rwkv_channel_mix, rwkv_cm_init,
                                    rwkv_time_mix, rwkv_tm_init)


def adapter_init(gen: Optional[torch.Generator], cfg: ModelCfg,
                 slot: Slot) -> Optional[dict]:
    """The block's adapter at its start, fp32: the Hadamard identity (w=1,
    b=0), LoRA with zero qb/vb, IA3's ones, Houlsby with a zero `up`; each
    is the identity until trained. LoRA's and Houlsby's down projections
    are drawn from `gen`."""
    a = cfg.adapter
    if not a.enabled:
        return None
    dev, f32 = gen_device(gen), torch.float32

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=dev)

    if a.kind == "hadamard":
        dim = (cfg.q_dim if a.position == "attn_concat"
               and slot.kind == "attn" else cfg.d_model)
        # w=1, b=0: the identity - "equivalent to not adding any adapter"
        return {"w": torch.ones((dim,), dtype=f32, device=dev),
                "b": zeros(dim)}
    if a.kind == "lora":
        r = a.lora_rank
        return {"qa": dense_init(gen, cfg.d_model, r, f32),
                "qb": zeros(r, cfg.q_dim),
                "va": dense_init(gen, cfg.d_model, r, f32),
                "vb": zeros(r, cfg.kv_dim)}
    if a.kind == "ia3":
        return {name: torch.ones((n,), dtype=f32, device=dev)
                for name, n in (("lk", cfg.kv_dim), ("lv", cfg.kv_dim),
                                ("lff", cfg.d_ff))}
    if a.kind == "houlsby":
        h = a.houlsby_dim
        return {name: {"down": dense_init(gen, cfg.d_model, h, f32),
                       "down_b": zeros(h), "up": zeros(h, cfg.d_model),
                       "up_b": zeros(cfg.d_model)}
                for name in ("attn_ad", "ffn_ad")}
    raise ValueError(f"unknown adapter kind {a.kind}")


def _houlsby(ad: dict, x: torch.Tensor) -> torch.Tensor:
    """Houlsby's bottleneck around a sublayer's output, before the
    residual add; gelu in its tanh form, as `jax.nn.gelu`'s default."""
    h = F.gelu(x @ ad["down"].to(x.dtype) + ad["down_b"].to(x.dtype),
               approximate="tanh")
    return x + h @ ad["up"].to(x.dtype) + ad["up_b"].to(x.dtype)


def _baseline(p: dict, cfg: ModelCfg, kind: str) -> Optional[dict]:
    """The block's adapter leaves when the config's adapter is `kind`."""
    return p.get("adapter") if cfg.adapter.kind == kind else None


def block_init(gen: torch.Generator, cfg: ModelCfg, slot: Slot) -> dict:
    dev = gen_device(gen)
    p = {"attn_norm": norm_init(cfg, dev), "ffn_norm": norm_init(cfg, dev)}
    if slot.kind == "rwkv":
        p["rwkv_tm"] = rwkv_tm_init(gen, cfg)
        p["rwkv_cm"] = rwkv_cm_init(gen, cfg)
    else:
        if slot.kind == "rec":
            p["rec"] = rec_init(gen, cfg)
        else:
            p["attn"] = attn_init(gen, cfg)
        if slot.cross_attn:
            p["cross_norm"] = norm_init(cfg, dev)
            p["cross"] = attn_init(gen, cfg, cross=True)
        if slot.moe:
            p["moe"] = moe_init(gen, cfg)
        else:
            p["mlp"] = mlp_init(gen, cfg)
    if cfg.post_norms:
        p["post_attn_norm"] = norm_init(cfg, dev)
        p["post_ffn_norm"] = norm_init(cfg, dev)
    ad = adapter_init(gen, cfg, slot)
    if ad is not None:
        p["adapter"] = ad
    return p


def block_apply(p: dict, cfg: ModelCfg, slot: Slot, x: torch.Tensor, *,
                q_pos: torch.Tensor, cache: Optional[dict] = None,
                cache_len: Optional[int] = None,
                write_pos: Optional[torch.Tensor] = None,
                kv_lens: Optional[torch.Tensor] = None,
                tables: Optional[torch.Tensor] = None,
                task_ids: Optional[torch.Tensor] = None,
                gate: Optional[torch.Tensor] = None, causal: bool = True,
                enc_out: Optional[torch.Tensor] = None, impl: str = "auto"):
    """One block, pre-LN or post-LN (`cfg.ln_placement`). Returns (x,
    cache, aux): aux the MoE FFN's load-balancing loss (fp32 scalar), None
    for a block without one. task_ids (B,) int32 select each row's bank
    row when the adapter leaves are a (T, d) bank; gate (T,) fp32 gates
    the bank's rows (a pruned tenant's layer passes through as the
    identity). enc_out (B, S_enc, d): the encoder output a cross slot
    attends over at prefill or in a cache-free forward."""
    if cfg.ln_placement == "post":
        return _post_ln_block(p, cfg, slot, x, q_pos=q_pos, causal=causal,
                              impl=impl), None, None
    if slot.kind == "rwkv":
        return (*_rwkv_block(p, cfg, x, cache=cache, task_ids=task_ids,
                             gate=gate, impl=impl), None)
    acfg = cfg.adapter
    ad = _adapter(p, cfg, task_ids)
    houlsby = _baseline(p, cfg, "houlsby")
    h = apply_norm(p["attn_norm"], cfg, x)
    if slot.kind == "rec":  # the adapter under any position, d_model wide
        a, cache = rec_apply(p["rec"], cfg, h, cache)
        seam_ad = ad
    else:
        concat = None
        if ad is not None and acfg.position == "attn_concat":
            concat = ((select_rows(ad["w"], task_ids),
                       select_rows(ad["b"], task_ids))
                      if ad["w"].dim() == 2 else (ad["w"], ad["b"]))
        a, cache = apply_attn(p["attn"], cfg, slot, h, q_pos=q_pos,
                              cache=cache, cache_len=cache_len,
                              write_pos=write_pos, kv_lens=kv_lens,
                              tables=tables, concat_adapter=concat,
                              adapter=p.get("adapter"), causal=causal,
                              impl=impl)
        seam_ad = ad if acfg.position == "attn_out" else None
    if houlsby is not None:
        a = _houlsby(houlsby["attn_ad"], a)
    if slot.cross_attn:
        x, hc = _residual_seam(p, cfg, x, a, seam_ad, task_ids, gate, impl,
                               norm=p["cross_norm"])
        ca, cc = apply_attn(p["cross"], cfg, slot, hc, q_pos=q_pos,
                            cache=None if cache is None
                            else cache.get("cross"),
                            cache_len=cache_len, kv_x=enc_out, impl=impl)
        x = x + ca
        h = apply_norm(p["ffn_norm"], cfg, x)
        if cache_len is not None:  # prefill: the self and cross caches
            cache = {**cache, **cc}
    else:
        x, h = _residual_seam(p, cfg, x, a, seam_ad, task_ids, gate, impl)
    aux = None
    if slot.moe:
        f, aux = moe_apply(p["moe"], cfg, h)
    else:
        f = apply_mlp(p["mlp"], cfg, h, impl, ia3=_ia3_scale(p, cfg))
    if houlsby is not None:
        f = _houlsby(houlsby["ffn_ad"], f)
    if cfg.post_norms:
        f = apply_norm(p["post_ffn_norm"], cfg, f)
    return x + f, cache, aux


def _ia3_scale(p: dict, cfg: ModelCfg) -> Optional[torch.Tensor]:
    ia3 = _baseline(p, cfg, "ia3")
    return None if ia3 is None else ia3["lff"]


def _adapter(p: dict, cfg: ModelCfg, task_ids) -> Optional[dict]:
    """The block's Hadamard adapter (one (d,) pair or a (T, d) bank), or
    None."""
    ad = p.get("adapter") if cfg.adapter.kind == "hadamard" else None
    if ad is not None and ad["w"].dim() == 2 and task_ids is None:
        raise ValueError("a multi-task bank needs per-row task_ids")
    return ad


def _residual_seam(p: dict, cfg: ModelCfg, x, a, ad, task_ids, gate,
                   impl: str, norm: Optional[dict] = None):
    """The mixer output `a` through the adapter `ad` (None: no adapter at
    this seam), the residual add and the norm that follows: `norm`, the
    ffn norm unless given (a cross slot's `cross_norm`). Returns (x, h)."""
    nrm = p["ffn_norm"] if norm is None else norm
    if ad is not None and ad["w"].dim() == 2:  # a bank: #9 gated, else #6
        a = (ops.masked_multitask_hadamard(a, ad["w"], ad["b"], gate,
                                           task_ids, impl=impl)
             if gate is not None else
             ops.multitask_hadamard(a, ad["w"], ad["b"], task_ids,
                                    impl=impl))
    elif ad is not None and not cfg.post_norms:
        return FusedAdapterResidualNorm.apply(
            a, x, ad["w"], ad["b"], nrm["scale"], nrm.get("bias"),
            cfg.norm_eps, impl)
    elif ad is not None:  # a post-norm between adapter and add: #1 alone
        a = HadamardAffine.apply(a, ad["w"], ad["b"], impl)
    if cfg.post_norms:
        a = apply_norm(p["post_attn_norm"], cfg, a)
    x = x + a
    return x, apply_norm(nrm, cfg, x)


def _rwkv_block(p: dict, cfg: ModelCfg, x: torch.Tensor, *,
                cache: Optional[dict], task_ids, gate, impl: str):
    """Pre-LN RWKV6 block: time mix, adapter seam, channel mix, as
    `repro/models/program.py:156-198`: Houlsby's `attn_ad` on the time-mix
    output (before the post-norm and the residual add) and its `ffn_ad` on
    the channel-mix output; LoRA and IA3 leaves are read by no op. Returns
    (x, cache): the given cache written in place, or at prefill the fresh
    {"S", "tm_prev", "cm_prev"}."""
    ad = _adapter(p, cfg, task_ids)
    houlsby = _baseline(p, cfg, "houlsby")
    h = apply_norm(p["attn_norm"], cfg, x)
    a, tm = rwkv_time_mix(p["rwkv_tm"], cfg, h, cache, impl)
    if houlsby is not None:
        a = _houlsby(houlsby["attn_ad"], a)
    x, h = _residual_seam(p, cfg, x, a, ad, task_ids, gate, impl)
    f, cm = rwkv_channel_mix(p["rwkv_cm"], cfg, h, cache)
    if houlsby is not None:
        f = _houlsby(houlsby["ffn_ad"], f)
    if cfg.post_norms:
        f = apply_norm(p["post_ffn_norm"], cfg, f)
    return x + f, (cache if cache is not None else {**tm, **cm})


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
    houlsby = _baseline(p, cfg, "houlsby")
    a, _ = apply_attn(p["attn"], cfg, slot, x, q_pos=q_pos,
                      concat_adapter=concat, adapter=p.get("adapter"),
                      causal=causal, impl=impl)
    if houlsby is not None:
        a = _houlsby(houlsby["attn_ad"], a)
    attn_norm = p["attn_norm"]  # "A": the attention-output norm
    if ad is not None and acfg.position == "attn_out":
        _, x = FusedAdapterResidualNorm.apply(
            a, x, ad["w"], ad["b"], attn_norm["scale"], attn_norm.get("bias"),
            cfg.norm_eps, impl)
    else:
        x = apply_norm(attn_norm, cfg, x + a)
    f = apply_mlp(p["mlp"], cfg, x, impl, ia3=_ia3_scale(p, cfg))
    if houlsby is not None:
        f = _houlsby(houlsby["ffn_ad"], f)
    # "N": the post-intermediate norm
    return apply_norm(p["ffn_norm"], cfg, x + f)
