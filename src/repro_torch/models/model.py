"""Model families (port of `repro.models.model`): the decoder LM (init,
embedding, tied head, prefill and per-row decode) and the BERT-style
encoder classifier (learned positions, segment embeddings, post-LN
blocks, pooler and classifier).

Parameters are a plain dict:
  {"embed": {"table"}, "layers": [block params, ...], "final_norm": {...}}
with one entry of "layers" per block in execution order (`cfg.layer_slots`);
"lm_head" only when embeddings are untied; an encoder adds "pos_embed",
"type_embed", "embed_norm", "pooler" and an fp32 "classifier". Caches are
a list with one {"k", "v"} dict per layer. All functions take `impl` and
hand it to every kernel call ("auto" on the serving and training paths;
"ref" for the plain versions).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.common.types import ModelCfg
from repro_torch.models.attention import check_slot, decode_tables
from repro_torch.models.layers import (apply_norm, dense, dense_init, embed_init,
                                      gen_device, norm_init)
from repro_torch.models.program import block_apply, block_init


def _check_cfg(cfg: ModelCfg) -> None:
    if cfg.family not in ("decoder", "encoder"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported: the port runs decoder LMs "
            "and BERT-style encoders; encdec (whisper) and VLM backbones "
            "arrive with the other-families slice")
    for slot in cfg.layer_slots():
        check_slot(slot)


def init_params(gen: torch.Generator, cfg: ModelCfg) -> dict:
    """Random parameters from `gen`, on the generator's device. Adapters
    start at the identity (w=1, b=0), as in the JAX package."""
    _check_cfg(cfg)
    dev, d = gen_device(gen), cfg.d_model
    p = {"embed": {"table": embed_init(gen, cfg.vocab_size, d, cfg.pdtype)}}
    if cfg.pos == "learned":
        p["pos_embed"] = {"table": embed_init(gen, cfg.max_seq_len, d,
                                              cfg.pdtype)}
    if cfg.n_segment_types:
        p["type_embed"] = {"table": embed_init(gen, cfg.n_segment_types, d,
                                               cfg.pdtype)}
        p["embed_norm"] = norm_init(cfg, dev)
    p["layers"] = [block_init(gen, cfg, s) for s in cfg.layer_slots()]
    # an encoder never reads final_norm; JAX makes it all the same, and
    # the parameter counts must agree
    p["final_norm"] = norm_init(cfg, dev)
    if cfg.family == "encoder":
        p["pooler"] = {"kernel": dense_init(gen, d, d, cfg.pdtype),
                       "bias": torch.zeros((d,), dtype=cfg.pdtype, device=dev)}
        p["classifier"] = {
            "kernel": dense_init(gen, d, cfg.n_classes, torch.float32),
            "bias": torch.zeros((cfg.n_classes,), dtype=torch.float32,
                                device=dev)}
    elif not cfg.tie_embeddings:
        p["lm_head"] = {"kernel": dense_init(gen, cfg.d_model, cfg.vocab_size,
                                             cfg.pdtype)}
    return p


def embed_tokens(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 type_ids: Optional[torch.Tensor] = None):
    cdt = cfg.cdtype
    x = params["embed"]["table"][tokens].to(cdt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt)
    if cfg.pos == "learned" and positions is not None:
        x = x + params["pos_embed"]["table"][positions].to(cdt)
    if cfg.n_segment_types and type_ids is not None:
        x = x + params["type_embed"]["table"][type_ids.long()].to(cdt)
    if "embed_norm" in params:
        x = apply_norm(params["embed_norm"], cfg, x)
    return x


def lm_logits(params: dict, cfg: ModelCfg, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits; the tied head is a plain matmul against the table."""
    if cfg.tie_embeddings:
        logits = torch.matmul(h, params["embed"]["table"].to(cfg.cdtype).T)
    else:
        logits = dense(h, params["lm_head"]["kernel"], cfg.cdtype)
    logits = logits.float()
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _run_layers(params, cfg, x, *, q_pos, caches=None, cache_len=None,
                write_pos=None, kv_lens=None, tables=None, task_ids=None,
                causal=True, impl="auto"):
    new_caches = []
    for i, (p, slot) in enumerate(zip(params["layers"], cfg.layer_slots())):
        x, c = block_apply(p, cfg, slot, x, q_pos=q_pos,
                           cache=None if caches is None else caches[i],
                           cache_len=cache_len, write_pos=write_pos,
                           kv_lens=kv_lens, tables=tables, task_ids=task_ids,
                           causal=causal, impl=impl)
        new_caches.append(c)
    return x, new_caches


def prefill_lm(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
               cache_len: int, last_pos: Optional[int] = None,
               task_ids: Optional[torch.Tensor] = None, impl: str = "auto"):
    """tokens (B, S) -> (logits (B, 1, V) at `last_pos` (default the last
    position), caches of length cache_len holding positions 0..S-1).
    A right-padded prompt passes its true last index as last_pos: under
    causal masking the pad never reaches positions <= last_pos."""
    S = tokens.shape[1]
    x = embed_tokens(params, cfg, tokens)
    q_pos = torch.arange(S, device=tokens.device)
    x, caches = _run_layers(params, cfg, x, q_pos=q_pos, cache_len=cache_len,
                            task_ids=task_ids, impl=impl)
    lp = S - 1 if last_pos is None else int(last_pos)
    x = apply_norm(params["final_norm"], cfg, x[:, lp:lp + 1])
    return lm_logits(params, cfg, x), caches


def decode_lm(params: dict, cfg: ModelCfg, caches: List[dict],
              token: torch.Tensor, pos: torch.Tensor,
              task_ids: Optional[torch.Tensor] = None, impl: str = "auto"):
    """One decode step. token (B, 1); pos (B,) per-row absolute positions
    (continuous batching: each cache row is an independent request). The
    caches are written in place and returned."""
    B = token.shape[0]
    pos = pos.to(device=token.device, dtype=torch.long)
    L = caches[0]["k"].shape[1]
    tables = decode_tables(B, L, token.device)
    kv_lens = (pos + 1).to(torch.int32)
    x = embed_tokens(params, cfg, token)
    x, caches = _run_layers(params, cfg, x, q_pos=pos[:, None], caches=caches,
                            write_pos=pos, kv_lens=kv_lens, tables=tables,
                            task_ids=task_ids, impl=impl)
    x = apply_norm(params["final_norm"], cfg, x)
    return lm_logits(params, cfg, x), caches


def forward_encoder(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                    type_ids: Optional[torch.Tensor] = None,
                    impl: str = "auto"):
    """tokens (B, S) [, type_ids (B, S)] -> (fp32 class logits (B,
    n_classes), pooled (B, d), sequence states (B, S, d)); non-causal
    self-attention over the whole sequence."""
    _check_cfg(cfg)
    if cfg.family != "encoder":
        raise ValueError(f"forward_encoder needs an encoder config, got "
                         f"family {cfg.family!r}")
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed_tokens(params, cfg, tokens, positions=pos, type_ids=type_ids)
    x, _ = _run_layers(params, cfg, x, q_pos=pos, causal=False, impl=impl)
    pooler = params["pooler"]
    pooled = torch.tanh(dense(x[:, 0], pooler["kernel"], cfg.cdtype)
                        + pooler["bias"].to(cfg.cdtype))
    clf = params["classifier"]
    logits = pooled.float() @ clf["kernel"] + clf["bias"]
    return logits, pooled, x


def init_decode_caches(cfg: ModelCfg, batch: int, cache_len: int,
                       device) -> List[dict]:
    """Zeroed per-layer (batch, cache_len, KH, D) K/V caches."""
    _check_cfg(cfg)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}
            for _ in cfg.layer_slots()]
