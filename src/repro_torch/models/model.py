"""The decoder LM (port of `repro.models.model`, the serving subset):
init, embedding, tied head, prefill and per-row decode.

Parameters are a plain dict:
  {"embed": {"table"}, "layers": [block params, ...], "final_norm": {...}}
with one entry of "layers" per block in execution order (`cfg.layer_slots`);
"lm_head" only when embeddings are untied. Caches are a list with one
{"k", "v"} dict per layer. All functions take `impl` and hand it to every
kernel call ("auto" on the serving path; "ref" for the plain versions).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.common.types import ModelCfg
from repro_torch.models.attention import check_slot, decode_tables
from repro_torch.models.layers import apply_norm, dense, dense_init, embed_init, norm_init
from repro_torch.models.program import block_apply, block_init


def _check_cfg(cfg: ModelCfg) -> None:
    if cfg.family != "decoder":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported: the first slice serves "
            "decoder LMs (BERT encoders come with the training slice)")
    for slot in cfg.layer_slots():
        check_slot(slot)


def init_params(gen: torch.Generator, cfg: ModelCfg) -> dict:
    """Random parameters from `gen`, on the generator's device. Adapters
    start at the identity (w=1, b=0), as in the JAX package."""
    _check_cfg(cfg)
    p = {"embed": {"table": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       cfg.pdtype)}}
    p["layers"] = [block_init(gen, cfg, s) for s in cfg.layer_slots()]
    p["final_norm"] = norm_init(cfg, gen.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = {"kernel": dense_init(gen, cfg.d_model, cfg.vocab_size,
                                             cfg.pdtype)}
    return p


def embed_tokens(params: dict, cfg: ModelCfg, tokens: torch.Tensor):
    x = params["embed"]["table"][tokens].to(cfg.cdtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype)
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
                impl="auto"):
    new_caches = []
    for i, (p, slot) in enumerate(zip(params["layers"], cfg.layer_slots())):
        x, c = block_apply(p, cfg, slot, x, q_pos=q_pos,
                           cache=None if caches is None else caches[i],
                           cache_len=cache_len, write_pos=write_pos,
                           kv_lens=kv_lens, tables=tables, task_ids=task_ids,
                           impl=impl)
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


def init_decode_caches(cfg: ModelCfg, batch: int, cache_len: int,
                       device) -> List[dict]:
    """Zeroed per-layer (batch, cache_len, KH, D) K/V caches."""
    _check_cfg(cfg)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}
            for _ in cfg.layer_slots()]
