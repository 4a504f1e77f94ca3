"""Model families (port of `repro.models.model`): the decoder LM (init,
embedding, tied head, the teacher-forced training forward, prefill and
per-row decode) and the BERT-style
encoder classifier (learned positions, segment embeddings, post-LN
blocks, pooler and classifier).

Parameters are a plain dict:
  {"embed": {"table"}, "layers": [block params, ...], "final_norm": {...}}
with one entry of "layers" per block in execution order (`cfg.layer_slots`);
"lm_head" only when embeddings are untied; an encoder adds "pos_embed",
"type_embed", "embed_norm", "pooler" and an fp32 "classifier". Caches are
a list with one dict per layer: {"k", "v"} for an attention layer (of the
cache length, or a windowed layer's ring, `attention.cache_size`), the
recurrent state {"S", "tm_prev", "cm_prev"} for an RWKV6 layer and {"h",
"conv"} for an RG-LRU layer (`models/recurrent.py`). A
mixture-of-experts layer (`models/moe.py`) holds "moe" in place of "mlp";
its tokens route together, so under MoE the rows of a batch are no longer
independent: every row (an idle slot's too) takes expert capacity. A paged
pool (`init_paged_pool`) is such a list too: {"k", "v"} block pools of
(num_blocks, page, KH, D) per layer, block 0 the allocator's null block,
addressed through per-row block tables (B, nbt) int32 that every layer
shares (a windowed layer's ring in their first ring // page entries).
All functions take `impl` and
hand it to every kernel call ("auto" on the serving and training paths;
"ref" for the plain versions).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.common.types import ModelCfg
from repro_torch.models.attention import (cache_size, check_slot,
                                          decode_tables, pool_init, pool_view)
from repro_torch.models.layers import (apply_norm, dense_init, embed_init,
                                      gen_device, norm_init)
from repro_torch.models.program import block_apply, block_init
from repro_torch.models.recurrent import rec_cache_init
from repro_torch.models.rwkv import rwkv_cache_init
from repro_torch.quant.qtensor import qdense


def _check_cfg(cfg: ModelCfg) -> None:
    if cfg.family not in ("decoder", "encoder"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported: the port runs decoder LMs "
            "and BERT-style encoders; encdec (whisper) and VLM backbones "
            "arrive with the other-families slice")
    for slot in cfg.layer_slots():
        check_slot(slot)
        if slot.moe and cfg.moe is None:
            raise ValueError(f"{cfg.name}: a moe slot needs cfg.moe (a "
                             "MoECfg)")


def has_attention(cfg: ModelCfg) -> bool:
    """Whether any layer holds a KV cache."""
    return any(s.kind == "attn" for s in cfg.layer_slots())


def has_window(cfg: ModelCfg) -> bool:
    """Whether any layer keeps a windowed ring cache."""
    return any(s.window is not None for s in cfg.layer_slots())


def has_recurrent_state(cfg: ModelCfg) -> bool:
    """Whether any layer carries recurrent state (an RWKV6 or an RG-LRU
    layer), which takes in every token it sees: a pad token, unlike under
    causal attention, is not invisible to it."""
    return any(s.kind in ("rwkv", "rec") for s in cfg.layer_slots())


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


def lm_logits(params: dict, cfg: ModelCfg, h: torch.Tensor,
              impl: str = "auto") -> torch.Tensor:
    """fp32 logits; the tied head is a plain matmul against the table (it
    is never quantized), an untied head goes through `qdense`."""
    if cfg.tie_embeddings:
        logits = torch.matmul(h, params["embed"]["table"].to(cfg.cdtype).T)
    else:
        logits = qdense(h, params["lm_head"]["kernel"], cfg.cdtype, impl,
                        tag="lm_head")
    logits = logits.float()
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _run_layers(params, cfg, x, *, q_pos, caches=None, cache_len=None,
                write_pos=None, kv_lens=None, tables=None, task_ids=None,
                gates=None, causal=True, impl="auto"):
    """Returns (x, caches, aux): aux the sum of the MoE blocks'
    load-balancing losses in layer order (JAX's `_run_groups`), None when
    no block has one. tables: one (B, nbt) tensor every layer shares, or a
    list of one a layer."""
    new_caches, aux_total = [], None
    for i, (p, slot) in enumerate(zip(params["layers"], cfg.layer_slots())):
        x, c, aux = block_apply(p, cfg, slot, x, q_pos=q_pos,
                                cache=None if caches is None else caches[i],
                                cache_len=cache_len, write_pos=write_pos,
                                kv_lens=kv_lens,
                                tables=(tables[i] if isinstance(tables, list)
                                        else tables), task_ids=task_ids,
                                gate=None if gates is None else gates[i],
                                causal=causal, impl=impl)
        new_caches.append(c)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, new_caches, aux_total


def forward_hidden(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                   impl: str = "auto"):
    """tokens (B, S) -> (final-norm hidden states (B, S, d), aux) of the
    teacher-forced causal forward (training), as JAX's `forward_hidden`:
    aux is the summed MoE load-balancing loss, an fp32 scalar, 0 for a
    model without MoE blocks. The logits are left to the caller, so the
    loss can compute them in sequence chunks (cfg.ce_chunk). No caches are
    made. Autograd runs through the kernels' Functions: the adapter seam
    (#3 forward; the norm VJP in plain torch, then #2), attention (#4
    forward; the tiled plain backward) and, over a quantized trunk, every
    projection (#7 forward; dx in plain torch).

    JAX wraps each layer in `jax.checkpoint` under cfg.remat, which
    trades memory for recompute and changes no number; the port keeps
    every layer's activations (qwen3-0.6b at 16 x 128 tokens fits the
    card's memory) and reads no remat option. An RWKV6 layer runs #8
    forward and, under autograd, the recurrence's plain chunked backward
    (`kernels.rwkv6.WKV6`)."""
    _check_cfg(cfg)
    if cfg.family != "decoder":
        raise ValueError(f"forward_hidden needs a decoder config, got "
                         f"family {cfg.family!r}")
    x = embed_tokens(params, cfg, tokens)
    q_pos = torch.arange(tokens.shape[1], device=tokens.device)
    x, _, aux = _run_layers(params, cfg, x, q_pos=q_pos, causal=True,
                            impl=impl)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return apply_norm(params["final_norm"], cfg, x), aux


def forward_lm(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
               impl: str = "auto") -> torch.Tensor:
    """Teacher-forced full-sequence fp32 logits (B, S, V) (training)."""
    return lm_logits(params, cfg,
                     forward_hidden(params, cfg, tokens, impl)[0], impl)


def prefill_lm(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
               cache_len: int, last_pos: Optional[int] = None,
               task_ids: Optional[torch.Tensor] = None,
               gates: Optional[torch.Tensor] = None, impl: str = "auto"):
    """tokens (B, S) -> (logits (B, 1, V) at `last_pos` (default the last
    position), caches of length cache_len holding positions 0..S-1).
    A right-padded prompt passes its true last index as last_pos: under
    causal masking the pad never reaches positions <= last_pos; a config
    with recurrent state refuses one, since the state would take the pad
    in. Under MoE blocks the pad tokens still route and take capacity
    from the prompt's, as they do in JAX. gates:
    (L, bank rows) fp32 row gates of a hot-swap bank (`AdapterBank`), on
    the params' device; with them every block's bank adapter runs the
    masked multitask op with its layer's row."""
    S = tokens.shape[1]
    lp = S - 1 if last_pos is None else int(last_pos)
    if lp != S - 1 and has_recurrent_state(cfg):
        raise ValueError(
            f"last_pos {lp} of a {S}-token prompt: a layer's recurrent state "
            "would take in the tokens after it; prefill the prompt unpadded")
    x = embed_tokens(params, cfg, tokens)
    q_pos = torch.arange(S, device=tokens.device)
    x, caches, _ = _run_layers(params, cfg, x, q_pos=q_pos,
                               cache_len=cache_len, task_ids=task_ids,
                               gates=gates, impl=impl)
    x = apply_norm(params["final_norm"], cfg, x[:, lp:lp + 1])
    return lm_logits(params, cfg, x, impl), caches


def _pool_step(params, cfg, pool, tokens, write_pos, tables, task_ids,
               gates, impl, positions=None):
    """Run `tokens` (B, S) at write_pos (B, S) over block pools (one per
    attention layer, or a recurrent layer's state), written in place; kv_lens
    = the last write + 1, so each row's S queries sit at its write
    positions (a windowed layer derives its own, the last write, in
    `apply_attn`). tables: shared, or a list of one a layer. Returns
    final-norm hidden states (B, S, d)."""
    kv_lens = (write_pos[:, -1] + 1).to(torch.int32)
    x = embed_tokens(params, cfg, tokens, positions)
    x, _, _ = _run_layers(params, cfg, x, q_pos=write_pos, caches=pool,
                          write_pos=write_pos, kv_lens=kv_lens, tables=tables,
                          task_ids=task_ids, gates=gates, impl=impl)
    return x


def _slot_step(params, cfg, caches, tokens, write_pos, task_ids, gates,
               impl):
    """`_pool_step` over contiguous slot caches, each viewed as a pool of
    `decode_page(L)`-token pages with its own tables (`decode_tables`, one
    per cache length: a windowed layer's ring is shorter than a full-range
    layer's cache); the caches are written in place."""
    tables = None
    views = caches
    if has_attention(cfg):
        by_len = {}
        tables = []
        for c in caches:
            L = c["k"].shape[1] if "k" in c else None
            if L is not None and L not in by_len:
                by_len[L] = decode_tables(tokens.shape[0], L, tokens.device)
            tables.append(by_len.get(L))
        views = [pool_view(c) if "k" in c else c for c in caches]
    return _pool_step(params, cfg, views, tokens, write_pos, tables,
                      task_ids, gates, impl)


def _positions(pos: torch.Tensor, S: int, device) -> torch.Tensor:
    pos = pos.to(device=device, dtype=torch.long)
    return pos[:, None] + torch.arange(S, device=device)


def decode_lm(params: dict, cfg: ModelCfg, caches: List[dict],
              token: torch.Tensor, pos: torch.Tensor,
              task_ids: Optional[torch.Tensor] = None,
              gates: Optional[torch.Tensor] = None, impl: str = "auto"):
    """One decode step. token (B, 1); pos (B,) per-row absolute positions
    (continuous batching: each cache row is an independent request). The
    caches are written in place and returned. gates: as for
    `prefill_lm`."""
    wp = _positions(pos, 1, token.device)
    x = _slot_step(params, cfg, caches, token, wp, task_ids, gates, impl)
    x = apply_norm(params["final_norm"], cfg, x)
    return lm_logits(params, cfg, x, impl), caches


def _check_verify(cfg: ModelCfg) -> None:
    if has_recurrent_state(cfg):
        raise ValueError("a speculative verify needs full-attention layers: "
                         "recurrent state would take the drafts in")
    if has_window(cfg):
        raise ValueError("a speculative verify needs full-attention layers: "
                         "a ring window evicts entries the earlier queries "
                         "still need")


def verify_lm(params: dict, cfg: ModelCfg, caches: List[dict],
              tokens: torch.Tensor, pos: torch.Tensor,
              task_ids: Optional[torch.Tensor] = None,
              gates: Optional[torch.Tensor] = None, impl: str = "auto"):
    """Speculative-decoding verify: score S = k+1 tokens per row in one
    forward. tokens (B, S) = [last accepted token, k drafts]; pos (B,) the
    absolute position of tokens[:, 0]. K/V land at pos+j for every j,
    over any stale rejected drafts of the previous tick, and query j sees
    keys up to pos+j alone, so logits[:, j] (fp32, (B, S, V)) is what a
    plain decode step at pos+j would give."""
    _check_verify(cfg)
    wp = _positions(pos, tokens.shape[1], tokens.device)
    x = _slot_step(params, cfg, caches, tokens, wp, task_ids, gates, impl)
    x = apply_norm(params["final_norm"], cfg, x)
    return lm_logits(params, cfg, x, impl), caches


def init_paged_pool(cfg: ModelCfg, num_blocks: int, page: int,
                    quant: Optional[str] = None, device=None) -> List[dict]:
    """Zeroed block pools, one per layer (`attention.pool_init`); block 0
    is the allocator's reserved null block. Every layer's pool holds all
    num_blocks blocks, as JAX's does: the block tables are shared, and a
    windowed layer's ring uses the first ring // page entries of a row's
    table. Paged serving is attention-only: a recurrent layer has no
    block-structured state."""
    _check_cfg(cfg)
    for slot in cfg.layer_slots():
        if slot.kind != "attn" or slot.cross_attn:
            raise ValueError("paged KV pools require pure attention slots "
                             f"(got kind={slot.kind!r}, "
                             f"cross_attn={slot.cross_attn})")
    return [pool_init(cfg, num_blocks, page, quant, device)
            for _ in cfg.layer_slots()]


def decode_lm_paged(params: dict, cfg: ModelCfg, pool: List[dict],
                    token: torch.Tensor, pos: torch.Tensor,
                    block_tables: torch.Tensor,
                    task_ids: Optional[torch.Tensor] = None,
                    gates: Optional[torch.Tensor] = None,
                    impl: str = "auto"):
    """One paged decode step: as `decode_lm`, each row's KV in the pool
    blocks its `block_tables` row (B, nbt) int32 names. A free slot's
    all-null row writes into block 0 and its logits are ignored."""
    wp = _positions(pos, 1, token.device)
    x = _pool_step(params, cfg, pool, token, wp, block_tables, task_ids,
                   gates, impl)
    x = apply_norm(params["final_norm"], cfg, x)
    return lm_logits(params, cfg, x, impl), pool


def verify_lm_paged(params: dict, cfg: ModelCfg, pool: List[dict],
                    tokens: torch.Tensor, pos: torch.Tensor,
                    block_tables: torch.Tensor,
                    task_ids: Optional[torch.Tensor] = None,
                    gates: Optional[torch.Tensor] = None,
                    impl: str = "auto"):
    """`verify_lm` against a paged pool: every page the k+1 writes touch
    must be allocated (the scheduler does so before the tick)."""
    _check_verify(cfg)
    wp = _positions(pos, tokens.shape[1], tokens.device)
    x = _pool_step(params, cfg, pool, tokens, wp, block_tables, task_ids,
                   gates, impl)
    x = apply_norm(params["final_norm"], cfg, x)
    return lm_logits(params, cfg, x, impl), pool


def extend_lm(params: dict, cfg: ModelCfg, pool: List[dict],
              tokens: torch.Tensor, block_tables: torch.Tensor, start: int,
              kv_len: int, last_pos: int,
              task_ids: Optional[torch.Tensor] = None,
              gates: Optional[torch.Tensor] = None, impl: str = "auto"):
    """Prefix-cache partial hit (B = 1): run the prompt suffix `tokens`
    (1, S), right-padded to a page multiple, at positions start..start+S-1,
    writing its K/V into the blocks the table maps them to and attending
    over the shared prefix blocks and its own. kv_len is the true prompt
    length (start < kv_len <= start + S). JAX masks by it; #5 takes its
    queries right-aligned under kv_lens, so the port passes start + S:
    every pad key sits after every real query, which the causal bound
    hides. Returns (logits (1, 1, V) at suffix index last_pos, pool)."""
    S = tokens.shape[1]
    if has_window(cfg):
        raise ValueError("a prefix-cache extend needs full-attention layers: "
                         "ring layouts fold the pad tokens in")
    if not start < kv_len <= start + S or not 0 <= last_pos < S:
        raise ValueError(f"extend: start {start}, kv_len {kv_len}, last_pos "
                         f"{last_pos} for a {S}-token suffix")
    wp = start + torch.arange(S, device=tokens.device)[None, :]
    x = _pool_step(params, cfg, pool, tokens, wp, block_tables, task_ids,
                   gates, impl, positions=wp)
    x = apply_norm(params["final_norm"], cfg, x[:, last_pos:last_pos + 1])
    return lm_logits(params, cfg, x, impl), pool


def encode_sequence(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                    type_ids: Optional[torch.Tensor] = None,
                    impl: str = "auto") -> torch.Tensor:
    """tokens (B, S) [, type_ids (B, S)] -> the encoder's sequence states
    (B, S, d), no pooler: non-causal self-attention over the whole
    sequence."""
    _check_cfg(cfg)
    if cfg.family != "encoder":
        raise ValueError(f"the encoder forward needs an encoder config, got "
                         f"family {cfg.family!r}")
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed_tokens(params, cfg, tokens, positions=pos, type_ids=type_ids)
    x, _, _ = _run_layers(params, cfg, x, q_pos=pos, causal=False,
                          impl=impl)
    return x


def forward_encoder(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                    type_ids: Optional[torch.Tensor] = None,
                    impl: str = "auto"):
    """tokens (B, S) [, type_ids (B, S)] -> (fp32 class logits (B,
    n_classes), pooled (B, d), sequence states (B, S, d))."""
    x = encode_sequence(params, cfg, tokens, type_ids, impl)
    pooler = params["pooler"]
    pooled = torch.tanh(qdense(x[:, 0], pooler["kernel"], cfg.cdtype)
                        + pooler["bias"].to(cfg.cdtype))
    clf = params["classifier"]
    logits = pooled.float() @ clf["kernel"] + clf["bias"]
    return logits, pooled, x


def init_decode_caches(cfg: ModelCfg, batch: int, cache_len: int,
                       device) -> List[dict]:
    """Zeroed per-layer caches: (batch, size, KH, D) K/V for an attention
    layer, size = cache_len or a windowed layer's ring
    (`attention.cache_size`), the recurrent state of `rwkv_cache_init` or
    `rec_cache_init` (no length) for an RWKV6 or an RG-LRU layer."""
    _check_cfg(cfg)

    def one(slot):
        if slot.kind == "rwkv":
            return rwkv_cache_init(cfg, batch, device)
        if slot.kind == "rec":
            return rec_cache_init(cfg, batch, device)
        shape = (batch, cache_size(slot, cache_len), cfg.n_kv_heads,
                 cfg.head_dim)
        return {name: torch.zeros(shape, dtype=cfg.cdtype, device=device)
                for name in ("k", "v")}

    return [one(slot) for slot in cfg.layer_slots()]
