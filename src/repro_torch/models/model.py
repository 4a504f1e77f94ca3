"""Model families (port of `repro.models.model`): the decoder LM (init,
embedding, tied head, the teacher-forced training forward, prefill and
per-row decode), the BERT-style encoder classifier (learned positions,
segment embeddings, post-LN blocks, pooler and classifier), the
encoder-decoder (whisper: an audio encoder over precomputed frame
embeddings, a causal decoder with cross-attention) and the VLM
(internvl2: precomputed patch embeddings through `vlm_proj`, prepended to
the text of a decoder LM).

Parameters are a plain dict:
  {"embed": {"table"}, "layers": [block params, ...], "final_norm": {...}}
with one entry of "layers" per block in execution order (`cfg.layer_slots`);
"lm_head" only when embeddings are untied; an encoder adds "pos_embed",
"type_embed", "embed_norm", "pooler" and an fp32 "classifier"; an encdec
model "enc_layers" (the encoder's blocks, `cfg.enc_layer_slots`),
"enc_final_norm", "enc_pos_embed" and the decoder's "pos_embed"; a VLM
"vlm_proj". Caches are
a list with one dict per layer: {"k", "v"} for an attention layer (of the
cache length, or a windowed layer's ring, `attention.cache_size`), the
recurrent state {"S", "tm_prev", "cm_prev"} for an RWKV6 layer and {"h",
"conv"} for an RG-LRU layer (`models/recurrent.py`); a cross-attention
layer adds the encoder's {"ck", "cv"} (B, S_enc, KH, D) beside its own. A
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
                                          cross_view, decode_tables,
                                          pool_init, pool_view)
from repro_torch.models.layers import (apply_norm, dense_init, embed_init,
                                      gen_device, norm_init)
from repro_torch.models.program import block_apply, block_init
from repro_torch.models.recurrent import rec_cache_init
from repro_torch.models.rwkv import rwkv_cache_init
from repro_torch.quant.qtensor import qdense


def _check_cfg(cfg: ModelCfg) -> None:
    if cfg.family not in ("decoder", "encoder", "encdec", "vlm"):
        raise NotImplementedError(f"unknown model family {cfg.family!r}")
    if (cfg.family == "encdec") != bool(cfg.enc_groups):
        raise ValueError(f"{cfg.name}: an encdec config holds its encoder "
                         "in enc_groups, and only an encdec config has "
                         f"enc_groups (family {cfg.family!r}, "
                         f"{len(cfg.enc_groups)} enc_groups)")
    for slot in cfg.layer_slots() + cfg.enc_layer_slots():
        check_slot(slot)
        if slot.moe and cfg.moe is None:
            raise ValueError(f"{cfg.name}: a moe slot needs cfg.moe (a "
                             "MoECfg)")
    if any(s.cross_attn for s in cfg.enc_layer_slots()) or (
            cfg.family != "encdec"
            and any(s.cross_attn for s in cfg.layer_slots())):
        raise ValueError(f"{cfg.name}: cross-attention slots belong to an "
                         "encdec config's decoder")


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
    if cfg.enc_groups:
        p["enc_layers"] = [block_init(gen, cfg, s)
                           for s in cfg.enc_layer_slots()]
        p["enc_final_norm"] = norm_init(cfg, dev)
        p["enc_pos_embed"] = {"table": embed_init(gen, cfg.n_audio_frames, d,
                                                  cfg.pdtype)}
    if cfg.family == "vlm":
        p["vlm_proj"] = {"kernel": dense_init(gen, d, d, cfg.pdtype)}
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
                gates=None, causal=True, enc_out=None, encoder=False,
                impl="auto"):
    """Returns (x, caches, aux): aux the sum of the MoE blocks'
    load-balancing losses in layer order (JAX's `_run_groups`), None when
    no block has one. tables: one (B, nbt) tensor every layer shares, or a
    list of one a layer. encoder: run the encdec encoder's stack
    ("enc_layers") in place of the decoder's."""
    layers, slots = ((params["enc_layers"], cfg.enc_layer_slots())
                     if encoder else (params["layers"], cfg.layer_slots()))
    new_caches, aux_total = [], None
    for i, (p, slot) in enumerate(zip(layers, slots)):
        x, c, aux = block_apply(p, cfg, slot, x, q_pos=q_pos,
                                cache=None if caches is None else caches[i],
                                cache_len=cache_len, write_pos=write_pos,
                                kv_lens=kv_lens,
                                tables=(tables[i] if isinstance(tables, list)
                                        else tables), task_ids=task_ids,
                                gate=None if gates is None else gates[i],
                                causal=causal, enc_out=enc_out, impl=impl)
        new_caches.append(c)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, new_caches, aux_total


def _zero_aux(aux, device):
    """The summed MoE aux loss, or an fp32 0 where no block has one."""
    return (torch.zeros((), dtype=torch.float32, device=device)
            if aux is None else aux)


def _decoder_embed(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                   patches: Optional[torch.Tensor] = None,
                   impl: str = "auto") -> torch.Tensor:
    """JAX's `_decoder_embed`: the tokens embedded at positions 0..S_txt-1
    (a learned position table adds them); a VLM's patches (B, n_img, d)
    projected by `vlm_proj` (`qdense`, tag "vlm_proj") and put ahead of
    the text, (B, n_img + S_txt, d)."""
    pos = (torch.arange(tokens.shape[1], device=tokens.device)
           if cfg.pos == "learned" else None)  # only a table reads them
    x = embed_tokens(params, cfg, tokens, positions=pos)
    if cfg.family == "vlm" and patches is not None:
        img = qdense(patches.to(cfg.cdtype), params["vlm_proj"]["kernel"],
                     cfg.cdtype, impl, tag="vlm_proj")
        x = torch.cat([img, x], dim=1)
    return x


def _check_lm(cfg: ModelCfg, what: str) -> None:
    _check_cfg(cfg)
    if cfg.family not in ("decoder", "vlm"):
        raise ValueError(f"{what} needs a decoder or VLM config, got family "
                         f"{cfg.family!r}")


def forward_hidden(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                   impl: str = "auto",
                   patches: Optional[torch.Tensor] = None):
    """tokens (B, S) [, a VLM's patches (B, n_img, d)] -> (final-norm
    hidden states (B, n_img + S, d), aux) of the teacher-forced causal
    forward (training), as JAX's `forward_hidden`; RoPE positions run over
    the image rows and the text together:
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
    _check_lm(cfg, "forward_hidden")
    x = _decoder_embed(params, cfg, tokens, patches, impl)
    q_pos = torch.arange(x.shape[1], device=tokens.device)
    x, _, aux = _run_layers(params, cfg, x, q_pos=q_pos, causal=True,
                            impl=impl)
    return apply_norm(params["final_norm"], cfg, x), _zero_aux(aux, x.device)


def forward_lm(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
               impl: str = "auto",
               patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced full-sequence fp32 logits (B, S, V) (training); a
    VLM's patches put n_img rows ahead, (B, n_img + S, V)."""
    return lm_logits(params, cfg, forward_hidden(params, cfg, tokens, impl,
                                                 patches)[0], impl)


def prefill_lm(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
               cache_len: int, last_pos: Optional[int] = None,
               task_ids: Optional[torch.Tensor] = None,
               gates: Optional[torch.Tensor] = None, impl: str = "auto",
               patches: Optional[torch.Tensor] = None):
    """tokens (B, S) -> (logits (B, 1, V) at `last_pos` (default the last
    position), caches of length cache_len holding positions 0..S-1). A
    VLM's patches (B, n_img, d) go ahead of the text: the caches hold
    positions 0..n_img+S-1, last_pos indexes that sequence and decoding
    goes on at position n_img + S.
    A right-padded prompt passes its true last index as last_pos: under
    causal masking the pad never reaches positions <= last_pos; a config
    with recurrent state refuses one, since the state would take the pad
    in. Under MoE blocks the pad tokens still route and take capacity
    from the prompt's, as they do in JAX. gates:
    (L, bank rows) fp32 row gates of a hot-swap bank (`AdapterBank`), on
    the params' device; with them every block's bank adapter runs the
    masked multitask op with its layer's row."""
    _check_lm(cfg, "prefill_lm")
    x = _decoder_embed(params, cfg, tokens, patches, impl)
    S = x.shape[1]
    lp = S - 1 if last_pos is None else int(last_pos)
    if lp != S - 1 and has_recurrent_state(cfg):
        raise ValueError(
            f"last_pos {lp} of a {S}-token prompt: a layer's recurrent state "
            "would take in the tokens after it; prefill the prompt unpadded")
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
               impl, positions=None):
    """`_pool_step` over contiguous slot caches, each viewed as a pool of
    `decode_page(L)`-token pages with its own tables (`decode_tables`, one
    per cache length: a windowed layer's ring is shorter than a full-range
    layer's cache); the caches are written in place. A cross-attention
    layer's {"ck", "cv"} go along as `cross_view`'s pool, whose tables and
    kv_lens every such layer shares."""
    tables = None
    views = caches
    if has_attention(cfg):
        B, dev = tokens.shape[0], tokens.device
        by_len = {}
        tables = []
        for c in caches:
            L = c["k"].shape[1] if "k" in c else None
            if L is not None and L not in by_len:
                by_len[L] = decode_tables(B, L, dev)
            tables.append(by_len.get(L))
        cross = {}
        views = []
        for c in caches:
            if "k" not in c:
                views.append(c)
                continue
            view = pool_view(c)
            if "ck" in c:
                L = c["ck"].shape[1]
                if L not in cross:
                    cross[L] = (decode_tables(B, L, dev),
                                torch.full((B,), L, dtype=torch.int32,
                                           device=dev))
                view["cross"] = cross_view(c, *cross[L])
            views.append(view)
    return _pool_step(params, cfg, views, tokens, write_pos, tables,
                      task_ids, gates, impl, positions)


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
    `rec_cache_init` (no length) for an RWKV6 or an RG-LRU layer; a
    cross-attention layer adds "ck", "cv" of (batch, n_audio_frames, KH,
    D), as JAX's `group_cache_init` does."""
    _check_cfg(cfg)

    def kv(size, names):
        shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
        return {name: torch.zeros(shape, dtype=cfg.cdtype, device=device)
                for name in names}

    def one(slot):
        if slot.kind == "rwkv":
            return rwkv_cache_init(cfg, batch, device)
        c = (rec_cache_init(cfg, batch, device) if slot.kind == "rec"
             else kv(cache_size(slot, cache_len), ("k", "v")))
        if slot.cross_attn:
            c.update(kv(cfg.n_audio_frames, ("ck", "cv")))
        return c

    return [one(slot) for slot in cfg.layer_slots()]


# ---------------------------------------------------------------------------
# the encdec (whisper) family
# ---------------------------------------------------------------------------


def _check_encdec(cfg: ModelCfg, what: str) -> None:
    _check_cfg(cfg)
    if cfg.family != "encdec":
        raise ValueError(f"{what} needs an encdec config, got family "
                         f"{cfg.family!r}")


def encode_audio(params: dict, cfg: ModelCfg, frames: torch.Tensor,
                 impl: str = "auto") -> torch.Tensor:
    """frames (B, S_enc, d): precomputed conv-frontend embeddings (the
    front end is stubbed, as in JAX) -> the encoder's final-norm states
    (B, S_enc, d): learned positions added, then the encoder's pre-LN
    blocks, non-causal (#4 at S_enc keys, #3 at each seam)."""
    _check_encdec(cfg, "encode_audio")
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(cfg.cdtype) + \
        params["enc_pos_embed"]["table"][pos].to(cfg.cdtype)
    x, _, _ = _run_layers(params, cfg, x, q_pos=pos, causal=False,
                          encoder=True, impl=impl)
    return apply_norm(params["enc_final_norm"], cfg, x)


def forward_encdec(params: dict, cfg: ModelCfg, frames: torch.Tensor,
                   tokens: torch.Tensor, impl: str = "auto"):
    """Teacher-forced (fp32 logits (B, S, V), aux) of the decoder over
    tokens (B, S), cross-attending to `encode_audio(frames)`, as JAX's
    `forward_encdec`; learned positions 0..S-1."""
    enc = encode_audio(params, cfg, frames, impl)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed_tokens(params, cfg, tokens, positions=pos)
    x, _, aux = _run_layers(params, cfg, x, q_pos=pos, causal=True,
                            enc_out=enc, impl=impl)
    x = apply_norm(params["final_norm"], cfg, x)
    return lm_logits(params, cfg, x, impl), _zero_aux(aux, x.device)


def prefill_encdec(params: dict, cfg: ModelCfg, frames: torch.Tensor,
                   tokens: torch.Tensor, cache_len: int,
                   impl: str = "auto"):
    """-> (logits (B, 1, V) at the last token, caches): each decoder
    layer's self-attention K/V of length cache_len holding positions
    0..S-1, and the encoder's K/V "ck", "cv" (B, S_enc, KH, D) its cross
    sublayer made once from the encoder output."""
    enc = encode_audio(params, cfg, frames, impl)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed_tokens(params, cfg, tokens, positions=pos)
    x, caches, _ = _run_layers(params, cfg, x, q_pos=pos, causal=True,
                               cache_len=cache_len, enc_out=enc, impl=impl)
    x = apply_norm(params["final_norm"], cfg, x[:, -1:])
    return lm_logits(params, cfg, x, impl), caches


def decode_encdec(params: dict, cfg: ModelCfg, caches: List[dict],
                  token: torch.Tensor, pos, impl: str = "auto"):
    """One decode step of token (B, 1) at pos: a scalar shared by every
    row, or (B,) per-row positions. The learned position is added, as
    JAX's `decode_encdec` does; self-attention writes its K/V in place and
    attends through #5, the cross sublayer reads "ck", "cv" through #5
    without the K/V projections. Returns (fp32 logits (B, 1, V),
    caches)."""
    _check_encdec(cfg, "decode_encdec")
    B = token.shape[0]
    pos = torch.as_tensor(pos, device=token.device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    wp = _positions(pos, 1, token.device)
    x = _slot_step(params, cfg, caches, token, wp, None, None, impl,
                   positions=wp)
    x = apply_norm(params["final_norm"], cfg, x)
    return lm_logits(params, cfg, x, impl), caches


def init_encdec_caches(cfg: ModelCfg, batch: int, cache_len: int,
                       device) -> List[dict]:
    """Zeroed decoder caches with the encoder's K/V slots, as JAX's
    `init_encdec_caches`: `init_decode_caches` of an encdec config."""
    _check_encdec(cfg, "init_encdec_caches")
    return init_decode_caches(cfg, batch, cache_len, device)
