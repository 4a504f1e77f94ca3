"""Synthetic MLM pretraining of the encoder backbones (port of
`repro.train.pretrain`).

The paper fine-tunes *pretrained* PLMs; offline a brief masked-LM
pretraining on the structured synthetic corpus (Markov transitions,
`data.synthetic.lm_corpus`) stands in for one. It is what makes the
classifier-only probe (paper stage 1) non-degenerate. The pretrained
parameters are cached on disk, so that every table reuses one backbone, as
one BERT checkpoint serves every GLUE task.

The cache is the port's own: `checkpoint.store` files under
`results/pretrained_torch` by default, each layer's leaves stacked as in
the JAX layout (`convert.stack_delta`), so the port never reads a file the
JAX package wrote, nor the JAX package one of the port's.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import load_tree, restore_into, save_tree
from repro_torch.common.device import resolve_device
from repro_torch.common.types import ModelCfg, OptimCfg
from repro_torch.core import peft
from repro_torch.data.synthetic import lm_corpus
from repro_torch.models import model as M
from repro_torch.models.model import encode_sequence
from repro_torch.train.loop import run_train
from repro_torch.train.losses import cross_entropy
from repro_torch.train.steps import build_train_step, make_state, merged_params

MASK_ID = 3

__all__ = ["MASK_ID", "encode_sequence", "mlm_batches", "mlm_loss",
           "pretrain_encoder", "pretrain_tag"]


def mlm_loss(cfg: ModelCfg, params, batch, impl: str = "auto"):
    """(loss, metrics) of masked-token prediction: the tied head h @
    tableᵀ in the compute dtype, then fp32; the CE over the masked
    positions only (the others are labelled -100)."""
    h = encode_sequence(params, cfg, batch["tokens"], batch.get("type_ids"),
                        impl)
    logits = (h @ params["embed"]["table"].to(cfg.cdtype).T).float()
    labels = torch.where(batch["mask"].bool(), batch["targets"], -100)
    loss = cross_entropy(logits, labels)
    return loss, {"mlm_ce": loss}


def mlm_batches(corpus: np.ndarray, steps: int, batch: int, seq: int,
                mask_rate: float = 0.15, seed: int = 0) -> Iterator[dict]:
    """`steps` batches of `batch` corpus windows of `seq` tokens, a
    `mask_rate` share of them replaced by MASK_ID; JAX's numpy stream."""
    rng = np.random.default_rng(seed)
    max_start = len(corpus) - seq - 1
    for _ in range(steps):
        starts = rng.integers(0, max_start, size=batch)
        toks = np.stack([corpus[s: s + seq] for s in starts]).astype(np.int32)
        mask = rng.random((batch, seq)) < mask_rate
        masked = np.where(mask, MASK_ID, toks).astype(np.int32)
        yield {"tokens": masked, "targets": toks, "mask": mask,
               "type_ids": np.zeros_like(toks)}


def pretrain_tag(cfg: ModelCfg, *, steps: int, batch: int, seq: int,
                 lr: float, mask_rate: float, seed: int,
                 optim: Optional[OptimCfg] = None) -> str:
    """The cache key of a pretrained backbone, JAX's string: every knob
    that changes the trained weights appears in it."""
    tag = (f"{cfg.name}_s{steps}_b{batch}_q{seq}"
           f"_lr{lr:g}_mr{mask_rate:g}_seed{seed}")
    if optim is not None and (optim.m_dtype, optim.v_dtype) != \
            ("float32", "float32"):
        tag += f"_m{optim.m_dtype}_v{optim.v_dtype}"
    return tag


def pretrain_encoder(cfg: ModelCfg, *, steps: int = 600, batch: int = 32,
                     seq: int = 64, lr: float = 1e-3,
                     mask_rate: float = 0.15, seed: int = 0,
                     cache_dir: str = "results/pretrained_torch",
                     optim: Optional[OptimCfg] = None, log=print,
                     device=None):
    """MLM-pretrained parameters of `cfg` (every leaf trained, `full`),
    made from `seed` on `device` (cuda unless the caller names one), or
    read from the cache when a run with the same `pretrain_tag` wrote
    one. `optim` replaces the default schedule (its lr wins over `lr`)."""
    device = resolve_device(device)
    os.makedirs(cache_dir, exist_ok=True)
    ocfg = optim if optim is not None else OptimCfg(
        lr=lr, total_steps=steps, warmup_steps=max(steps // 20, 5))
    tag = pretrain_tag(cfg, steps=steps, batch=batch, seq=seq, lr=ocfg.lr,
                       mask_rate=mask_rate, seed=seed, optim=ocfg)
    path = os.path.join(cache_dir, tag + ".ckpt")

    def gen():
        return torch.Generator(device=device).manual_seed(seed)

    if os.path.exists(path):
        tree, _ = load_tree(path)
        return restore_into(M.init_params(gen(), cfg),
                            convert.unstack_delta(tree, cfg))

    state = make_state(gen(), cfg, peft.strategy("full"), ocfg)
    step = build_train_step(cfg, ocfg, loss_fn=mlm_loss)
    corpus = lm_corpus(cfg.vocab_size, 300_000, seed=seed)
    state, hist = run_train(state, step,
                            mlm_batches(corpus, steps, batch, seq,
                                        mask_rate=mask_rate, seed=seed),
                            steps=steps, log_every=0, log=log)
    log(f"[pretrain] {cfg.name}: mlm ce {hist[0]['loss']:.3f} -> "
        f"{hist[-1]['loss']:.3f}")
    params = merged_params(state)
    with torch.no_grad():
        save_tree(path, convert.stack_delta(params, cfg),
                  metadata={"steps": steps})
    return params
