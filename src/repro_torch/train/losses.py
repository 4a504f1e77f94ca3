"""Loss functions (port of `repro.train.losses`): the decoder LM's
next-token cross-entropy (whole or in sequence chunks; a VLM's over its
text positions only), the encoder-decoder's and the encoder classifier's
loss."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.types import ModelCfg
from repro_torch.models import model as M


def cross_entropy(logits, labels, ignore_index: int = -100):
    """logits (..., V); labels (...) int. Mean over non-ignored, fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels != ignore_index).float()
    return ((lse - ll) * mask).sum() / mask.sum().clamp(min=1.0)


def chunked_cross_entropy(cfg: ModelCfg, params, h, labels, chunk: int,
                          impl: str = "auto"):
    """CE computed in sequence chunks so the O(S x V) logits never fully
    materialize: h (B, S, d) final-norm states, labels (B, S). S is padded
    to a multiple of the chunk with zero states and ignored labels. Each
    chunk runs under `torch.utils.checkpoint`, so the backward recomputes
    its logits (JAX: `jax.checkpoint` with `nothing_saveable`); the sums
    add up chunk by chunk in fp32, in JAX's order."""
    B, S, d = h.shape
    c = min(chunk, S)
    nc = (S + c - 1) // c
    pad = nc * c - S
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-100)

    def body(h_c, l_c):
        logits = M.lm_logits(params, cfg, h_c, impl).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, l_c.clamp(min=0).long()[..., None])[..., 0]
        mask = (l_c != -100).float()
        return ((lse - ll) * mask).sum(), mask.sum()

    nll = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        n_c, m_c = checkpoint(body, h[:, sl], labels[:, sl],
                              use_reentrant=False)
        nll, cnt = nll + n_c, cnt + m_c
    return nll / cnt.clamp(min=1.0)


def lm_loss(cfg: ModelCfg, params, batch, impl: str = "auto"):
    """(loss, metrics) of next-token prediction on one batch of tokens and
    labels (B, S); over cfg.ce_chunk-token chunks when it is set. A VLM's
    batch carries "patches" (B, n_img, d) too, and the loss reads the last
    S positions alone, the text's (`h[:, -S:]`), as JAX's does. The MoE
    blocks' load-balancing loss is added, as in JAX (0 for a dense
    decoder); metrics "ce" holds the sum, as JAX's does."""
    labels = batch["labels"]
    h, aux = M.forward_hidden(params, cfg, batch["tokens"], impl,
                              patches=batch.get("patches"))
    if cfg.family == "vlm":  # the loss covers the text positions alone
        h = h[:, -labels.shape[1]:]
    if cfg.ce_chunk:
        loss = chunked_cross_entropy(cfg, params, h, labels, cfg.ce_chunk,
                                     impl) + aux
    else:
        loss = cross_entropy(M.lm_logits(params, cfg, h, impl), labels) + aux
    return loss, {"ce": loss, "aux": aux}


def encdec_loss(cfg: ModelCfg, params, batch, impl: str = "auto"):
    """(loss, metrics) of the encoder-decoder on one batch: frames (B,
    S_enc, d), tokens and labels (B, S); the decoder's next-token
    cross-entropy plus the aux loss, as JAX's `encdec_loss`."""
    logits, aux = M.forward_encdec(params, cfg, batch["frames"],
                                   batch["tokens"], impl)
    loss = cross_entropy(logits, batch["labels"]) + aux
    return loss, {"ce": loss, "aux": aux}


def classification_loss(cfg: ModelCfg, params, batch, impl: str = "auto"):
    """(loss, metrics) of the encoder classifier on one batch; mean squared
    error on logit 0 for a regression config (stsb)."""
    logits, _, _ = M.forward_encoder(params, cfg, batch["tokens"],
                                     batch.get("type_ids"), impl=impl)
    labels = batch["labels"]
    if cfg.is_regression:
        pred = logits[..., 0].float()
        loss = (pred - labels.float()).square().mean()
        return loss, {"mse": loss, "pred": pred}
    loss = cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"ce": loss, "acc": acc}


def loss_for(cfg: ModelCfg):
    """The loss of the config's family, as JAX's `loss_for`: `lm_loss`
    for a decoder or a VLM, `encdec_loss` for an encoder-decoder,
    `classification_loss` for an encoder."""
    return {"decoder": lm_loss, "vlm": lm_loss, "encdec": encdec_loss,
            "encoder": classification_loss}[cfg.family]
