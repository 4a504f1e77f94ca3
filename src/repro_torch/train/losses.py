"""Loss functions (port of `repro.train.losses`, the encoder classifier
subset; the LM losses arrive with decoder-LM fine-tuning)."""
from __future__ import annotations

import torch

from repro_torch.common.types import ModelCfg
from repro_torch.models import model as M


def cross_entropy(logits, labels, ignore_index: int = -100):
    """logits (..., V); labels (...) int. Mean over non-ignored, fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels != ignore_index).float()
    return ((lse - ll) * mask).sum() / mask.sum().clamp(min=1.0)


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
    if cfg.family != "encoder":
        raise NotImplementedError(
            f"no {cfg.family} loss yet: the port trains encoder classifiers; "
            "decoder-LM fine-tuning is the next training slice")
    return classification_loss
