"""Host-side evaluation metrics matching the paper's GLUE protocol:
Matthews correlation (CoLA), Pearson correlation (STS-B), accuracy (rest).
Port of `repro.train.metrics` (numpy only).
"""
from __future__ import annotations

import numpy as np


def accuracy(preds, labels) -> float:
    preds, labels = np.asarray(preds), np.asarray(labels)
    return float((preds == labels).mean())


def matthews_corrcoef(preds, labels) -> float:
    """Binary MCC (phi coefficient)."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    tp = float(((preds == 1) & (labels == 1)).sum())
    tn = float(((preds == 0) & (labels == 0)).sum())
    fp = float(((preds == 1) & (labels == 0)).sum())
    fn = float(((preds == 0) & (labels == 1)).sum())
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    if denom == 0:
        return 0.0
    return float((tp * tn - fp * fn) / denom)


def pearson(preds, labels) -> float:
    preds, labels = np.asarray(preds, np.float64), np.asarray(labels, np.float64)
    if preds.std() == 0 or labels.std() == 0:
        return 0.0
    return float(np.corrcoef(preds, labels)[0, 1])


def metric_fn(name: str):
    return {"acc": accuracy, "mcc": matthews_corrcoef, "pearson": pearson}[name]
