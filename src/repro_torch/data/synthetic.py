"""Seeded synthetic GLUE-like task suite (the port's own copy of
`repro.data.synthetic`: the same arrays, byte for byte, from the same
seeds; numpy only).

GLUE itself is not available offline; this reproduces its *taxonomy* so the
paper's mechanism claims stay testable:

  single-sentence: cola (MCC), sst2 (acc)
  pair:            mrpc (acc), qqp (acc), qnli (acc), rte (acc),
                   mnli (acc, 3-class), stsb (Pearson, regression)

Labels are functions of token content so models can genuinely learn them:
  * single-sentence tasks plant class-indicator tokens,
  * pair tasks derive the label from segment overlap (paraphrase = shuffled
    copy vs. random second segment; mnli adds a half-overlap neutral class;
    stsb's score is the Jaccard overlap scaled to [0, 5]).

The LM corpus (`lm_corpus`, `lm_batches`) is a seeded order-2 Markov
stream over a sparse candidate table, for decoder-LM fine-tuning: a model
can learn it, so the loss falls.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

CLS, SEP, PAD = 1, 2, 0
FIRST_CONTENT_TOKEN = 10


@dataclass(frozen=True)
class TaskSpec:
    name: str
    n_classes: int  # 1 => regression
    pair: bool
    metric: str


TASKS: Dict[str, TaskSpec] = {
    "cola": TaskSpec("cola", 2, False, "mcc"),
    "sst2": TaskSpec("sst2", 2, False, "acc"),
    "mrpc": TaskSpec("mrpc", 2, True, "acc"),
    "stsb": TaskSpec("stsb", 1, True, "pearson"),
    "qqp": TaskSpec("qqp", 2, True, "acc"),
    "mnli": TaskSpec("mnli", 3, True, "acc"),
    "qnli": TaskSpec("qnli", 2, True, "acc"),
    "rte": TaskSpec("rte", 2, True, "acc"),
}


class TaskData:
    """Deterministic generator + batch iterators for one task."""

    def __init__(self, task: str, vocab_size: int, seq_len: int = 128,
                 n_train: int = 2048, n_eval: int = 512, seed: int = 0):
        self.spec = TASKS[task]
        self.vocab = vocab_size
        self.seq_len = seq_len
        # crc32, not hash(): str hashing is salted per process, and a
        # task's data must be byte-identical across processes (benches
        # compare quality numbers between runs; trainer/server pairs
        # regenerate the same eval sets)
        rng = np.random.default_rng(
            zlib.crc32(f"{task}:{seed}".encode()) % (2**31))
        if self.spec.pair:
            make = self._make_pair
        else:
            self._indicators = rng.choice(
                np.arange(FIRST_CONTENT_TOKEN, vocab_size),
                size=(max(self.spec.n_classes, 2), 8), replace=False)
            make = self._make_single
        self.train = make(rng, n_train)
        self.eval = make(rng, n_eval)

    # -- single-sentence: class-indicator tokens --------------------------
    def _make_single(self, rng, n):
        S = self.seq_len
        toks = rng.integers(FIRST_CONTENT_TOKEN, self.vocab, size=(n, S))
        labels = rng.integers(0, self.spec.n_classes, size=n)
        for i in range(n):
            cnt = rng.integers(4, 9)
            pos = rng.choice(np.arange(1, S), size=cnt, replace=False)
            toks[i, pos] = rng.choice(self._indicators[labels[i]], size=cnt)
        toks[:, 0] = CLS
        return {"tokens": toks.astype(np.int32),
                "type_ids": np.zeros((n, S), np.int32),
                "labels": labels.astype(np.int32)}

    # -- pair tasks: overlap-derived labels --------------------------------
    def _make_pair(self, rng, n):
        S = self.seq_len
        half = (S - 3) // 2
        toks = np.zeros((n, S), np.int64)
        types = np.zeros((n, S), np.int32)
        if self.spec.n_classes == 1:
            labels = np.zeros(n, np.float32)
        else:
            labels = rng.integers(0, self.spec.n_classes, size=n)

        for i in range(n):
            a = rng.integers(FIRST_CONTENT_TOKEN, self.vocab, size=half)
            if self.spec.n_classes == 1:  # stsb: graded overlap
                k = rng.integers(0, half + 1)
                b = a.copy()
                b[:half - k] = rng.integers(FIRST_CONTENT_TOKEN, self.vocab,
                                            size=half - k)
                rng.shuffle(b)
                overlap = len(np.intersect1d(a, b)) / half
                labels[i] = 5.0 * overlap
            else:
                lab = labels[i]
                if lab == 1:  # paraphrase/entailment: shuffled copy
                    b = rng.permutation(a)
                elif lab == 0:  # unrelated
                    b = rng.integers(FIRST_CONTENT_TOKEN, self.vocab, size=half)
                else:  # mnli neutral: half overlap
                    b = np.concatenate([
                        rng.permutation(a)[: half // 2],
                        rng.integers(FIRST_CONTENT_TOKEN, self.vocab,
                                     size=half - half // 2)])
                    rng.shuffle(b)
            row = np.concatenate([[CLS], a, [SEP], b, [SEP]])
            toks[i, : len(row)] = row
            types[i, half + 2 : len(row)] = 1
        return {"tokens": toks.astype(np.int32), "type_ids": types,
                "labels": labels}

    # -- iterators ----------------------------------------------------------
    def train_batches(self, steps: int, batch_size: int, seed: int = 0
                      ) -> Iterator[dict]:
        rng = np.random.default_rng(seed)
        n = len(self.train["labels"])
        for _ in range(steps):
            idx = rng.integers(0, n, size=batch_size)
            yield {k: v[idx] for k, v in self.train.items()}

    def eval_batches(self, batch_size: int) -> Iterator[dict]:
        n = len(self.eval["labels"])
        for s in range(0, n - batch_size + 1, batch_size):
            yield {k: v[s : s + batch_size] for k, v in self.eval.items()}


def lm_corpus(vocab_size: int, n_tokens: int, seed: int = 0,
              order: int = 2) -> np.ndarray:
    """Synthetic LM corpus with learnable Markov structure."""
    rng = np.random.default_rng(seed)
    # sparse transition table: each context maps to a small candidate set
    n_ctx = 4096
    cands = rng.integers(FIRST_CONTENT_TOKEN, vocab_size, size=(n_ctx, 4))
    toks = np.empty(n_tokens, np.int32)
    toks[:order] = rng.integers(FIRST_CONTENT_TOKEN, vocab_size, size=order)
    h = 0
    for i in range(order, n_tokens):
        h = (h * 1000003 + int(toks[i - 1])) % n_ctx
        if rng.random() < 0.1:  # noise
            toks[i] = rng.integers(FIRST_CONTENT_TOKEN, vocab_size)
        else:
            toks[i] = cands[h, rng.integers(0, 4)]
    return toks


def lm_batches(corpus: np.ndarray, steps: int, batch_size: int, seq_len: int,
               seed: int = 0) -> Iterator[dict]:
    """`steps` batches of `batch_size` windows of the corpus at random
    starts: tokens (B, S) and labels, the same windows one token on."""
    rng = np.random.default_rng(seed)
    max_start = len(corpus) - seq_len - 1
    for _ in range(steps):
        starts = rng.integers(0, max_start, size=batch_size)
        toks = np.stack([corpus[s : s + seq_len] for s in starts])
        labs = np.stack([corpus[s + 1 : s + seq_len + 1] for s in starts])
        yield {"tokens": toks.astype(np.int32), "labels": labs.astype(np.int32)}
