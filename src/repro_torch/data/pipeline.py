"""Host-side input pipeline (port of `repro.data.pipeline`): a rank's
share of each batch, copied to its device, and background prefetch.

`shard_batch` keeps the rank's slice of every leaf's leading dim over the
dp direction of the mesh (`dist.sharding.batch_spec`: the whole batch when
that dim does not divide), then copies it to the device from pinned host
memory without blocking the host. `Prefetcher` runs the batch iterator in
a thread with a bounded queue, so batch assembly overlaps the device's
work; the train launcher uses it with or without a mesh, as JAX's does.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import batch_spec, shard_leaf


def _host(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def shard_batch(batch: dict, mesh=None, device=None) -> dict:
    """Each leaf's dp slice (all of it without a mesh or when its leading
    dim does not divide), on `device` when given: a CPU leaf is pinned
    and copied with non_blocking=True to a card."""
    out = {}
    for k, v in batch.items():
        t = _host(v)
        if mesh is not None:
            t = shard_leaf(t, batch_spec(mesh, t.dim(), tuple(t.shape)),
                           mesh)
        if device is not None and torch.device(device).type == "cuda":
            if t.device.type == "cpu":
                t = t.contiguous().pin_memory()
            t = t.to(device, non_blocking=True)
        elif device is not None:
            t = t.to(device)
        out[k] = t
    return out


def shard_batches(batches: Iterator[dict], mesh=None,
                  device=None) -> Iterator[dict]:
    for b in batches:
        yield shard_batch(b, mesh, device)


class Prefetcher:
    """Runs an iterator in a daemon thread with a bounded queue; an error
    in the thread is raised in the consumer."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.err: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    self.q.put(item)
            except BaseException as e:  # surfaced in the consumer
                self.err = e
            finally:
                self.q.put(self._DONE)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._DONE:
            if self.err is not None:
                raise self.err
            raise StopIteration
        return item
