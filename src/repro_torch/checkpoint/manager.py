"""Checkpoint manager (port of `repro.checkpoint.manager`): step-indexed
atomic snapshots with keep-k GC, optional async writes, resume discovery,
and KB-sized PEFT delta snapshots.

  * a snapshot is visible only after its atomic rename (no torn reads),
  * `latest()` always resolves to the newest complete snapshot,
  * restore returns host tensors, to be placed on any device.

Delta snapshots store only the trainable leaves (adapter, norm, head); an
adapter registry writes nothing else.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Optional

from repro_torch.checkpoint.store import load_tree, save_tree

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._lock = threading.Lock()
        self._pending: list = []
        os.makedirs(directory, exist_ok=True)

    # -- paths --------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _list_steps(self, filename: Optional[str]):
        """Complete snapshots on disk right now (no flush - safe to call
        from the async writer itself). filename=None matches a step dir
        holding any *.ckpt file (GC must see delta-only snapshots too)."""
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if not m:
                continue
            d = os.path.join(self.dir, name)
            if filename is None:
                ok = os.path.isdir(d) and any(
                    f.endswith(".ckpt") for f in os.listdir(d))
            else:
                ok = os.path.exists(os.path.join(d, filename))
            if ok:
                out.append(int(m.group(1)))
        return sorted(out)

    def steps(self, filename: str = "state.ckpt"):
        """Steps with a complete `filename` snapshot. Flushes pending async
        writes first: discovery-after-async-save must never miss (or race
        the rename of) an in-flight snapshot."""
        self.wait()
        return self._list_steps(filename)

    def latest(self, filename: str = "state.ckpt") -> Optional[int]:
        s = self.steps(filename)
        return s[-1] if s else None

    # -- save ---------------------------------------------------------------
    def _write(self, step: int, tree, metadata, filename: str):
        d = self._step_dir(step)
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        save_tree(os.path.join(tmp, filename), tree, metadata=metadata)
        with self._lock:
            if os.path.exists(d):  # merge into an existing snapshot dir
                shutil.move(os.path.join(tmp, filename), os.path.join(d, filename))
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                os.replace(tmp, d)
        self._gc()

    def save(self, step: int, state, metadata: Optional[dict] = None,
             filename: str = "state.ckpt"):
        meta = dict(metadata or {}, step=step)
        if self.async_write:
            t = threading.Thread(
                target=self._write, args=(step, state, meta, filename))
            with self._lock:
                self._pending.append(t)
            t.start()
        else:
            self._write(step, state, meta, filename)

    def save_delta(self, step: int, delta, metadata: Optional[dict] = None):
        """KB-sized task/adapter snapshot alongside (or instead of) full state."""
        self.save(step, delta, metadata, filename="delta.ckpt")

    def wait(self):
        cur = threading.current_thread()
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            if t is not cur:  # a writer must never try to join itself
                t.join()

    # -- restore ------------------------------------------------------------
    def restore(self, step: Optional[int] = None, filename: str = "state.ckpt"):
        """Load a snapshot (latest complete one by default). Always flushes
        pending async writes first so restore(step) cannot read a snapshot
        mid-write or miss one whose rename has not landed yet."""
        self.wait()
        step = step if step is not None else self.latest(filename)
        if step is None:
            return None, None
        path = os.path.join(self._step_dir(step), filename)
        return load_tree(path)

    # -- GC -----------------------------------------------------------------
    def _gc(self):
        # runs inside the async writer thread: must NOT wait() (it would
        # join itself) and must see every snapshot flavour, including
        # delta-only step dirs (adapter registries never write state.ckpt)
        steps = self._list_steps(None)
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
