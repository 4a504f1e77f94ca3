"""Adapter lifecycle for multi-tenant serving (port of
`repro.serving.registry`): a disk registry of named, versioned adapter
deltas and a bounded device-resident hot-swap bank.

  * `AdapterRegistry`: a directory of `CheckpointManager`-backed task
    subdirectories. `publish(name, delta)` writes an atomic, versioned
    snapshot (`<dir>/<name>/step_*/delta.ckpt`); `load(name)` returns the
    newest complete version as CPU tensors. Deltas are stored in the JAX
    layout (`convert.stack_delta`), in the JAX package's file format, so
    the two packages' registries serve each other's tenants.

  * `AdapterBank`: `size` rows of per-layer adapter tensors ((size, d) per
    layer; one w row with `shared_w=True`) that the engine's model reads.
    `acquire(name)` resolves a name to a row: an LRU hit in place, or a
    miss that loads the delta from the registry and writes it into a free
    (or the coldest unpinned) row, in place. Rows of in-flight requests
    are pinned (`acquire`/`release` count), and eviction never takes a
    pinned row.

Pruned tenants (packed sparse deltas) are unpacked at insert into
identity-filled dense rows, as in JAX, and each resident row's layer mask
is kept beside it. The bank holds those masks on the device as one
(L, size) fp32 gate tensor (`gate_tensor`), written in place at every
load, eviction and invalidation and read by the masked multitask kernel
on every step; `gates()` gives the same values as a numpy array.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common import tree as tu
from repro_torch.core.hadamard import (ADAPTER_RE, SHARED_W_RE, adapter_row,
                                       init_bank, insert_bank_row,
                                       validate_adapter_row)
from repro_torch.sparse import importance as imp
from repro_torch.sparse import prune as sparse_prune

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class BankFullError(RuntimeError):
    """Every bank row is pinned by an in-flight request; the caller should
    retry once a request retires (the scheduler defers admission)."""


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValueError(
            f"bad adapter name {name!r}: must match {_NAME_RE.pattern} "
            "(it becomes a directory name)")
    return name


class AdapterRegistry:
    """Named, versioned adapter deltas on disk.

    Layout: `<directory>/<name>/step_<version>/delta.ckpt`, one
    `CheckpointManager` per adapter name: every write is atomic, versions
    are garbage-collected down to `keep`, and `load` resolves to the
    newest complete snapshot.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._mgrs: Dict[str, CheckpointManager] = {}
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def _mgr(self, name: str, create: bool = False) -> CheckpointManager:
        """Per-name manager. Read paths pass create=False and get KeyError
        for names with no directory, so a lookup never writes into the
        registry (or brings back a removed tenant's directory)."""
        path = os.path.join(self.dir, _check_name(name))
        with self._lock:
            m = self._mgrs.get(name)
            if m is None:
                if not create and not os.path.isdir(path):
                    raise KeyError(f"adapter {name!r} is not published "
                                   f"under {self.dir}")
                m = self._mgrs[name] = CheckpointManager(path, keep=self.keep)
            return m

    # -- publish/load --------------------------------------------------------

    def publish(self, name: str, delta: dict, *,
                version: Optional[int] = None,
                metadata: Optional[dict] = None) -> int:
        """Write one adapter version; returns the version written. Omitted
        `version` auto-increments past the newest on disk. The delta is in
        the JAX layout (a per-layer delta is refused: publish
        `convert.stack_delta(delta, cfg)`) and holds at least one Hadamard
        adapter leaf."""
        paths = [p for p, _ in tu.flatten_with_paths(delta)]
        if any(p.startswith("layers/") for p in paths):
            raise ValueError(
                f"delta for {name!r} is in the port's per-layer layout; "
                "publish convert.stack_delta(delta, cfg), the layout the "
                "registry stores")
        if not any(ADAPTER_RE.search("/" + p) for p in paths):
            raise ValueError(
                f"delta for {name!r} has no /adapter/ leaves - not a "
                "Hadamard task delta")
        mgr = self._mgr(name, create=True)
        if version is None:
            newest = mgr.latest(filename="delta.ckpt")
            version = 0 if newest is None else newest + 1
        mgr.save_delta(version, delta, metadata=dict(metadata or {},
                                                     name=name))
        return version

    def load(self, name: str,
             version: Optional[int] = None) -> Tuple[dict, dict]:
        """(delta, metadata) of the newest (or given) version. Raises
        KeyError for names with no complete version on disk."""
        tree, meta = self._mgr(name).restore(version, filename="delta.ckpt")
        if tree is None:
            raise KeyError(f"adapter {name!r} has no published version "
                           f"under {self.dir}")
        return tree, meta

    # -- introspection/lifecycle --------------------------------------------

    def names(self) -> List[str]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not os.path.isdir(os.path.join(self.dir, name)) \
                    or not _NAME_RE.match(name):  # skip foreign dirs
                continue
            if self._mgr(name).latest(filename="delta.ckpt") is not None:
                out.append(name)
        return out

    def versions(self, name: str) -> List[int]:
        try:
            return self._mgr(name).steps(filename="delta.ckpt")
        except KeyError:
            return []

    def __contains__(self, name: str) -> bool:
        try:
            return self._mgr(name).latest(filename="delta.ckpt") is not None
        except (KeyError, ValueError):  # unpublished / unpublishable name
            return False

    def remove(self, name: str) -> None:
        """Delete every version of `name`. A bank keeps its loaded copy
        until invalidated: removal only stops future loads."""
        with self._lock:
            self._mgrs.pop(name, None)
        shutil.rmtree(os.path.join(self.dir, _check_name(name)),
                      ignore_errors=True)


class AdapterBank:
    """Bounded device-resident adapter rows with name -> row resolution,
    LRU eviction and pin counts.

    The bank tree is a full per-layer param tree whose adapter leaves are
    (size, d) rows ((1, d) for w with `shared_w`); `MultiTaskEngine`
    serves it like a static `build_bank` tree and adopts it with
    `attach`, after which every row write lands in the tensors the model
    reads. hits, loads, evictions and pin_stalls count acquires that found
    their row, loaded one from the registry, displaced a row, and were
    refused with every row pinned.
    """

    def __init__(self, cfg, base_params: dict, size: int,
                 registry: AdapterRegistry, *, shared_w: bool = False,
                 shared_w_atol: float = 0.1):
        if size < 1:
            raise ValueError("bank size must be >= 1")
        self.cfg = cfg
        self.size = size
        self.registry = registry
        self.shared_w = shared_w
        self.shared_w_atol = shared_w_atol
        self._skip = SHARED_W_RE if shared_w else None
        self._rows: "OrderedDict[str, int]" = OrderedDict()  # LRU: name->row
        self._pins: Dict[str, int] = {}
        self._masks: Dict[str, np.ndarray] = {}  # name -> (L,) layer mask
        self._free: List[int] = list(range(size))
        self.hits = self.loads = self.evictions = self.pin_stalls = 0
        # identity rows until tasks are loaded; with shared_w, base_params'
        # w IS every tenant's w (`sparse.shared_w_overlay`), stored once
        self.attach(init_bank(base_params, size, shared_w=shared_w))

    # -- engine plumbing -----------------------------------------------------

    def attach(self, placed_tree: dict) -> None:
        """Adopt the engine's placement of the bank tree (the same
        structure, its tensors on the engine's device): row writes go into
        its adapter tensors from now on, and the gates move to their
        device. Rows already loaded keep their gates."""
        mask = tu.mask_from_patterns(placed_tree, (ADAPTER_RE.pattern,),
                                     path_of=lambda p: "/" + p)
        self._adapters, _ = tu.partition(placed_tree, mask)
        self._tree = placed_tree
        device = next(t.device for _, t in tu.flatten_with_paths(
            self._adapters) if t is not None)
        self._gates = torch.zeros((imp.n_layers(self.cfg), self.size),
                                  dtype=torch.float32, device=device)
        for name, row in self._rows.items():
            self._set_gate(row, self._masks[name])
        # the shapes a row must have, in the JAX layout a delta arrives in
        self._row_shapes = convert.stack_delta(tu.map_with_path(
            lambda _, t: None if t is None else t.to("meta"), self._adapters),
            self.cfg)

    @property
    def tree(self) -> dict:
        """The live bank tree: the backbone with the adapter rows."""
        return self._tree

    @property
    def gate_tensor(self) -> torch.Tensor:
        """(L, size) fp32 row gates on the bank's device: column r is row
        r's layer mask, 0 for an unloaded row. Updated in place."""
        return self._gates

    def _set_gate(self, row: int, mask: Optional[np.ndarray]) -> None:
        col = torch.zeros((self._gates.shape[0],), dtype=torch.float32) \
            if mask is None else torch.as_tensor(mask, dtype=torch.float32)
        self._gates[:, row].copy_(col)

    # -- resolution ----------------------------------------------------------

    def row_of(self, name: str) -> Optional[int]:
        """Resident row of `name`, or None (no load, no LRU bump)."""
        return self._rows.get(name)

    def acquire(self, name: str) -> int:
        """Resolve `name` to a resident row and pin it. Hit: LRU bump.
        Miss: load from the registry, evict the coldest unpinned row if no
        row is free, write the delta into the row. Raises KeyError for
        unpublished names and BankFullError when every row is pinned."""
        row = self._rows.get(name)
        if row is not None:
            self._rows.move_to_end(name)
            self._pins[name] = self._pins.get(name, 0) + 1
            self.hits += 1
            return row

        if not self._free and all(self._pins.get(n, 0) > 0
                                  for n in self._rows):
            # checked before the disk load: a fully pinned bank is the
            # scheduler's backpressure signal, not an I/O error
            self.pin_stalls += 1
            raise BankFullError(
                f"all {self.size} bank rows are pinned; cannot admit "
                f"adapter {name!r}")

        delta, _meta = self.registry.load(name)
        # packed sparse deltas unpack to identity-filled dense rows; the
        # check runs on the JAX layout before the rows are split per layer,
        # so a wrong-architecture delta fails here, naming every mismatch
        row_tree = sparse_prune.unpack_delta(adapter_row(delta))
        validate_adapter_row(self._row_shapes, row_tree,
                             shared_w=self.shared_w)
        row_tree = convert.unstack_delta(row_tree, self.cfg)
        if self.shared_w:
            self._check_shared_w(name, row_tree)
        mask = sparse_prune.delta_mask(delta, self.cfg)

        if self._free:
            idx = self._free.pop(0)
        else:
            victim = next(n for n in self._rows if not self._pins.get(n, 0))
            idx = self._rows.pop(victim)
            self._pins.pop(victim, None)
            self._masks.pop(victim, None)
            self.evictions += 1

        insert_bank_row(self._adapters, row_tree, idx, skip=self._skip)
        self._set_gate(idx, mask)
        self.loads += 1
        self._rows[name] = idx
        self._pins[name] = 1
        self._masks[name] = mask
        return idx

    def _check_shared_w(self, name: str, row_tree: dict) -> None:
        """A shared-w bank never writes a tenant's w (insert skips it), so
        a tenant whose published w deviates from the bank's shared row
        would silently decode under the wrong transform: refuse it."""
        bank_w = dict(tu.flatten_with_paths(self._adapters))
        worst, worst_path = 0.0, None
        for path, r in tu.flatten_with_paths(row_tree):
            if r is None or not SHARED_W_RE.search(path):
                continue
            shared_row = bank_w[path][0].float().cpu()
            dev = float((r.float() - shared_row).abs().max())
            if dev > worst:
                worst, worst_path = dev, path
        if worst > self.shared_w_atol:
            raise ValueError(
                f"adapter {name!r}: published w deviates from the bank's "
                f"shared w by {worst:.4f} (> atol {self.shared_w_atol}) at "
                f"{worst_path}; a shared-w bank would silently serve the "
                "shared row instead - publish a b-only delta or serve this "
                "tenant from a dense bank")

    def release(self, name: str) -> None:
        """Drop one pin; the row stays resident (warm) until evicted."""
        c = self._pins.get(name, 0)
        if c > 0:
            self._pins[name] = c - 1

    def lookup(self, name: str) -> int:
        """Resolve without holding a pin."""
        row = self.acquire(name)
        self.release(name)
        return row

    def invalidate(self, name: str) -> bool:
        """Forget a resident row so the next acquire reloads it from the
        registry (picking up a newly published version) and gate the row
        off. Returns False if the row is pinned by an in-flight request or
        not resident."""
        if self._pins.get(name, 0) > 0:
            return False
        row = self._rows.pop(name, None)
        if row is None:
            return False
        self._pins.pop(name, None)
        self._masks.pop(name, None)
        self._set_gate(row, None)
        self._free.append(row)
        return True

    # -- introspection -------------------------------------------------------

    @property
    def resident(self) -> List[str]:
        return list(self._rows)

    def pins(self, name: str) -> int:
        return self._pins.get(name, 0)

    def mask_of(self, name: str) -> Optional[np.ndarray]:
        """(L,) active-layer mask of a resident row (all-ones for dense
        tenants), or None if the name is not resident."""
        m = self._masks.get(name)
        return None if m is None else m.copy()

    def gates(self) -> np.ndarray:
        """(L, size) fp32 row gates in bank-row order, from the host-side
        masks: column r is row r's layer mask; unloaded rows hold identity
        adapters and gate 0. `gate_tensor` holds the same on the device."""
        gates = np.zeros((imp.n_layers(self.cfg), self.size), np.float32)
        for name, r in self._rows.items():
            gates[:, r] = self._masks[name].astype(np.float32)
        return gates

    def adapter_bytes(self) -> int:
        """Device bytes of the bank's adapter rows (the number shared-w
        mode shrinks: one w row per layer instead of `size`)."""
        return tu.tree_bytes(self._adapters)

    def stats(self) -> dict:
        return {
            "size": self.size,
            "resident": len(self._rows),
            "loads": self.loads,
            "evictions": self.evictions,
            "hits": self.hits,
            "pin_stalls": self.pin_stalls,
            "shared_w": self.shared_w,
            "adapter_bytes": self.adapter_bytes(),
        }
