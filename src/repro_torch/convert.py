"""Carry a JAX parameter tree across to the port, and back.

`from_jax_params` takes the JAX package's parameter tree with its leaves
already converted to numpy by the caller, so this module needs no JAX. JAX
groups stack their layers' parameters on a leading `repeats` dim
(`repro.models.program`); the port keeps one dict per layer, so each
stacked leaf is unstacked in execution order: group by group, repeat by
repeat, slot by slot. Every leaf is named by its path; a leaf the port does
not know (or that the config's family does not have) raises. A multi-task
bank (adapter leaves (repeats, T, d)) carries over as (T, d) rows per
layer. `jax_path` names a port leaf by its JAX path, so that one regex
(a PEFT mask) means the same leaves in both packages.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.common import tree as tu
from repro_torch.common.types import ModelCfg

_NORMS = ("attn_norm", "ffn_norm", "post_attn_norm", "post_ffn_norm")
BLOCK_LEAVES = frozenset(
    [f"{n}/{leaf}" for n in _NORMS for leaf in ("scale", "bias")]
    + [f"attn/{w}" for w in ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo",
                             "q_norm", "k_norm")]
    + [f"mlp/{w}" for w in ("wi", "wo", "wg", "bi", "bo")]
    + ["adapter/w", "adapter/b"])
TOP_LEAVES = frozenset(["embed/table", "final_norm/scale", "final_norm/bias",
                        "lm_head/kernel"])
ENCODER_LEAVES = frozenset(["pos_embed/table", "type_embed/table",
                            "embed_norm/scale", "embed_norm/bias",
                            "pooler/kernel", "pooler/bias",
                            "classifier/kernel", "classifier/bias"])
_BLOCK_RE = re.compile(r"^blocks/g(\d+)/slot(\d+)/(.+)$")
_LAYER_RE = re.compile(r"^layers/(\d+)/(.+)$")


def top_leaves(cfg: ModelCfg) -> frozenset:
    """The non-block leaves a config of this family may hold."""
    return TOP_LEAVES | ENCODER_LEAVES if cfg.family == "encoder" \
        else TOP_LEAVES


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, including bfloat16 arrays (numpy's ml_dtypes
    bfloat16 is read through its 16-bit pattern)."""
    a = np.array(a)  # a writable copy that the tensor owns
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _layer_index(cfg: ModelCfg) -> Dict[Tuple[int, int, int], int]:
    """(group, repeat, slot) -> position in the port's layer list."""
    out, n = {}, 0
    for gi, g in enumerate(cfg.groups):
        for r in range(g.repeats):
            for si in range(len(g.slots)):
                out[(gi, r, si)] = n
                n += 1
    return out


def _set(tree: dict, path: str, value) -> None:
    *heads, last = path.split("/")
    for h in heads:
        tree = tree.setdefault(h, {})
    tree[last] = value


def jax_path(path: str, cfg: ModelCfg) -> str:
    """The JAX path of the port leaf `path`: 'layers/3/adapter/w' ->
    'blocks/g0/slot0/adapter/w' (every layer of a group shares its group's
    stacked leaf); a top-level path is the same in both."""
    m = _LAYER_RE.match(path)
    if m is None:
        return path
    gi, _, si = _layer_position(cfg)[int(m.group(1))]
    return f"blocks/g{gi}/slot{si}/{m.group(2)}"


def jax_ndim(path: str, leaf: torch.Tensor) -> int:
    """The rank of the port leaf `path` in the JAX layout: a layer's leaf
    is one slice of its group's stacked leaf, one rank more."""
    return leaf.dim() + (1 if _LAYER_RE.match(path) else 0)


def _layer_position(cfg: ModelCfg) -> List[Tuple[int, int, int]]:
    """Position in the port's layer list -> (group, repeat, slot)."""
    index = _layer_index(cfg)
    return sorted(index, key=index.get)


def from_jax_params(np_tree: dict, cfg: ModelCfg, device) -> dict:
    """The port's parameters from a JAX decoder or encoder parameter tree
    whose leaves are numpy arrays. Raises on any leaf it does not map."""
    if cfg.enc_groups:
        raise NotImplementedError("encdec encoder stacks (enc_groups) are "
                                  "not ported yet")
    index = _layer_index(cfg)
    layers: List[dict] = [{} for _ in range(len(index))]
    out: dict = {}
    for path, leaf in tu.flatten_with_paths(np_tree):
        m = _BLOCK_RE.match(path)
        if m is None:
            if path not in top_leaves(cfg):
                raise KeyError(f"unknown JAX parameter leaf {path!r}")
            _set(out, path, to_tensor(leaf, device))
            continue
        gi, si, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        if rest not in BLOCK_LEAVES:
            raise KeyError(f"unknown JAX block parameter leaf {path!r}")
        if gi >= len(cfg.groups) or si >= len(cfg.groups[gi].slots):
            raise KeyError(f"JAX leaf {path!r} has no slot in {cfg.name}")
        arr = np.asarray(leaf)
        if arr.shape[0] != cfg.groups[gi].repeats:
            raise ValueError(f"{path}: leading dim {arr.shape[0]} != group "
                             f"repeats {cfg.groups[gi].repeats}")
        for r in range(arr.shape[0]):
            _set(layers[index[(gi, r, si)]], rest, to_tensor(arr[r], device))
    out["layers"] = layers
    return out


def to_jax_params(params: dict, cfg: ModelCfg) -> dict:
    """The inverse of `from_jax_params`: a JAX-layout tree of numpy arrays
    with each group's layers stacked again (bf16 leaves come back as fp32,
    numpy having no bfloat16 of its own)."""
    def np_of(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out: dict = {}
    for path, leaf in tu.flatten_with_paths(params):
        if not path.startswith("layers/"):
            _set(out, path, np_of(leaf))
    index = _layer_index(cfg)
    per_leaf: Dict[str, Dict[int, np.ndarray]] = {}
    for (gi, r, si), li in index.items():
        for rest, leaf in tu.flatten_with_paths(params["layers"][li]):
            per_leaf.setdefault(f"blocks/g{gi}/slot{si}/{rest}", {})[r] = \
                np_of(leaf)
    for path, by_repeat in per_leaf.items():
        _set(out, path, np.stack([by_repeat[r] for r in sorted(by_repeat)]))
    return out
