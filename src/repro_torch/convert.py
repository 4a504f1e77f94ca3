"""Carry a JAX parameter tree across to the port, and back.

`from_jax_params` takes the JAX package's parameter tree with its leaves
already converted to numpy by the caller, so this module needs no JAX. JAX
groups stack their layers' parameters on a leading `repeats` dim
(`repro.models.program`); the port keeps one dict per layer, so each
stacked leaf is unstacked in execution order: group by group, repeat by
repeat, slot by slot. Every leaf is named by its path; a leaf the port does
not know (or that the config's family does not have) raises. A multi-task
bank (adapter leaves (repeats, T, d)) carries over as (T, d) rows per
layer, and the baselines' adapters (LoRA, IA3, Houlsby) as their leaves
per layer: a stacked (repeats, d, r) LoRA leaf gives each layer its (d,
r), and a stacked (repeats, E, d, f) expert stack each MoE layer its (E,
d, f) (the fp32 router stays fp32), and an RG-LRU layer its rec leaves
(its `a_param` stays fp32, as JAX makes it). `jax_path` names a port leaf
by its JAX path, so that one regex (a PEFT mask) means the same leaves in
both packages. An encdec model's encoder stack ("enc_blocks/g<G>/slot<S>"
in JAX, "enc_layers/<i>" in the port) unstacks the same way over
`cfg.enc_groups`, and its cross-attention leaves ("cross", "cross_norm")
are block leaves like any other.

Task deltas (`core.hadamard.extract_delta`) carry over in the layout the
registry stores. A delta is a partial tree with None holes; in the JAX
layout its layer leaves are stacked over the group's repeats ((L, d)) or
are `sparse.PackedRows`, whose mask spans the whole stacked leaf.
`stack_delta` groups the port's per-layer leaves by `jax_path` into that
layout and `unstack_delta` splits it back, so a delta packed by the port
and one packed by JAX hold the same rows under the same masks, and the
files the two write are the same bytes. `from_jax_delta`/`to_jax_delta`
move a JAX-layout delta between numpy and torch.

A quantized backbone carries over too. JAX's QTensor leaves flatten to
`<leaf>/values` (int8 or float8_e4m3fn, stacked (repeats, K, N)) and
`<leaf>/scales` (fp32, (repeats, 1, N)); each layer of the port gets its
own 2-D `QTensor`, and `to_jax_params` stacks them back under the same two
names.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.common import tree as tu
from repro_torch.common.types import ModelCfg
from repro_torch.quant.qtensor import QTensor, quantizable

_NORMS = ("attn_norm", "ffn_norm", "post_attn_norm", "post_ffn_norm",
          "cross_norm")
BLOCK_LEAVES = frozenset(
    [f"{n}/{leaf}" for n in _NORMS for leaf in ("scale", "bias")]
    + [f"{a}/{w}" for a in ("attn", "cross")
       for w in ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo", "q_norm",
                 "k_norm")]
    + [f"mlp/{w}" for w in ("wi", "wo", "wg", "bi", "bo")]
    + [f"moe/{w}" for w in ("router", "wi", "wg", "wo", "shared_wi",
                            "shared_wg", "shared_wo")]
    + [f"rwkv_tm/{w}" for w in ("mu_x", "mu", "lora1", "lora2", "w0", "wA",
                                "wB", "u", "wr", "wk", "wv", "wg", "wo",
                                "ln_x_scale", "ln_x_bias")]
    + [f"rwkv_cm/{w}" for w in ("mu_k", "mu_r", "ck", "cv", "cr")]
    + [f"rec/{w}" for w in ("in_x", "in_y", "conv_w", "conv_b", "a_param",
                            "gate_a", "gate_x", "gate_a_b", "gate_x_b",
                            "out")]
    + [f"adapter/{w}" for w in ("w", "b",  # Hadamard
                                 "qa", "qb", "va", "vb",  # LoRA
                                 "lk", "lv", "lff")]  # IA3
    + [f"adapter/{ad}/{w}" for ad in ("attn_ad", "ffn_ad")  # Houlsby
       for w in ("down", "down_b", "up", "up_b")])
TOP_LEAVES = frozenset(["embed/table", "final_norm/scale", "final_norm/bias",
                        "lm_head/kernel"])
ENCODER_LEAVES = frozenset(["pos_embed/table", "type_embed/table",
                            "embed_norm/scale", "embed_norm/bias",
                            "pooler/kernel", "pooler/bias",
                            "classifier/kernel", "classifier/bias"])
ENCDEC_LEAVES = frozenset(["enc_final_norm/scale", "enc_final_norm/bias",
                           "enc_pos_embed/table"])
# group 1: "enc_" for the encdec encoder's stack
_BLOCK_RE = re.compile(r"^(enc_)?blocks/g(\d+)/slot(\d+)/(.+)$")
_LAYER_RE = re.compile(r"^(enc_)?layers/(\d+)/(.+)$")
_QFIELD_RE = re.compile(r"^(.+)/(values|scales)$")


def top_leaves(cfg: ModelCfg) -> frozenset:
    """The non-block leaves a config of this family may hold."""
    out = TOP_LEAVES
    if cfg.family == "encoder":
        out = out | ENCODER_LEAVES
    if cfg.pos == "learned":
        out = out | {"pos_embed/table"}
    if cfg.enc_groups:
        out = out | ENCDEC_LEAVES
    if cfg.family == "vlm":
        out = out | {"vlm_proj/kernel"}
    return out


def _groups(cfg: ModelCfg, enc) -> tuple:
    """The decoder's groups, or with `enc` the encoder's."""
    return cfg.enc_groups if enc else cfg.groups


def _jax_stack(enc) -> str:
    """JAX's stacked tree of a stack: the decoder's, or with `enc` the
    encoder's."""
    return "enc_blocks" if enc else "blocks"


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, including ml_dtypes' bfloat16 and float8_e4m3fn
    arrays, which are read through their bit patterns."""
    a = np.array(a)  # a writable copy that the tensor owns
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if str(a.dtype) == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(
            torch.float8_e4m3fn).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy. bf16 comes back as fp32 (numpy has no bfloat16 of
    its own); float8_e4m3fn as ml_dtypes' type of that name, the one JAX
    uses, imported only when such a tensor is met."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    if t.dtype == torch.float8_e4m3fn:
        import ml_dtypes  # numpy's fp8 type, installed beside JAX

        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return t.numpy()


def _field_leaves(path: str, leaf):
    """(path, array) pairs of a port leaf in the JAX layout: a QTensor is
    its two fields."""
    if isinstance(leaf, QTensor):
        return [(f"{path}/values", leaf.values), (f"{path}/scales", leaf.scales)]
    return [(path, leaf)]


def _known_leaf(rest: str, known: frozenset) -> bool:
    """A leaf of `known`, or a field of a quantized one."""
    m = _QFIELD_RE.match(rest)
    return rest in known or (m is not None and m.group(1) in known
                             and quantizable("/" + m.group(1)))


def _join_qtensors(tree: dict) -> dict:
    """Each {"values", "scales"} dict of a quantizable leaf -> a QTensor."""
    def walk(node, path):
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        if set(node) == {"values", "scales"} and quantizable("/" + path):
            return QTensor(node["values"], node["scales"])
        return {k: walk(v, f"{path}/{k}" if path else k)
                for k, v in node.items()}

    return walk(tree, "")


def _layer_index(cfg: ModelCfg,
                 enc: bool = False) -> Dict[Tuple[int, int, int], int]:
    """(group, repeat, slot) -> position in the port's layer list (the
    encoder's with `enc`)."""
    out, n = {}, 0
    for gi, g in enumerate(_groups(cfg, enc)):
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
    stacked leaf), 'enc_layers/1/...' -> 'enc_blocks/g0/slot0/...'; a
    top-level path is the same in both."""
    m = _LAYER_RE.match(path)
    if m is None:
        return path
    enc = m.group(1)
    gi, _, si = _layer_position(cfg, enc)[int(m.group(2))]
    return f"{_jax_stack(enc)}/g{gi}/slot{si}/{m.group(3)}"


def jax_ndim(path: str, leaf: torch.Tensor) -> int:
    """The rank of the port leaf `path` in the JAX layout: a layer's leaf
    is one slice of its group's stacked leaf, one rank more."""
    return leaf.dim() + (1 if _LAYER_RE.match(path) else 0)


def _layer_position(cfg: ModelCfg,
                    enc: bool = False) -> List[Tuple[int, int, int]]:
    """Position in the port's layer list (the encoder's with `enc`) ->
    (group, repeat, slot)."""
    index = _layer_index(cfg, enc)
    return sorted(index, key=index.get)


def _stacks(cfg: ModelCfg):
    """(enc, the port's list name) of each stack the config has."""
    return [(False, "layers")] + ([(True, "enc_layers")]
                                  if cfg.enc_groups else [])


def _empty_layers(cfg: ModelCfg) -> Dict[bool, List[dict]]:
    return {enc: [{} for _ in range(len(_layer_index(cfg, enc)))]
            for enc, _ in _stacks(cfg)}


def from_jax_params(np_tree: dict, cfg: ModelCfg, device) -> dict:
    """The port's parameters from a JAX parameter tree (any family) whose
    leaves are numpy arrays. Raises on any leaf it does not map."""
    index = {enc: _layer_index(cfg, enc) for enc, _ in _stacks(cfg)}
    layers = _empty_layers(cfg)
    out: dict = {}
    for path, leaf in tu.flatten_with_paths(np_tree):
        m = _BLOCK_RE.match(path)
        if m is None:
            if not _known_leaf(path, top_leaves(cfg)):
                raise KeyError(f"unknown JAX parameter leaf {path!r}")
            _set(out, path, to_tensor(leaf, device))
            continue
        enc = bool(m.group(1))
        gi, si, rest = int(m.group(2)), int(m.group(3)), m.group(4)
        groups = _groups(cfg, enc)
        if not _known_leaf(rest, BLOCK_LEAVES):
            raise KeyError(f"unknown JAX block parameter leaf {path!r}")
        if gi >= len(groups) or si >= len(groups[gi].slots):
            raise KeyError(f"JAX leaf {path!r} has no slot in {cfg.name}")
        arr = np.asarray(leaf)
        if arr.shape[0] != groups[gi].repeats:
            raise ValueError(f"{path}: leading dim {arr.shape[0]} != group "
                             f"repeats {groups[gi].repeats}")
        for r in range(arr.shape[0]):
            _set(layers[enc][index[enc][(gi, r, si)]], rest,
                 to_tensor(arr[r], device))
    for enc, name in _stacks(cfg):
        out[name] = layers[enc]
    return _join_qtensors(out)


def to_jax_params(params: dict, cfg: ModelCfg) -> dict:
    """The inverse of `from_jax_params`: a JAX-layout tree of numpy arrays
    with each group's layers stacked again (bf16 leaves come back as fp32,
    numpy having no bfloat16 of its own; see `to_numpy`). A QTensor leaf
    comes back as its `values` and `scales` arrays."""
    out: dict = {}
    for path, leaf in tu.flatten_with_paths(params):
        if not _LAYER_RE.match(path):
            for p, t in _field_leaves(path, leaf):
                _set(out, p, to_numpy(t))
    per_leaf: Dict[str, Dict[int, np.ndarray]] = {}
    for enc, name in _stacks(cfg):
        for (gi, r, si), li in _layer_index(cfg, enc).items():
            for rest, leaf in tu.flatten_with_paths(params[name][li]):
                for p, t in _field_leaves(rest, leaf):
                    key = f"{_jax_stack(enc)}/g{gi}/slot{si}/{p}"
                    per_leaf.setdefault(key, {})[r] = to_numpy(t)
    for path, by_repeat in per_leaf.items():
        _set(out, path, np.stack([by_repeat[r] for r in sorted(by_repeat)]))
    return out


# ---------------------------------------------------------------------------
# task deltas
# ---------------------------------------------------------------------------


def _sorted_tree(tree):
    """Dicts with their keys sorted, as JAX's tree functions leave them:
    the store writes leaves in tree order, so the order decides the
    bytes."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def stack_delta(delta: dict, cfg: ModelCfg) -> dict:
    """A per-layer delta (or row tree) in the JAX layout: the leaves of
    every layer that share a `jax_path` stacked in repeat order, None
    holes kept, keys sorted. A tree with no "layers" list is taken to be in
    the JAX layout already and is returned as it is."""
    if not isinstance(delta.get("layers"), list):
        return delta
    position = {enc: _layer_position(cfg, enc) for enc, _ in _stacks(cfg)}
    out: dict = {}
    groups: Dict[str, Dict[int, object]] = {}
    for path, leaf in tu.flatten_with_paths(delta):
        m = _LAYER_RE.match(path)
        if m is None:
            _set(out, path, leaf)
            continue
        enc = bool(m.group(1))
        gi, r, si = position[enc][int(m.group(2))]
        groups.setdefault(f"{_jax_stack(enc)}/g{gi}/slot{si}/{m.group(3)}",
                          {})[r] = leaf
    for path, by_repeat in groups.items():
        leaves = [by_repeat[r] for r in sorted(by_repeat)]
        if all(v is None for v in leaves):
            _set(out, path, None)
        elif any(v is None for v in leaves):
            raise ValueError(f"{path}: some layers of the group hold the "
                             "leaf and some do not")
        else:
            _set(out, path, torch.stack(leaves))
    return _sorted_tree(out)


def unstack_delta(tree: dict, cfg: ModelCfg) -> dict:
    """The inverse of `stack_delta`: a dense JAX-layout delta (PackedRows
    unpacked first, `sparse.unpack_delta`) -> {"layers": [one dict per
    layer], **top-level leaves} (and "enc_layers" for an encdec config),
    with each stacked leaf's rows given to
    its layers as views. Raises ValueError on a leaf whose group or
    leading dim does not fit `cfg`."""
    from repro_torch.sparse.prune import is_packed  # sparse imports convert

    index = {enc: _layer_index(cfg, enc) for enc, _ in _stacks(cfg)}
    layers = _empty_layers(cfg)
    out: dict = {}
    for path, leaf in tu.flatten_with_paths(tree):
        m = _BLOCK_RE.match(path)
        if m is None:
            _set(out, path, leaf)
            continue
        enc = bool(m.group(1))
        gi, si, rest = int(m.group(2)), int(m.group(3)), m.group(4)
        groups = _groups(cfg, enc)
        if gi >= len(groups) or si >= len(groups[gi].slots):
            raise ValueError(f"{path} has no slot in {cfg.name}")
        repeats = groups[gi].repeats
        if is_packed(leaf):
            raise ValueError(f"{path} is a PackedRows leaf; unpack the delta "
                             "first (sparse.unpack_delta)")
        if leaf is not None and leaf.shape[0] != repeats:
            raise ValueError(f"{path}: leading dim {leaf.shape[0]} != group "
                             f"repeats {repeats}")
        for r in range(repeats):
            _set(layers[enc][index[enc][(gi, r, si)]], rest,
                 None if leaf is None else leaf[r])
    for enc, name in _stacks(cfg):
        out[name] = layers[enc]
    return out


def from_jax_delta(np_tree: dict, device="cpu") -> dict:
    """A JAX-layout delta with numpy leaves (None holes and JAX
    PackedRows allowed) -> the same tree with torch leaves and the port's
    `PackedRows`. JAX's PackedRows is read through its mask, rows and
    fill, so this module needs no JAX."""
    from repro_torch.sparse.prune import PackedRows

    def one(_, leaf):
        if leaf is None:
            return None
        if all(hasattr(leaf, a) for a in ("mask", "rows", "fill")):
            return PackedRows(np.asarray(leaf.mask), np.asarray(leaf.rows),
                              leaf.fill)
        return to_tensor(np.asarray(leaf), device)

    return tu.map_with_path(one, np_tree)


def to_jax_delta(delta: dict, packed=None) -> dict:
    """The inverse of `from_jax_delta`: numpy leaves; a port PackedRows
    becomes packed(mask, rows, fill), with `packed` the JAX PackedRows
    class the caller passes in (required only when the tree holds one)."""
    from repro_torch.sparse.prune import is_packed

    def one(path, leaf):
        if leaf is None:
            return None
        if is_packed(leaf):
            if packed is None:
                raise ValueError(f"{path} is a PackedRows leaf: pass the "
                                 "class to build it with (packed=...)")
            return packed(leaf.mask.numpy(), leaf.rows.numpy(), leaf.fill)
        return to_numpy(leaf)

    return tu.map_with_path(one, delta)
