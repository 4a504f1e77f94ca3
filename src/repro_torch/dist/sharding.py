"""The path-pattern sharding rules (port of `repro.dist.sharding`) and the
placement of a rank's shards.

The rules are JAX's, entry for entry, over JAX paths and shapes: a port
leaf is named by `convert.jax_path` and shaped by `convert.jax_shape`
(its group's leading `repeats` dim put back). A spec is a tuple with one
entry a dim: None, an axis name, or a tuple of axis names (the dp
direction of a 3-axis mesh). The policy, as in JAX:

  * 'model': attention and FFN projections column-parallel on their
    output dim and row-parallel on their input dim (Megatron's layout);
    embeddings and lm_head shard the vocab dim; MoE expert stacks put the
    expert dim on 'model';
  * FSDP (shard_profile 'tp_fsdp'): large leaves also shard a free dim
    over 'data';
  * norms, biases, routers and every Hadamard adapter leaf (rows of a
    bank, gates) replicated;
  * `fit_spec` drops an axis that does not divide its dim, promoting
    'model' for a large embedding.

A rank's leaves (`shard_params`) are the full leaves sliced by their spec
with the leading `repeats` entry dropped (it is never sharded, and the
port keeps one dict a layer). A quantized leaf is quantized whole, then
sliced: its values and its scales each by the base leaf's rule, as JAX
places them; quantizing a row-parallel shard alone would give it
per-channel scales of its own. Beyond the rule table, a column-parallel
projection's output bias (bq, bk, bv, bi) is sliced with its columns:
JAX keeps it whole and GSPMD slices it where it is added; the port adds
it to the rank's columns, so it holds that slice. The per-device bytes
that the dry run reports come from the rule table alone.

`local_cfg` is the config a rank runs: n_heads, n_kv_heads and d_ff over
the model degree. `check_mesh` refuses what this slice does not shard,
each with the ROADMAP item that lifts the refusal.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.common import tree as tu
from repro_torch.convert import jax_path, jax_shape
from repro_torch.dist.api import (Mesh, _axis_size, dp_axes,
                                  mesh_axis_sizes)
from repro_torch.quant.qtensor import QTensor, is_qtensor

_PROMOTE_MIN = 1 << 20
_FSDP_MIN = 1 << 20

_RULES: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(pat), kind)
    for pat, kind in (
        (r"(^|/)(embed|pos_embed|type_embed|enc_pos_embed)/table$", "embed"),
        (r"(^|/)lm_head/kernel$", "col"),
        (r"(^|/)vlm_proj/kernel$", "col"),
        (r"/(attn|cross)/(wq|wk|wv)$", "col"),
        (r"/(attn|cross)/wo$", "row"),
        (r"/mlp/(wi|wg)$", "col"),
        (r"/mlp/wo$", "row"),
        (r"/moe/(wi|wg|wo)$", "expert"),
        (r"/moe/shared_w[ig]$", "col"),
        (r"/moe/shared_wo$", "row"),
        (r"/rec/(in_x|in_y|gate_a|gate_x)$", "col"),
        (r"/rec/out$", "row"),
        (r"/rwkv_tm/(wr|wk|wv|wg|lora1|wA)$", "col"),
        (r"/rwkv_tm/(wo|wB)$", "row"),
        (r"/rwkv_cm/(ck|cr)$", "col"),
        (r"/rwkv_cm/cv$", "row"),
    )
)

_MODEL_DIM_FROM_END = {"col": 1, "row": 2, "embed": 2, "expert": 3}

# adapter leaves (one row, a bank's rows, a shared-w bank's w) stay
# replicated: hot-swap writes a row on every rank, and the per-request
# gather inside a tick needs every row everywhere
_ADAPTER_RE = re.compile(r"/adapter/")

# QTensor components resolve against their base leaf's rule; a scale's
# collapsed contraction dim drops the 'model' entry of a row-parallel leaf
_QT_LEAF_RE = re.compile(r"/(values|scales)$")

Spec = Tuple


def fit_spec(entries: Sequence, shape: Sequence[int], mesh,
             promote_model: bool = False) -> List:
    """Drop any axis whose size does not divide its dim; with
    `promote_model`, put a dropped (or absent) 'model' on the largest
    unsharded dim it divides."""
    sizes = mesh_axis_sizes(mesh)
    out: List = []
    for dim, e in zip(shape, entries):
        if e is None or dim % _axis_size(e, sizes) != 0:
            out.append(None)
        else:
            out.append(e)
    while len(out) < len(shape):
        out.append(None)

    if promote_model and "model" not in out:
        m = sizes.get("model", 1)
        candidates = [
            i for i, dim in enumerate(shape)
            if out[i] is None and m > 1 and dim % m == 0 and dim >= m
        ]
        if candidates:
            out[max(candidates, key=lambda i: shape[i])] = "model"
    return out


def _match_rule(path: str) -> Optional[str]:
    for rx, kind in _RULES:
        if rx.search(path):
            return kind
    return None


def param_spec(path: str, shape: Sequence[int], cfg, mesh) -> Spec:
    """The spec of one parameter leaf by its JAX path and JAX shape."""
    qt = _QT_LEAF_RE.search(path)
    if qt is not None:
        path = path[: qt.start()]
    if _ADAPTER_RE.search(path):
        return ()
    kind = _match_rule(path)
    ndim = len(shape)
    if kind is None or ndim < 2:
        return ()

    offset = _MODEL_DIM_FROM_END[kind]
    if ndim < offset:
        return ()
    entries: List = [None] * ndim
    entries[ndim - offset] = "model"

    numel = 1
    for s in shape:
        numel *= int(s)
    entries = fit_spec(entries, shape, mesh,
                       promote_model=(kind == "embed"
                                      and numel >= _PROMOTE_MIN))

    if cfg.shard_profile == "tp_fsdp" and numel >= _FSDP_MIN:
        dsize = mesh_axis_sizes(mesh).get("data", 1)
        candidates = [
            i for i, dim in enumerate(shape)
            if entries[i] is None and dsize > 1 and dim % dsize == 0
            and dim >= dsize
        ]
        if candidates:
            entries[max(candidates, key=lambda i: shape[i])] = "data"

    return tuple(entries)


def batch_spec(mesh, ndim: int, shape: Sequence[int]) -> Spec:
    """The leading (batch) dim over the dp axes, dropped when it does not
    divide."""
    dp = dp_axes(mesh)
    entry = dp[0] if len(dp) == 1 else dp
    n = _axis_size(entry, mesh_axis_sizes(mesh))
    entries: List = [None] * ndim
    if ndim >= 1 and shape[0] % n == 0 and shape[0] >= n:
        entries[0] = entry
    return tuple(entries)


_CACHE_KV_RE = re.compile(r"/(attn|cross)/c?[kv]$")


def _kv_model_entry(entries: List, shape: Sequence[int], mesh) -> None:
    m = mesh_axis_sizes(mesh).get("model", 1)
    if m > 1:
        if shape[-2] % m == 0 and shape[-2] >= m:
            entries[-2] = "model"
        elif shape[-1] % m == 0 and shape[-1] >= m:
            entries[-1] = "model"  # JAX's MQA fallback: head_dim


def cache_spec(path: str, shape: Sequence[int], cfg, mesh) -> Spec:
    """One decode-cache leaf, JAX-stacked (repeats, batch, ...): batch on
    the dp axes; an attention K/V cache (repeats, batch, S, KH, Dh) also
    'model' on the kv heads, or on head_dim when they do not divide."""
    sizes = mesh_axis_sizes(mesh)
    ndim = len(shape)
    entries: List = [None] * ndim
    dp = dp_axes(mesh)
    dp_entry = dp[0] if len(dp) == 1 else dp
    n = _axis_size(dp_entry, sizes)
    if ndim >= 2 and shape[1] % n == 0 and shape[1] >= n:
        entries[1] = dp_entry
    if _CACHE_KV_RE.search(path) and ndim >= 5:
        _kv_model_entry(entries, shape, mesh)
    return tuple(entries)


def slot_cache_spec(path: str, shape: Sequence[int], cfg, mesh) -> Spec:
    """A slot-pool cache leaf: `cache_spec` with the slot dim replicated
    (slots are admitted and retired one at a time)."""
    entries = list(cache_spec(path, shape, cfg, mesh))
    while len(entries) < len(shape):
        entries.append(None)
    if len(entries) >= 2:
        entries[1] = None
    return tuple(entries)


def paged_cache_spec(path: str, shape: Sequence[int], cfg, mesh) -> Spec:
    """A paged block-pool leaf (repeats, num_blocks, page, KH, Dh), or its
    QTensor components: the block dim replicated, 'model' on the kv
    heads (head_dim fallback)."""
    qt = _QT_LEAF_RE.search(path)
    if qt is not None:
        path = path[: qt.start()]
    ndim = len(shape)
    entries: List = [None] * ndim
    if _CACHE_KV_RE.search(path) and ndim >= 5:
        _kv_model_entry(entries, shape, mesh)
    return tuple(entries)


def adapter_row_shardings(row, mesh):
    """An adapter row about to land in a live bank: replicated (an empty
    spec at every leaf), as the bank's own leaves are."""
    return tu.map_with_path(lambda p, leaf: (), row)


def adapter_gate_shardings(gates, mesh):
    """Sparse-serving row gates and masks: replicated."""
    return tu.map_with_path(lambda p, leaf: (), gates)


# ---------------------------------------------------------------------------
# the port's leaves: specs, bytes, slices
# ---------------------------------------------------------------------------


def leaf_specs(path: str, leaf, cfg, mesh) -> dict:
    """{component: (JAX path, JAX shape, spec)} of the port leaf `path`:
    one entry "" for a tensor, "values" and "scales" for a QTensor."""
    base = jax_path(path, cfg)
    parts = ({"values": leaf.values, "scales": leaf.scales}
             if is_qtensor(leaf) else {"": leaf})
    out = {}
    for name, t in parts.items():
        jp = f"{base}/{name}" if name else base
        shape = jax_shape(path, tuple(t.shape), cfg)
        out[name] = (jp, shape, param_spec(jp, shape, cfg, mesh))
    return out


def _shards(spec: Spec, mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for e in spec:
        if e is not None:
            n *= _axis_size(e, sizes)
    return n


def per_device_param_bytes(params, cfg, mesh) -> int:
    """Bytes one device holds of `params` (any device, meta included)
    under the rule table: each leaf's bytes over its spec's shard count."""
    total = 0
    for path, leaf in tu.flatten_with_paths(params):
        if leaf is None:
            continue
        parts = ({"values": leaf.values, "scales": leaf.scales}
                 if is_qtensor(leaf) else {"": leaf})
        specs = leaf_specs(path, leaf, cfg, mesh)
        for name, t in parts.items():
            total += t.numel() * t.element_size() // _shards(specs[name][2],
                                                             mesh)
    return total


def shard_leaf(full: torch.Tensor, spec: Spec, mesh: Mesh,
               rank: Optional[int] = None) -> torch.Tensor:
    """`rank`'s slice of `full` under `spec` (entries aligned with
    `full`'s dims), a contiguous copy; the leaf itself where the spec
    shards nothing."""
    coords = mesh.coords(rank)
    sizes = mesh.sizes
    out = full
    for dim, e in enumerate(spec):
        if e is None:
            continue
        axes = e if isinstance(e, tuple) else (e,)
        n, i = 1, 0
        for a in axes:
            n *= sizes.get(a, 1)
            i = i * sizes.get(a, 1) + coords.get(a, 0)
        if n == 1:
            continue
        step = out.shape[dim] // n
        out = out.narrow(dim, i * step, step)
    return out if out is full else out.contiguous()


# a column-parallel projection's output bias, sliced with its columns
_COL_BIAS = {"bq": "wq", "bk": "wk", "bv": "wv", "bi": "wi"}
_BIAS_RE = re.compile(r"/(attn|mlp)/(bq|bk|bv|bi)$")


def _port_spec(path: str, spec: Spec, leaf_ndim: int) -> Spec:
    """A JAX spec over the port's layout: a layer leaf drops the leading
    `repeats` entry (never sharded; refused below if it were)."""
    if len(spec) == leaf_ndim + 1:
        if spec and spec[0] is not None:
            raise ValueError(f"{path}: the rules shard a group's repeats "
                             f"dim ({spec}); a port layer cannot hold a "
                             "slice of layers")
        return spec[1:]
    return spec


def shard_params(params, cfg, mesh: Mesh, rank: Optional[int] = None):
    """`rank`'s shards of a full parameter tree (tensors or QTensors,
    already quantized whole): every leaf sliced by its rule, and a
    column-parallel output bias with its columns."""
    flat = dict(tu.flatten_with_paths(params))

    def one(path, leaf):
        if leaf is None:
            return None
        specs = leaf_specs(path, leaf, cfg, mesh)
        m = _BIAS_RE.search(path)
        if m is not None:
            wpath = path[: m.start(2)] + _COL_BIAS[m.group(2)]
            w = flat[wpath]
            wspec = leaf_specs(wpath, w, cfg, mesh)
            wspec = wspec["values" if is_qtensor(w) else ""]
            col = _port_spec(wpath, wspec[2], 2)[-1]
            return shard_leaf(leaf, (col,), mesh, rank)
        if is_qtensor(leaf):
            v, s = specs["values"], specs["scales"]
            return QTensor(
                shard_leaf(leaf.values, _port_spec(path, v[2],
                                                   leaf.values.dim()),
                           mesh, rank),
                shard_leaf(leaf.scales, _port_spec(path, s[2],
                                                   leaf.scales.dim()),
                           mesh, rank))
        return shard_leaf(leaf, _port_spec(path, specs[""][2], leaf.dim()),
                          mesh, rank)

    return tu.map_with_path(one, params)


# ---------------------------------------------------------------------------
# what a rank runs, and what this slice refuses
# ---------------------------------------------------------------------------

# ROADMAP queue 1 item 2's refusals, in its order
EXPERT_PARALLEL = ("expert parallelism (an all-to-all over 'model'; "
                   "ROADMAP queue 1, 'Distribution' refusal 1)")
OTHER_MIXERS = ("the RWKV6, RG-LRU, encdec and encoder families under "
                "model > 1 (ROADMAP queue 1, 'Distribution' refusal 2)")
FSDP = ("FSDP under a tp_fsdp config, whose rules also shard weights over "
        "'data' (ROADMAP queue 1, 'Distribution' refusal 3)")
KV_REPLICATION = ("KV-head replication for model degrees over n_kv_heads "
                  "(JAX shards head_dim there; ROADMAP queue 1, "
                  "'Distribution' refusal 4)")


def check_mesh(cfg, mesh: Optional[Mesh]) -> None:
    """Raise NotImplementedError for a (config, mesh) this slice does not
    shard, naming the ROADMAP item that will."""
    if mesh is None:
        return
    m = mesh.degree("model")
    if mesh.degree("dp") > 1 and cfg.shard_profile == "tp_fsdp":
        raise NotImplementedError(
            f"{cfg.name} at data degree {mesh.degree('dp')}: {FSDP}")
    if m == 1:
        return
    slots = cfg.layer_slots() + cfg.enc_layer_slots()
    if cfg.moe is not None or any(s.moe for s in slots):
        raise NotImplementedError(
            f"{cfg.name} at model degree {m}: {EXPERT_PARALLEL}")
    if (cfg.family not in ("decoder", "vlm")
            or any(s.kind != "attn" for s in slots)):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) at model degree {m}: {OTHER_MIXERS}")
    if cfg.n_kv_heads % m or cfg.n_heads % m:
        raise NotImplementedError(
            f"{cfg.name}: model degree {m} does not divide its "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads: {KV_REPLICATION}")
    if cfg.d_ff % m:
        raise NotImplementedError(
            f"{cfg.name}: model degree {m} does not divide d_ff "
            f"{cfg.d_ff}; the rules would replicate its MLP, which the "
            "Megatron layout does not run")


def local_cfg(cfg, mesh: Optional[Mesh]):
    """The config one rank runs: its heads, kv heads and d_ff; vocab and
    d_model whole (the vocab-parallel tables carry their own slice)."""
    check_mesh(cfg, mesh)
    m = 1 if mesh is None else mesh.degree("model")
    if m == 1:
        return cfg
    return cfg.replace(n_heads=cfg.n_heads // m,
                       n_kv_heads=cfg.n_kv_heads // m, d_ff=cfg.d_ff // m)


def sharded_paths(params, cfg, mesh: Optional[Mesh]) -> set:
    """Port paths whose leaves `shard_params` slices over 'model' (a
    trainable one counts once a shard in the global norm)."""
    if mesh is None or mesh.degree("model") == 1:
        return set()
    flat = dict(tu.flatten_with_paths(params))

    def sharded(path):
        leaf = flat[path]
        m = _BIAS_RE.search(path)
        if m is not None:  # with its weight's columns
            return sharded(path[: m.start(2)] + _COL_BIAS[m.group(2)])
        specs = leaf_specs(path, leaf, cfg, mesh)
        return any("model" in s[2] for s in specs.values())

    return {p for p, leaf in flat.items() if leaf is not None and sharded(p)}
