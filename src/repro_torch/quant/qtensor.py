"""QTensor: the quantized-weight leaf, and symmetric int8 / fp8
quantization of a frozen backbone (port of `repro.quant.qtensor`).

A QTensor holds `values` (int8, or float8_e4m3fn) and fp32 `scales`. A
matmul weight (d_in, d_out) is quantized per output channel: scales are
(1, d_out), so the contraction dim stays scale-free and the dequant-matmul
kernel (`kernels/quant.py`, #7) multiplies each finished column sum by its
scale.

The port keeps one tensor per layer where JAX stacks a group's layers on
a leading dim; per-channel scales over the contraction dim are the same
either way, so a quantized layer is byte for byte the slice of JAX's
stacked leaf. The tree walkers of `common/tree` see a QTensor as one leaf
(it is neither a dict nor a list), and it answers `numel`, `nbytes` and
`to(device)` as a tensor would, so counting, byte accounting and placement
never split it into its fields.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from repro_torch.common import tree as tu
from repro_torch.kernels.quant import DequantMatmul
from repro_torch.quant.calibrate import collecting, observe

# finite max of each storage type (e4m3fn has no inf encoding)
_QMAX = {"int8": 127.0, "fp8": 448.0}
_STORAGE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
QUANT_MODES = tuple(sorted(_QMAX))


def _storage_dtype(mode: str) -> torch.dtype:
    if mode not in _STORAGE:
        raise ValueError(f"unknown quantization mode {mode!r} "
                         f"(known: {QUANT_MODES})")
    return _STORAGE[mode]


@dataclasses.dataclass
class QTensor:
    """values: int8/fp8 payload; scales: fp32, broadcastable to values."""

    values: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self) -> int:
        return self.values.dim()

    @property
    def nbytes(self) -> int:
        return self.values.nbytes + self.scales.nbytes

    def numel(self) -> int:
        return self.values.numel()

    def to(self, device) -> "QTensor":
        return QTensor(self.values.to(device), self.scales.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.values.to(torch.float32)
                * self.scales.to(torch.float32)).to(dtype)


def is_qtensor(v) -> bool:
    return isinstance(v, QTensor)


# ---------------------------------------------------------------------------
# Quantize / dequantize
# ---------------------------------------------------------------------------


def quantize(x: torch.Tensor, mode: str = "int8", *, axis: Optional[int] = -2,
             clip: float = 1.0) -> QTensor:
    """Symmetric quantization of `x`, in JAX's order of operations so that
    the payload is the same byte for byte: scale = clip * absmax / qmax (a
    zero scale becomes 1.0), q = clip(x / scale, +-qmax), rounded half to
    even for int8; the fp8 cast rounds to nearest even.

    axis=-2 (default): one scale per output channel of a (..., d_in, d_out)
    weight, scales (..., 1, d_out). axis=None: one scale for the tensor."""
    dtype = _storage_dtype(mode)
    qmax = _QMAX[mode]
    x32 = x.to(torch.float32)
    if axis is None:
        absmax = x32.abs().amax().reshape((1,) * x32.dim())
    else:
        absmax = x32.abs().amax(dim=axis, keepdim=True)
    scale = clip * absmax / qmax
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(x32 / scale, -qmax, qmax)
    if mode == "int8":
        q = torch.round(q)
    return QTensor(q.to(dtype), scale)


def quantize_jitted(x: torch.Tensor, mode: str = "int8", *,
                    axis: Optional[int] = -1,
                    absmax: Optional[torch.Tensor] = None) -> QTensor:
    """`quantize(x, mode, axis=axis)` (clip 1) as XLA computes it inside a
    jitted JAX step: the division of absmax by the constant qmax becomes a
    product with its fp32 reciprocal, which rounds differently from the
    division for some absmax values. JAX quantizes K/V (serving), AdamW's
    int8 moments and the compressed gradients inside jitted steps, so
    those payloads are byte for byte JAX's only in this form; the eager
    `quantize` (and the weights JAX quantizes eagerly) divide. A given
    `absmax` (axis=None: a scalar tensor) replaces x's own, so that
    several tensors share the scale of the larger one they make up."""
    dtype = _storage_dtype(mode)
    x32 = x.to(torch.float32)
    recip = torch.tensor(1.0 / _QMAX[mode], dtype=torch.float32,
                         device=x.device)
    if axis is None:
        absmax = (x32.abs().amax() if absmax is None else absmax).reshape(
            (1,) * x32.dim())
    elif absmax is not None:
        raise ValueError("a shared absmax takes axis=None")
    else:
        absmax = x32.abs().amax(dim=axis, keepdim=True)
    scale = absmax * recip
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(x32 / scale, -_QMAX[mode], _QMAX[mode])
    if mode == "int8":
        q = torch.round(q)
    return QTensor(q.to(dtype), scale)


def quantize_kv(x: torch.Tensor, mode: str) -> QTensor:
    """`quantize_jitted` over the last dim, one scale per token and head:
    the KV blocks are byte for byte the ones JAX's paged pool holds."""
    return quantize_jitted(x, mode, axis=-1)


def residual_of(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x - qt.dequantize() in fp32, rounded once, as XLA's fused
    multiply-subtract computes it in a jitted step (the error-feedback
    residuals of the int8 moments and of gradient compression). The
    product of an int8 value and an fp32 scale is exact in fp64, and so
    is its difference from an x of about its size: one rounding to fp32."""
    return (x.to(torch.float64) - qt.values.to(torch.float64)
            * qt.scales.to(torch.float64)).to(torch.float32)


def fake_quantize(x: torch.Tensor, mode: str = "int8", *,
                  axis: Optional[int] = None, clip: float = 1.0):
    """quantize -> dequantize in one step, fp32 out."""
    return quantize(x, mode, axis=axis, clip=clip).dequantize(torch.float32)


def quantization_error(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Mean-squared dequantization error (fp32 scalar)."""
    d = x.to(torch.float32) - qt.dequantize(torch.float32)
    return d.square().mean()


# ---------------------------------------------------------------------------
# The matmul entry point of every projection in models/
# ---------------------------------------------------------------------------


def qdense(x: torch.Tensor, w, dtype, impl: str = "auto", *,
           tag: Optional[str] = None) -> torch.Tensor:
    """x @ w where w is a plain tensor or a QTensor.

    A plain tensor takes the plain path: x and w in the compute dtype, a
    library matmul; under an active calibration collector
    (`calibrate.collect_stats`) a call with a `tag` (the call site:
    'attn/wq', 'mlp/wi', 'lm_head', ...) first adds x's per-input-channel
    sum of squares to that tag's statistics. A 2-D QTensor goes through the
    dequant-matmul kernel (`DequantMatmul`, #7) on x's rows as they come:
    as JAX's QTensor branch, it does not cast x to `dtype`, and the output
    is in x.dtype."""
    if not isinstance(w, QTensor):
        if tag is not None and collecting():
            observe(tag, x)
        return torch.matmul(x.to(dtype), w.to(dtype))
    if w.ndim != 2:
        raise ValueError(f"qdense expects a 2D QTensor (got "
                         f"{tuple(w.shape)}): the port keeps one weight per "
                         "layer")
    shape = x.shape
    y = DequantMatmul.apply(x.reshape(-1, shape[-1]), w.values, w.scales,
                            impl)
    return y.reshape(*shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# Tree-level quantization (the frozen backbone)
# ---------------------------------------------------------------------------

# Which leaves a backbone quantization touches: the attention and MLP
# projections, an untied LM head and a VLM projector. Embedding tables,
# norms, biases, the encoder's pooler and classifier and every adapter leaf
# keep their dtype. Each entry is (path regex, match -> call-site tag): the
# tag under which `qdense` collects the leaf's calibration statistics.
_QUANT_TABLE = (
    (r"/(attn|cross)/(wq|wk|wv|wo)$", lambda m: f"attn/{m.group(2)}"),
    (r"/mlp/(wi|wg|wo)$", lambda m: f"mlp/{m.group(1)}"),
    (r"(^|/)lm_head/kernel$", lambda m: "lm_head"),
    (r"(^|/)vlm_proj/kernel$", lambda m: "vlm_proj"),
)

QUANT_PATTERNS = tuple(p for p, _ in _QUANT_TABLE)
_QUANT_RES = tuple(re.compile(p) for p in QUANT_PATTERNS)
_TAG_RES = tuple((re.compile(p), fmt) for p, fmt in _QUANT_TABLE)


def quantizable(path: str) -> bool:
    return any(r.search(path) for r in _QUANT_RES)


def tag_of(path: str) -> Optional[str]:
    for rx, fmt in _TAG_RES:
        m = rx.search(path)
        if m:
            return fmt(m)
    return None


_CLIP_GRID = (1.0, 0.95, 0.9, 0.85, 0.8, 0.7)


def _best_clip(leaf: torch.Tensor, mode: str, act_sq) -> float:
    """Activation-weighted clipping search, as JAX's `_best_clip`: the clip
    ratio of _CLIP_GRID minimizing sum_k m_k * (W - deq(Q(W)))^2_k, m the
    calibration pass's per-input-channel mean square. `leaf` is one
    (K, N) weight or a stack (..., K, N) of the layers that JAX stacks in
    one leaf; the error sums over all of it, so the stack gets one clip.
    Statistics of another width give 1.0."""
    w32 = leaf.to(torch.float32)
    m = torch.as_tensor(act_sq, dtype=torch.float32, device=w32.device)
    if tuple(m.shape) != (w32.shape[-2],):
        return 1.0
    weights = m.reshape((1,) * (w32.dim() - 2) + (-1, 1))
    best, best_err = 1.0, None
    for c in _CLIP_GRID:
        deq = quantize(w32, mode, clip=c).dequantize(torch.float32)
        err = float((weights * (w32 - deq).square()).sum())
        if best_err is None or err < best_err:
            best, best_err = c, err
    return best


def _wanted(path: str, leaf, regexes) -> bool:
    """A floating tensor of two or more dims whose path matches."""
    return (isinstance(leaf, torch.Tensor) and leaf.dim() >= 2
            and leaf.is_floating_point()
            and any(r.search(path) for r in regexes))


def _slot(tree, path: str):
    """(the container holding the leaf at `path`, its key or index)."""
    *heads, last = path.split("/")
    for k in heads:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree, (int(last) if isinstance(tree, (list, tuple)) else last)


def quantize_owned(trees, mode: str = "int8") -> None:
    """`quantize_tree(tree, mode)` done in place, one leaf at a time, over
    trees that the caller owns: one tree, or a list of trees that share
    their backbone leaves (a base and its adapter variants).

    Each matching leaf is quantized once, every tree's reference to it is
    replaced by that QTensor, and the dense leaf is released before the
    next one is quantized. So where nothing else references the trees'
    leaves, no more than one dense projection outlives its QTensor, and
    the peak is the dense tree plus one leaf's fp32 temporaries, not the
    dense tree plus the quantized one (`quantize_tree` returns a new tree
    while its argument keeps every dense leaf alive). The QTensors are
    `quantize_tree`'s byte for byte; QTensors and unmatched leaves stay as
    they are. The containers are mutated; nothing is returned."""
    _storage_dtype(mode)
    trees = list(trees) if isinstance(trees, (list, tuple)) else [trees]
    paths = [path for path, leaf in tu.flatten_with_paths(trees[0])
             if _wanted(path, leaf, _QUANT_RES)]
    for path in paths:
        made = {}  # id of a dense leaf -> its QTensor, for shared leaves
        for tree in trees:
            parent, key = _slot(tree, path)
            leaf = parent[key]
            if not _wanted(path, leaf, _QUANT_RES):
                continue
            if id(leaf) not in made:
                made[id(leaf)] = quantize(leaf, mode)
            parent[key] = made[id(leaf)]
        del made, leaf  # the dense leaf goes with the last reference


def quantize_tree(params, mode: str = "int8", *, stats=None, patterns=None,
                  cfg=None):
    """Quantize every backbone matmul leaf of a parameter tree.

    Leaves whose path matches `patterns` (default: QUANT_PATTERNS) and that
    are floating tensors of two or more dims become QTensors with
    per-output-channel scales; every other leaf, None and QTensors included,
    passes through, so the function is idempotent and a PEFT-partitioned
    frozen tree (None at the trainable leaves) quantizes directly.

    `stats` ({tag: (d_in,) activation mean square}, from
    `calibrate.calibrate`) gives each leaf whose tag has statistics an
    activation-weighted clip (`_best_clip`) in place of plain absmax. JAX
    searches one clip per stacked (layers, K, N) leaf; the port's leaves
    are per layer, so with stats the model's `cfg` is needed to name the
    JAX leaf of each path (`convert.jax_path`): the leaves of one name are
    stacked and searched as one, and each is then quantized with that
    clip."""
    _storage_dtype(mode)
    if stats and cfg is None:
        raise ValueError(
            "quantize_tree(stats=...) needs the model's cfg: JAX picks one "
            "clip per stacked (layers, K, N) leaf, so the per-layer leaves "
            "are searched by the JAX leaf they make (convert.jax_path)")
    regexes = (_QUANT_RES if patterns is None
               else tuple(re.compile(p) for p in patterns))

    def wanted(path, leaf):
        return _wanted(path, leaf, regexes)

    clips = {}
    if stats:
        from repro_torch.convert import jax_path  # convert imports this module

        groups = {}
        for path, leaf in tu.flatten_with_paths(params):
            if wanted(path, leaf) and tag_of(path) in stats:
                groups.setdefault(jax_path(path, cfg), []).append((path, leaf))
        for members in groups.values():
            stack = torch.stack([leaf for _, leaf in members])
            clip = _best_clip(stack, mode, stats[tag_of(members[0][0])])
            del stack
            clips.update((path, clip) for path, _ in members)

    def one(path, leaf):
        if not wanted(path, leaf):
            return leaf
        return quantize(leaf, mode, clip=clips.get(path, 1.0))

    return tu.map_with_path(one, params)


def dequantize_tree(tree, dtype=torch.float32):
    """Inverse of quantize_tree: QTensor leaves -> dense tensors."""
    return tu.map_with_path(
        lambda _, v: v.dequantize(dtype) if isinstance(v, QTensor) else v,
        tree)


def quant_summary(tree, leaf_name=None) -> dict:
    """Byte accounting of a (partly) quantized tree, as JAX reports it.

    quantized_bytes counts QTensor payload + scales, dense_bytes_fp32 what
    the same leaves cost at fp32, ratio the compression of that set, and
    total_bytes the whole tree as it stands. `leaf_name` maps a port path
    to the leaf it belongs to in the JAX layout (`convert.jax_path`), where
    a group's layers share one stacked leaf: n_quantized_leaves counts
    those, so both packages report the same count. Without it every
    per-layer tensor counts."""
    name = leaf_name or (lambda p: p)
    quantized = dense_fp32 = 0
    leaves = set()
    for path, leaf in tu.flatten_with_paths(tree):
        if isinstance(leaf, QTensor):
            leaves.add(name(path))
            quantized += leaf.nbytes
            dense_fp32 += leaf.numel() * 4
    return {
        "n_quantized_leaves": len(leaves),
        "quantized_bytes": quantized,
        "dense_bytes_fp32": dense_fp32,
        "ratio": dense_fp32 / quantized if quantized else 1.0,
        "total_bytes": tu.tree_bytes(tree),
    }
