"""Checkpoint serialization (port of `repro.checkpoint.store`): a nested
dict of tensors <-> one msgpack file, in the JAX package's format.

The envelope is {"meta": metadata, "arrays": {path: {"dtype", "shape",
"data"}}}, packed by the port's own codec (`_msgpack`) and, compressed,
framed as b"ZLIB" + zlib level 3, so the port and `repro.checkpoint.store`
read each other's files and write the same bytes for the same tree. Leaves
are written in tree order with every dict's keys sorted, as JAX's tree
functions order them. bfloat16 travels as its bit pattern under the dtype
name "bfloat16", float8_e4m3fn under its own name. A quantized leaf
(`quant.QTensor`) is written as sibling arrays `__qvalues__`/`__qscales__`
and a packed sparse leaf (`sparse.PackedRows`) as
`__spmask__`/`__sprows__`/`__spfill__`; `load_tree` reassembles both.

A b"ZSTD" frame (JAX's writer where `zstandard` is installed) cannot be
read here and raises ValueError naming the missing package. Writes are
atomic (tmp file, fsync, rename). Loads return CPU tensors.
"""
from __future__ import annotations

import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.quant.qtensor import QTensor
from repro_torch.sparse.prune import PackedRows

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "int8": torch.int8,
    "uint8": torch.uint8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}

_QT_VALUES, _QT_SCALES = "__qvalues__", "__qscales__"
_SP_MASK, _SP_ROWS, _SP_FILL = "__spmask__", "__sprows__", "__spfill__"


def _array_spec(v) -> Tuple[str, list, bytes]:
    """(dtype name, shape, C-order bytes) of a tensor leaf."""
    if not torch.is_tensor(v):
        raise TypeError(f"checkpoint leaves are tensors, got "
                        f"{type(v).__name__}")
    if v.dtype not in _NAMES:
        raise TypeError(f"checkpoint: unsupported dtype {v.dtype}")
    t = v.detach().cpu().contiguous()
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return _NAMES[t.dtype], list(t.shape), raw


def _flatten(tree, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    if isinstance(tree, QTensor):
        out[f"{prefix}{_QT_VALUES}"] = tree.values
        out[f"{prefix}{_QT_SCALES}"] = tree.scales
    elif isinstance(tree, PackedRows):
        out[f"{prefix}{_SP_MASK}"] = tree.mask
        out[f"{prefix}{_SP_ROWS}"] = tree.rows
        out[f"{prefix}{_SP_FILL}"] = torch.tensor(tree.fill,
                                                  dtype=torch.float32)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        raise TypeError(f"checkpoint trees are nested dicts; {prefix!r} is a "
                        "list (a per-layer tree: save its JAX layout, "
                        "convert.stack_delta)")
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, torch.Tensor]):
    root: dict = {}
    for path, v in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def reassemble(node):
        if not isinstance(node, dict):
            return node
        if set(node) == {_QT_VALUES, _QT_SCALES}:
            return QTensor(node[_QT_VALUES], node[_QT_SCALES])
        if set(node) == {_SP_MASK, _SP_ROWS, _SP_FILL}:
            return PackedRows(node[_SP_MASK], node[_SP_ROWS],
                              float(node[_SP_FILL]))
        return {k: reassemble(v) for k, v in node.items()}

    return reassemble(root)


def save_tree(path: str, tree, *, compress: bool = True,
              metadata: Optional[dict] = None) -> None:
    arrays = {}
    for k, v in _flatten(tree).items():
        dtype, shape, data = _array_spec(v)
        arrays[k] = {"dtype": dtype, "shape": shape, "data": data}
    raw = _msgpack.packb({"meta": metadata or {}, "arrays": arrays})
    if compress:
        raw = b"ZLIB" + zlib.compress(raw, level=3)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic publish


def _tensor(spec: dict) -> torch.Tensor:
    dtype = _DTYPES.get(spec["dtype"])
    if dtype is None:
        raise ValueError(f"unknown dtype {spec['dtype']!r}")
    shape = [int(n) for n in spec["shape"]]
    data = spec["data"]
    itemsize = torch.empty((), dtype=dtype).element_size()
    if len(data) != int(np.prod(shape)) * itemsize:
        raise ValueError(f"{len(data)} bytes do not hold a {shape} "
                         f"{spec['dtype']} array")
    if not data:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).view(
        dtype).reshape(shape)


def load_tree(path: str):
    """(tree, metadata) of a snapshot. Any corruption (truncated file,
    flipped bytes, a bad compression stream, array bytes that do not fit
    their dtype and shape) raises ValueError naming the file."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] == b"ZSTD":
        raise ValueError(f"{path} is zstd-compressed; reading it needs the "
                         "`zstandard` package, which the port does not use "
                         "(JAX's store writes zlib where it is not "
                         "installed)")
    try:
        if raw[:4] == b"ZLIB":
            raw = zlib.decompress(raw[4:])
        payload = _msgpack.unpackb(raw)
        if not isinstance(payload, dict) or "arrays" not in payload \
                or "meta" not in payload:
            raise ValueError("payload is not a snapshot envelope")
        flat = {k: _tensor(spec) for k, spec in payload["arrays"].items()}
        tree = _unflatten(flat)
    except (ValueError, TypeError, KeyError, zlib.error,
            RuntimeError) as e:
        raise ValueError(f"corrupt checkpoint {path}: {e!r}") from e
    return tree, payload["meta"]
