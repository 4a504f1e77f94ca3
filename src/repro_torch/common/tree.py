"""Path helpers over the port's parameter trees (nested dicts and lists
of tensors). A leaf's path joins its keys and list indices with '/', e.g.
'layers/3/adapter/w', so one regex addresses a leaf kind in every layer.
Anything that is not a dict, list or tuple is a leaf: a quantized weight
(`quant.QTensor`) is one leaf, never split into its values and scales."""
from __future__ import annotations

import re
from typing import Callable, Iterable, Iterator, Optional, Tuple


def flatten_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_with_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_with_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def map_with_path(fn: Callable[[str, object], object], tree, prefix: str = ""):
    """A new tree of the same structure with fn(path, leaf) at each leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def mask_from_patterns(tree, patterns: Iterable[str],
                       path_of: Optional[Callable[[str], str]] = None):
    """A tree of bools: True where the leaf's path, renamed by `path_of`
    when given, matches any regex in `patterns` (re.search)."""
    regexes = [re.compile(p) for p in patterns]
    name = path_of or (lambda p: p)
    return map_with_path(
        lambda path, _: any(r.search(name(path)) for r in regexes), tree)


def partition(tree, mask):
    """Split into (selected, rest) of the same structure: a leaf whose
    flag in `mask` is True goes to the first, others to the second, and
    its place in the other tree holds None."""
    flags = dict(flatten_with_paths(mask))
    sel = map_with_path(lambda p, v: v if flags[p] else None, tree)
    rest = map_with_path(lambda p, v: None if flags[p] else v, tree)
    return sel, rest


def merge(a, b):
    """Inverse of `partition`: the non-None leaf of either tree at each
    path (`a`'s structure)."""
    other = dict(flatten_with_paths(b))

    def pick(path, x):
        y = other.get(path)
        if x is not None and y is not None:
            raise ValueError(f"merge: both leaves at {path!r} are set")
        return y if x is None else x

    return map_with_path(pick, a)


def count_params(tree) -> int:
    return sum(leaf.numel() for _, leaf in flatten_with_paths(tree))


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf as stored (a QTensor: values + scales);
    None placeholders count nothing."""
    return sum(leaf.nbytes for _, leaf in flatten_with_paths(tree)
               if leaf is not None)


def count_masked(tree, mask) -> int:
    """Elements of the leaves whose flag in `mask` (a tree of bools of the
    same structure) is True."""
    flags = dict(flatten_with_paths(mask))
    return sum(leaf.numel() for path, leaf in flatten_with_paths(tree)
               if flags[path])
