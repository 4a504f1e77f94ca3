"""Path helpers over the port's parameter trees (nested dicts and lists
of tensors). A leaf's path joins its keys and list indices with '/', e.g.
'layers/3/adapter/w', so one regex addresses a leaf kind in every layer."""
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


def count_params(tree) -> int:
    return sum(leaf.numel() for _, leaf in flatten_with_paths(tree))


def count_masked(tree, mask) -> int:
    """Elements of the leaves whose flag in `mask` (a tree of bools of the
    same structure) is True."""
    flags = dict(flatten_with_paths(mask))
    return sum(leaf.numel() for path, leaf in flatten_with_paths(tree)
               if flags[path])
