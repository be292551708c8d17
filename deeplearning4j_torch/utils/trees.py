"""Nested parameter trees: dicts of tensors, and tuples of tensors in an
updater's state.

A layer's parameters are one dict of tensors, except under a wrapper:
``Bidirectional`` holds ``{"fwd": {...}, "bwd": {...}}``, as the JAX
package's pytrees do. Keypaths join dict keys and tuple indices with "/"
(``"0/fwd/W"``, Adam's m at ``"0/fwd/W/0"``), the JAX package's
``tree_flatten_with_path`` names in its model zips.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["leaves", "sorted_leaves", "tree_map", "nest"]


def leaves(tree, prefix="") -> Iterator[Tuple[str, torch.Tensor]]:
    """(keypath, tensor) of each tensor in nested dicts and tuples, in
    insertion order."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for k, sub in items:
        yield from leaves(sub, f"{prefix}/{k}" if prefix else str(k))


def sorted_leaves(tree, prefix=""):
    """(keypath, leaf) of a dict tree of tensors or host arrays in sorted
    key order (the JAX package's ``tree_leaves`` order: dict pytrees
    flatten sorted)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += sorted_leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on each tensor of a dict tree (and the tensors at the same
    keys of ``rest``), keeping the nesting."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def nest(flat: Mapping[str, torch.Tensor]) -> Dict:
    """{"fwd/W": t, "b": u} -> {"fwd": {"W": t}, "b": u}."""
    out: Dict = {}
    for path, t in flat.items():
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return out
