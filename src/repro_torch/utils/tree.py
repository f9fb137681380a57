"""Small helpers over the port's param trees (nested dicts and lists of
tensors), the port of `repro.utils.tree`. Meta tensors count like any
other: their shapes and dtypes are all that is read."""
from __future__ import annotations

import math

import torch

from ..train.optimizer import tree_leaves, tree_map


def tree_size_bytes(tree) -> int:
    """Total bytes of every tensor leaf (meta tensors too)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tree_num_params(tree) -> int:
    return sum(math.prod(t.shape) for t in tree_leaves(tree))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_cast(tree, dtype: torch.dtype):
    """Floating-point leaves cast to `dtype`; the others as they are."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def tree_shape_dtype(tree):
    """The tree as meta tensors of the same shapes and dtypes (for dry
    runs), the counterpart of the reference's ShapeDtypeStructs."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)
