"""Pytrees of tensors: nested dicts, lists and tuples, in JAX's order.

``jax.tree`` flattens a dict in sorted-key order, and the parameter
server's rows, the compression blocks, the optimizer state and the
checkpoint's arrays all follow that order.  These helpers keep it, so a
tree of the port flattens to the same leaves in the same order as the
JAX package's tree of the same names.
"""
from __future__ import annotations

import math

import torch

__all__ = ["TreeDef", "tree_flatten", "tree_flatten_with_path",
           "tree_unflatten", "leaves", "tree_map", "map_axes", "ravel"]


class TreeDef:
    """Structure of a pytree of tensors: ``kind`` is "leaf", "dict",
    "list" or "tuple"; dict keys are kept sorted, as JAX orders them."""

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind, keys=(), children=()):
        self.kind, self.keys, self.children = kind, tuple(keys), tuple(
            children)

    def __eq__(self, other):
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.keys == other.keys
                and self.children == other.children)

    def __repr__(self):
        return f"TreeDef({self.kind}, {self.keys}, {self.children})"


def tree_flatten(tree):
    """(leaves, TreeDef) of a pytree of tensors."""
    if isinstance(tree, torch.Tensor):
        return [tree], TreeDef("leaf")
    if isinstance(tree, dict):
        keys = sorted(tree)
        items = [tree[k] for k in keys]
        kind = "dict"
    elif isinstance(tree, (list, tuple)):
        keys, items = (), list(tree)
        kind = "tuple" if isinstance(tree, tuple) else "list"
    else:
        raise TypeError(f"tree leaves must be tensors in dicts, lists or "
                        f"tuples, got {type(tree).__name__}")
    leaves, children = [], []
    for item in items:
        sub, td = tree_flatten(item)
        leaves += sub
        children.append(td)
    return leaves, TreeDef(kind, keys, children)


def tree_flatten_with_path(tree):
    """([(path, leaf)], TreeDef) in :func:`tree_flatten`'s order, as
    ``jax.tree_util.tree_flatten_with_path`` gives them: ``path`` is the
    tuple of keys from the root to the leaf, a dict key or a list/tuple
    index each."""
    flat, td = tree_flatten(tree)
    return list(zip(_paths(td, ()), flat)), td


def _paths(td: TreeDef, prefix: tuple):
    if td.kind == "leaf":
        yield prefix
        return
    keys = td.keys if td.kind == "dict" else range(len(td.children))
    for k, child in zip(keys, td.children):
        yield from _paths(child, prefix + (k,))


def _build(td: TreeDef, it):
    if td.kind == "leaf":
        return next(it)
    items = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.keys, items))
    return tuple(items) if td.kind == "tuple" else items


def tree_unflatten(treedef: TreeDef, leaves):
    # a module-level builder: a recursive closure would be a reference
    # cycle holding the leaves (the routed buffers) until the next garbage
    # collection, not until the caller drops them
    return _build(treedef, iter(leaves))


def leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which must have its structure), keeping the structure."""
    flat, td = tree_flatten(tree)
    others = []
    for r in rest:
        f, t = tree_flatten(r)
        if t != td:
            raise ValueError(f"tree structures differ: {td} and {t}")
        others.append(f)
    return tree_unflatten(td, [fn(*xs) for xs in zip(flat, *others)])


def map_axes(fn, axes, *rest):
    """``fn`` over the leaves of a tree of logical axes (nested dicts whose
    leaves are tuples, as ``jax.tree.map(..., is_leaf=lambda x:
    isinstance(x, tuple))`` takes them) and the matching leaves of
    ``rest`` (trees of the same dicts, any leaves)."""
    if isinstance(axes, dict):
        if any(not isinstance(r, dict) or r.keys() != axes.keys()
               for r in rest):
            raise ValueError(f"tree structures differ at keys "
                             f"{sorted(axes)}")
        return {k: map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes.items()}
    return fn(axes, *rest)


def ravel(tree):
    """``jax.flatten_util.ravel_pytree``: (the leaves raveled and
    concatenated in flatten order, ``unravel``), where ``unravel(flat)``
    returns the tree of views of ``flat`` in each leaf's shape (cast back
    to the leaf's dtype where it differs)."""
    flat_leaves, td = tree_flatten(tree)
    specs = [(tuple(x.shape), x.dtype) for x in flat_leaves]
    flat = (torch.cat([x.reshape(-1) for x in flat_leaves])
            if flat_leaves else torch.zeros((0,)))
    dtype = flat.dtype

    def unravel(v):
        out, at = [], 0
        for shape, dt in specs:
            n = math.prod(shape)
            x = v[at:at + n].view(shape)
            out.append(x if dt == dtype else x.to(dt))
            at += n
        return tree_unflatten(td, out)

    return flat, unravel
