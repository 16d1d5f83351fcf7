"""Trees of tensors: nested dicts, lists, tuples and named tuples.

The port's params, optimizer state and error state are such trees (the
JAX package's pytrees).  Leaves come in the order ``jax.tree.flatten``
gives them — dict keys sorted, lists and tuples in order, a named tuple's
fields in order, ``None`` no leaf — so that a sum over the leaves (the
global gradient norm) runs in the reference's order, and each leaf's path
is the string the JAX package's checkpointer writes: dict keys and list
indices as they are, a named tuple's field as ``.name``
(``params/blocks/0/attn/wq``, ``opt/.m/embed``).
"""
from __future__ import annotations


def _children(node):
    """(key string, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _walk(node, path, out):
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append(("/".join(path), node))
        return
    for key, child in kids:
        _walk(child, path + (key,), out)


def flatten_with_paths(tree):
    """[(path, leaf), ...] in the reference's leaf order."""
    out = []
    _walk(tree, (), out)
    return out


def leaves(tree):
    return [leaf for _, leaf in flatten_with_paths(tree)]


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        rebuilt = {k: None for k in node}          # keep insertion order
        for k in sorted(node):
            rebuilt[k] = _build(node[k], it)
        return rebuilt
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_build(getattr(node, f), it)
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure whose leaves are ``new_leaves``, in
    the order :func:`leaves` gives ``like``'s.  (Module-level recursion:
    a recursive closure is a reference cycle, which would keep the leaves
    alive until the next garbage collection.)"""
    it = iter(new_leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def map_leaves(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (each of ``tree``'s structure)."""
    flat = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
