"""Parameter and state trees: nested dicts, tuples and lists of tensors.

``flatten`` visits leaves in the order ``jax.tree.flatten`` gives for the
same nesting: dict keys sorted, tuples and lists in order, ``None`` an
empty subtree. A checkpoint's ``leaf_<i>.npy`` and the optimiser's global
norm both depend on that order, so the port's trees line up with the
reference's leaf for leaf. (``torch.utils._pytree`` keeps a dict's
insertion order instead.)
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = object()


def _walk(node, leaves: List[Any], is_leaf=None):
    if node is None:
        return None
    if is_leaf is not None and is_leaf(node):
        leaves.append(node)
        return _LEAF
    if isinstance(node, dict):
        keys = sorted(node)
        return (dict, keys, [_walk(node[k], leaves, is_leaf) for k in keys])
    if isinstance(node, (tuple, list)):
        return (type(node), None, [_walk(v, leaves, is_leaf) for v in node])
    leaves.append(node)
    return _LEAF


def _build(spec, it):
    if spec is None:
        return None
    if spec is _LEAF:
        return next(it)
    kind, keys, children = spec
    if kind is dict:
        return {k: _build(c, it) for k, c in zip(keys, children)}
    return kind(_build(c, it) for c in children)


# _walk and _build are module functions, not recursive closures: a closure
# that calls itself is a reference cycle, and one over the leaves would
# keep every tensor of the tree alive until the next garbage collection
# (a whole optimiser state, step after step)

def flatten(tree, is_leaf=None) -> Tuple[List[Any], Any]:
    """(leaves, spec); ``unflatten(spec, leaves)`` rebuilds the tree.
    ``is_leaf(node)`` true stops the walk at ``node`` (a sharding spec is
    a tuple, yet a leaf of a spec tree)."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves, is_leaf)


def unflatten(spec, leaves):
    it = iter(leaves)
    out = _build(spec, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree's structure holds")
    return out


def describe(spec) -> str:
    """A readable form of ``spec``: ``*`` for a leaf (a checkpoint
    manifest's ``treedef``)."""
    if spec is None:
        return "None"
    if spec is _LEAF:
        return "*"
    kind, keys, children = spec
    if kind is dict:
        return "{" + ", ".join(f"{k!r}: {describe(c)}"
                               for k, c in zip(keys, children)) + "}"
    inner = ", ".join(describe(c) for c in children)
    return f"[{inner}]" if kind is list else f"({inner})"


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (same structure), leaf for leaf."""
    flat, spec = flatten(tree, is_leaf)
    others = [flatten(t, is_leaf)[0] for t in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])


def _paths(node, path, out: List[Tuple[str, ...]], is_leaf=None):
    if node is None:
        return
    if is_leaf is not None and is_leaf(node):
        out.append(path)
    elif isinstance(node, dict):
        for k in sorted(node):
            _paths(node[k], path + (str(k),), out, is_leaf)
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            _paths(v, path + (str(i),), out, is_leaf)
    else:
        out.append(path)


def leaf_paths(tree, is_leaf=None) -> List[Tuple[str, ...]]:
    """Each leaf's path of dict keys and sequence indices, as strings, in
    ``flatten``'s order (the names ``jax.tree_util.tree_map_with_path``
    gives the reference's rules)."""
    out: List[Tuple[str, ...]] = []
    _paths(tree, (), out, is_leaf)
    return out
