"""'/'-joined leaf paths over nested dicts, lists and named tuples.

Paths follow the reference's ``path_str``: dict keys as they are, list
indices as ``"0"``, ``"1"``, …, named-tuple fields by name. Dict keys are
walked in sorted order, as JAX flattens them.
"""

from __future__ import annotations

from typing import Any, Callable


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _walk(node, path: str, out: list):
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for key, child in kids:
        _walk(child, _join(path, key), out)


def tree_flatten_with_paths(tree) -> list[tuple[str, Any]]:
    """Flatten a tree into [(path_string, leaf), ...]. A module-level walk,
    not a closure that calls itself: that closure is a reference cycle
    which would hold the list, and every leaf in it, until the cyclic
    garbage collector runs (a full-width train state fills half the card)."""
    out: list = []
    _walk(tree, "", out)
    return out


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """Map ``fn(path, leaf)`` over a tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, _join(path, str(k)))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, _join(path, f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, _join(path, str(i)))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_unflatten(flat: dict[str, Any]):
    """Inverse of ``tree_flatten_with_paths`` for dicts and lists: a level
    whose keys are all decimal indices becomes a list."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        *inner, last = path.split("/")
        for key in inner:
            node = node.setdefault(key, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            idx = sorted(node, key=int)
            if [int(k) for k in idx] != list(range(len(idx))):
                raise ValueError(f"list indices are not contiguous: {idx}")
            return [listify(node[k]) for k in idx]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _leaf_count(x) -> int:
    if hasattr(x, "shape"):
        n = 1
        for d in x.shape:
            n *= int(d)
        return n
    return 1


def _leaf_bytes(x) -> int:
    if hasattr(x, "dtype") and hasattr(x, "shape"):
        return _leaf_count(x) * x.dtype.itemsize
    return 0


def tree_count(tree) -> int:
    """Total number of elements across all array leaves (tensors, DTensors
    at their global shape, ``params.ShapeDtype``)."""
    return sum(_leaf_count(leaf) for _, leaf in tree_flatten_with_paths(tree))


def tree_bytes(tree) -> int:
    """Total bytes across all array leaves, as ``tree_count`` counts them."""
    return sum(_leaf_bytes(leaf) for _, leaf in tree_flatten_with_paths(tree))
