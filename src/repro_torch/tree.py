"""Nested parameter dicts as flat leaf lists, in ``jax.tree.flatten``'s
order (dict keys sorted at every level), so a leaf list, a bucket
layout or a residual vector of the port lines up with the JAX
package's."""
from __future__ import annotations


def leaves_with_paths(tree: dict, prefix=()):
    """(path, leaf) pairs in sorted-key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves_with_paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def leaves(tree: dict) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def set_path(tree: dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def unflatten(like: dict, new_leaves) -> dict:
    """A dict of ``like``'s structure holding ``new_leaves`` in order."""
    out: dict = {}
    for (path, _), leaf in zip(leaves_with_paths(like), new_leaves):
        set_path(out, path, leaf)
    return out


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """fn over the leaves of ``tree`` (and the matching leaves of
    ``rest``), same structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])
