"""Nested dicts of tensors as the reference's pytrees: leaves in
`jax.tree_util` order (dict keys sorted, depth first), each named by its
`jax.tree_util.keystr` path (`['opt']['mu']['embed']['table']`), so that
norms sum in the reference's order and checkpoints carry its index; and
the cast of a tree's floating leaves (the reference's cast_tree)."""
from __future__ import annotations


def leaves_with_paths(tree, prefix: str = "") -> list:
    """[(keystr path, leaf)] in the reference's flatten order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in leaves_with_paths(tree[k], f"{prefix}['{k}']")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, flat) -> dict:
    """A tree of `like`'s structure holding `flat`, given in the order
    `leaves(like)` gives."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the same leaves of `rest`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def cast_tree(tree, dtype=None, device=None):
    """Floating leaves in `dtype` on `device` (None keeps each), the others
    on `device`. A leaf that already has both is returned as it is, not
    copied."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype, device) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device=device)
