"""Nested dict/list parameter trees: leaves in the reference's order
(dict keys sorted, as ``jax.tree.leaves``; lists in order), a map, and
the flatten/unflatten pair the checkpoint and the weight stream use."""
from __future__ import annotations


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def unflatten(like, flat) -> object:
    """The tree of ``like``'s structure whose leaves, in ``leaves`` order,
    are ``flat``: the inverse of ``leaves``."""
    it = iter(flat)
    end = object()

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(x) for x in t]
        leaf = next(it, end)
        if leaf is end:
            raise ValueError("fewer leaves than the structure holds")
        return leaf

    out = build(like)
    if next(it, end) is not end:
        raise ValueError("more leaves than the structure holds")
    return out


def describe(tree) -> str:
    """The structure as text, leaves as ``*`` and dict keys sorted:
    ``{'opt': {'count': *, 'm': [*, *]}, 'step': *}``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(describe(t) for t in tree) + "]"
    return "*"


# ----------------------------------------------------------------------
# the reference's stacked layout of a per-layer parameter tree
# ----------------------------------------------------------------------
# the groups the reference stacks on a layer axis: every decoder-only
# family's ``blocks``, the hybrid's ``tail`` (its ``shared`` block is one
# unstacked dict there and here), the vlm's ``cross`` and the
# encoder-decoder's ``enc_blocks`` / ``dec_blocks``
STACKED = ("blocks", "tail", "cross", "enc_blocks", "dec_blocks")


def ref_groups(params: dict) -> list:
    """Each leaf of the reference's tree (each ``STACKED`` group one dict
    of stacked leaves), in its ``leaves`` order, as the port's tensors
    that make it up: the list of per-layer tensors of a stacked leaf (the
    group a per-layer list), or the one tensor of any other leaf."""
    out = []
    for k in sorted(params):
        v = params[k]
        if k in STACKED and isinstance(v, list):
            out += [list(g) for g in zip(*(leaves(layer) for layer in v))]
        else:
            out += leaves(v)
    return out


def ref_tree(params: dict, fn) -> dict:
    """The reference's tree structure over a per-layer ``params``: every
    leaf ``fn(group)`` of its ``ref_groups`` entry (a list of per-layer
    tensors for a stacked leaf, else the tensor)."""
    out = {}
    for k, v in params.items():
        out[k] = (tree_map(lambda *ts: fn(list(ts)), *v)
                  if k in STACKED and isinstance(v, list)
                  else tree_map(fn, v))
    return out
