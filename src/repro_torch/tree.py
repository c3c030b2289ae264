"""Trees of the port: nests of dicts, lists, tuples and ``NamedTuple``s
whose leaves are tensors (or numpy arrays); ``None`` is an empty subtree.

Leaves go in JAX's flatten order (dict keys sorted, sequences and a
``NamedTuple``'s fields in order), and :func:`flatten` also gives the
string JAX's ``tree_structure`` prints for the same nest, which the
checkpoint manifest keeps.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def flatten(tree) -> Tuple[List[Any], str]:
    """(leaves in JAX's flatten order, JAX's treedef string for the nest)."""
    leaves: List[Any] = []

    def walk(t) -> str:
        if isinstance(t, dict):
            keys = sorted(t)
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in keys) + "}"
        if _is_namedtuple(t):
            return f"CustomNode(namedtuple[{type(t).__name__}], [" \
                + ", ".join(walk(x) for x in t) + "])"
        if isinstance(t, (list, tuple)):
            inner = [walk(x) for x in t]
            if isinstance(t, list):
                return "[" + ", ".join(inner) + "]"
            return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") \
                + ")"
        if t is None:
            return "None"
        leaves.append(t)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def unflatten(like, new_leaves: List[Any]):
    """``like``'s nest with its leaves replaced, in flatten order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        if t is None:
            return None
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    nest in ``rest``."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others,
                                                    strict=True)])
