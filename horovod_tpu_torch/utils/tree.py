"""Nested-dict pytrees of the port.

The port's parameter and gradient trees are nested ``dict``s of tensors.
These helpers walk them as ``jax.tree`` walks a dict: keys in sorted
order, so the i-th leaf here is the i-th leaf of the JAX tree with the
same keys. Anything that is not a ``dict`` is a leaf (``is_leaf`` widens
that, as in JAX).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

# A treedef is the tree itself with every leaf replaced by None.
TreeDef = Any


def tree_flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
                 ) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict) and not (is_leaf and is_leaf(node)):
            return {k: walk(node[k]) for k in sorted(node)}
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_leaves(tree: Any,
                is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Any]:
    return tree_flatten(tree, is_leaf)[0]


def tree_unflatten(treedef: TreeDef, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(treedef)
    if next(it, it) is not it:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def flatten_dict(tree: Mapping) -> Dict[Tuple[str, ...], Any]:
    """``{path: leaf}`` of a nested mapping (``flax.traverse_util``'s
    ``flatten_dict``): each path is the tuple of keys down to a leaf."""
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update({(k,) + p: leaf for p, leaf in flatten_dict(v).items()})
        else:
            out[(k,)] = v
    return out


def unflatten_dict(flat: Mapping[Tuple[str, ...], Any]) -> Dict:
    """The nested dict of :func:`flatten_dict`'s ``{path: leaf}``."""
    out: Dict = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching nodes of
    ``rest`` (which may be deeper there, as in ``jax.tree.map``)."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError(
                    f"tree_map: tree structures differ at keys "
                    f"{sorted(tree)}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    return fn(tree, *rest)
