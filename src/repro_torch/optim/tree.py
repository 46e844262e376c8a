"""Trees of tensors: what the optimizer, the compression hook and the
checkpoints map over.

A tree is a tensor (a leaf), a mapping of trees, or an ``nn.Module``,
which stands for the flat mapping of its parameters by name
(``named_parameters()``: ``"layers.0.attn.wq"``, ...).  Trees the port
builds from a module (grads, AdamW moments, residuals) are such flat
dicts keyed by parameter name; ``models.convert.params_to_numpy`` stacks
them back into the reference's layout.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping

import torch
from torch import nn


def as_mapping(tree: Any) -> Any:
    """A module as the dict of its parameters by name; anything else as
    it is."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` on each leaf of ``tree`` and the leaves at the same place in
    ``rest``; a nested dict of the results (a module becomes its flat
    dict)."""
    tree = as_mapping(tree)
    rest = [as_mapping(r) for r in rest]
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves in the tree's own order."""
    tree = as_mapping(tree)
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_field(tree: Any, i: int) -> Any:
    """Field ``i`` of each tuple leaf of a tree that ``tree_map`` built
    with a function returning tuples."""
    if isinstance(tree, Mapping):
        return {k: tree_field(v, i) for k, v in tree.items()}
    return tree[i]
