"""Maps over the port's nested NamedTuples of tensors (Board, EnvState,
MoveSet, noise records): JAX's ``tree_map`` for the few places that need
one."""
from __future__ import annotations

from typing import List

import torch


def tmap(fn, tree):
    """``fn`` on every tensor of a tensor or a nested NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(tmap(fn, x) for x in tree))


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tensor or a nested NamedTuple, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in leaves(x)]


def copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the same field of ``dst``."""
    for d, s in zip(leaves(dst), leaves(src)):
        d.copy_(s)
