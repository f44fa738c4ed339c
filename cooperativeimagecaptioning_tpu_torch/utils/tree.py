"""Nested-dict param trees between numpy and torch.

The JAX package keeps parameters as nested dicts of arrays; the port keeps
the same dicts with torch tensors at the leaves.  Checkpoints on disk hold
numpy leaves (training/checkpoint.py), so `to_torch` and `to_numpy` are the
whole bridge: a JAX tree put through `np.asarray` and `to_torch` is the
port's tree, leaf for leaf.  `ParamTree` holds such a tree inside an
nn.Module; `trainable` makes a tree's leaves parameters that take
gradients (the Trainer's tree).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def to_torch(tree, device, dtype=None):
    """numpy (or array-like) leaves -> torch tensors on `device`.

    `dtype`, when given, applies to floating leaves only; integer leaves keep
    their type.
    """
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree
    else:
        t = torch.from_numpy(np.array(tree))  # a writable host copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy(tree):
    """torch tensors -> numpy arrays (host copies: a later in-place update
    of a tensor does not reach them).

    numpy has no bfloat16, so bf16 leaves widen to float32, which is exact.
    """
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    return tree


class ParamTree(nn.Module):
    """A tree of tensors as an nn.Module: each sub-dict becomes a child
    module and each leaf a parameter under its own key.  So `p.core.i2h.w`
    is the leaf tree['core']['i2h']['w'], `state_dict()` names it
    'core.i2h.w', and `.to(device, dtype)` moves the tree and casts its
    floating leaves (the JAX service's compute-dtype rule casts the f32
    leaves, serving.py:62-64; a speaker tree has no other floating leaves).

    A leaf that is already an nn.Parameter (a tree from `trainable`) is
    held as it is, the same object, so gradients reach the caller's tree;
    any other leaf becomes a frozen parameter (requires_grad=False), as the
    service holds its speaker.
    """

    def __init__(self, tree: dict):
        super().__init__()
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(key, ParamTree(leaf))
            elif isinstance(leaf, nn.Parameter):
                self.register_parameter(key, leaf)
            else:
                self.register_parameter(
                    key, nn.Parameter(leaf, requires_grad=False))


def trainable(tree):
    """The same tree with every leaf an nn.Parameter that requires grad
    (sharing the leaf's storage)."""
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items()}
    return nn.Parameter(tree.detach(), requires_grad=True)


def leaves(tree, prefix=""):
    """[(path, leaf)] of a nested dict in a fixed (sorted) order, paths
    joined with '.'."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def from_leaves(pairs):
    """The nested dict of [(path, leaf)] pairs, the inverse of `leaves`."""
    tree = {}
    for path, leaf in pairs:
        node = tree
        *parents, last = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree
