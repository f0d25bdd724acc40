"""Param trees: nested dicts of tensors under the reference's key paths.

A model's params are what :func:`repro_torch.models.transformer.init_lm`
returns: the reference's tree (``embed``, ``blocks`` with a leading
layer axis, ``ln_f``, ...) with tensors for leaves.  The model functions
take the tree; :class:`LM` holds one as an ``nn.Module`` for
``.to(device)`` and ``state_dict()`` (keys are the key paths joined
with dots).  :func:`params_from_numpy` carries the reference's params
across: a tree of numpy arrays (``np.asarray`` of each ``jax.Array``)
becomes the same tree of tensors.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

from ..kernels.build import resolve_device


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (and of ``rest``, trees of
    the same structure)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree: a view of each leaf."""
    return tree_map(lambda t: t[i], tree)


def unstack(tree) -> list:
    """Every layer of a stacked tree, each a tree of views: one ``unbind``
    a leaf, so that a backward through all of them is one ``stack`` a
    leaf (a ``t[i]`` view's backward writes a zero tensor of the whole
    leaf, once a layer)."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    n = len(next(tree_leaves(parts)))
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


def flatten(tree) -> list:
    """The leaves in ``jax.tree.flatten``'s order: dict keys sorted,
    tuples (an ``OptState``) in field order.  Checkpoints number their
    leaves in this order, as the reference's do."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def unflatten(like, leaves):
    """``like``'s structure (key order, tuple types) with :func:`flatten`'s
    leaves put back in their places."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            got = {k: build(node[k]) for k in sorted(node)}
            return {k: got[k] for k in node}
        if isinstance(node, tuple):
            vals = [build(v) for v in node]
            return type(node)(*vals) if hasattr(node, "_fields") else \
                tuple(vals)
        return next(it)

    return build(like)


def to_tensor(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor on ``device`` with its dtype kept; a
    bfloat16 array (``ml_dtypes``) goes through its uint16 bits."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device="cuda"):
    """The reference's param tree (or any subtree), its leaves as numpy
    arrays, as the port's tree of tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: to_tensor(a, dev), tree)


class LM(nn.Module):
    """A param tree as a module: floating leaves are parameters (with no
    gradient: training takes the tree itself, see
    :mod:`repro_torch.train.train_loop`), integer leaves (int8 weights)
    buffers, sub-dicts child modules.  :meth:`tree` gives the dict back,
    on whatever device the module was moved to."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, LM(v))
            elif v.is_floating_point():
                self.register_parameter(k, nn.Parameter(
                    v, requires_grad=False))
            else:
                self.register_buffer(k, v)

    def tree(self) -> dict:
        out: dict = {}
        for k, v in self._parameters.items():
            out[k] = v.data
        out.update(self._buffers)
        for k, m in self._modules.items():
            out[k] = m.tree()
        return out

