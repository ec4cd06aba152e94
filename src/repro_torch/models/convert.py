"""Carrying weights and caches across from the reference.

The reference's parameter tree keeps its path names and stacked layouts in
the port, so a tree of numpy arrays (on the reference side:
``jax.tree_util.tree_map(np.asarray, params)``) becomes the port's nested
dict of tensors leaf by leaf. numpy has no bfloat16: the reference side
upcasts such leaves to float32 and names the target dtype here.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.common import rebuild, to_dtype, tree_items
from repro_torch.models.ssm import SSMCache

PyTree = Any


def _node_like(tree: PyTree) -> PyTree:
    """The port's node type for a reference node: a reference NamedTuple
    with the fields of ``SSMCache`` becomes the port's ``SSMCache`` (matched
    by field names, as the reference's class cannot be imported here);
    anything else keeps its type."""
    if hasattr(tree, "_fields") and tuple(tree._fields) == SSMCache._fields:
        return SSMCache(*tree)
    return tree


def _convert(tree: PyTree, device: torch.device, dtype: Optional[torch.dtype]):
    items = tree_items(tree)
    if items is not None:
        return rebuild(_node_like(tree),
                       (_convert(v, device, dtype) for _, v in items))
    t = torch.from_numpy(np.array(tree))   # a copy: the port writes in place
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: PyTree, *, device, dtype=None) -> PyTree:
    """Reference parameter tree (numpy leaves) -> the port's dict of tensors
    with identical paths. ``dtype`` (e.g. ``"bfloat16"``) casts floating
    leaves; None keeps each leaf's numpy dtype."""
    return _convert(tree, torch.device(device),
                    to_dtype(dtype) if dtype is not None else None)


def cache_from_numpy(tree: PyTree, *, device, dtype=None) -> PyTree:
    """Reference cache tree (numpy leaves) -> the port's cache dict; an SSM
    cache becomes the port's ``SSMCache``."""
    return params_from_numpy(tree, device=device, dtype=dtype)


def adamw_state_from_numpy(state, *, device):
    """Reference ``AdamWState`` with numpy leaves (``step`` int32, fp32
    moments) -> the port's ``AdamWState``, paths unchanged."""
    from repro_torch.optim.adamw import AdamWState
    step, mu, nu = state
    return AdamWState(step=torch.from_numpy(np.array(step, dtype=np.int32)).to(device),
                      mu=params_from_numpy(mu, device=device),
                      nu=params_from_numpy(nu, device=device))
