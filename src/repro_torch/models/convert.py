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

from repro_torch.models.common import to_dtype

PyTree = Any


def _convert(tree: PyTree, device: torch.device, dtype: Optional[torch.dtype]):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device, dtype) for v in tree)
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
    """Reference cache tree (numpy leaves) -> the port's cache dict."""
    return params_from_numpy(tree, device=device, dtype=dtype)
