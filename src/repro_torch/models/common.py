"""Parameter construction and tree helpers.

One device holds everything in the port, so of the reference's mesh machinery
(``AxisEnv``, ``ShardingPolicy``, ``role_axis``) nothing is needed: an explicit
``device`` takes the place of the mesh. ``ParamBuilder`` still keeps each
parameter's dim roles beside its shape (the ``specs`` tree) as inert
metadata for a later multi-device slice. Names, shapes, stacking and init
scales are the reference's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def to_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (config strings) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU; asking
    for CUDA without a card raises here instead of degrading."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return device


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------
class ParamBuilder:
    """Builds parallel (params, specs) nested dicts. ``specs`` holds each
    leaf's dim-role tuple as metadata; nothing is sharded."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device: torch.device, *, abstract: bool = False):
        self.cfg = cfg
        self.generator = generator
        self.device = torch.device("meta") if abstract else device
        self.abstract = abstract
        self.params: Dict[str, Any] = {}
        self.specs: Dict[str, Any] = {}

    def add(self, name: str, shape: Tuple[int, ...], roles: Tuple[str, ...],
            *, scale: Optional[float] = None, init: str = "normal"):
        assert len(shape) == len(roles), (name, shape, roles)
        dtype = to_dtype(self.cfg.param_dtype)
        if self.abstract:
            arr = torch.empty(shape, dtype=dtype, device="meta")
        elif init == "zeros":
            arr = torch.zeros(shape, dtype=dtype, device=self.device)
        elif init == "ones":
            arr = torch.ones(shape, dtype=dtype, device=self.device)
        else:
            if scale is None:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            arr = torch.empty(shape, dtype=dtype, device=self.device)
            arr.normal_(0.0, scale, generator=self.generator)
        self.params[name] = arr
        self.specs[name] = tuple(roles)

    def child(self, name: str) -> "ParamBuilder":
        sub = ParamBuilder(self.cfg, self.generator, self.device,
                           abstract=self.abstract)
        self.params[name] = sub.params
        self.specs[name] = sub.specs
        return sub


# ---------------------------------------------------------------------------
# using a parameter wherever the offload plan placed it
# ---------------------------------------------------------------------------
def weight_matmul(x, w):
    """``x @ w`` for a weight in either tier. On x's device it is the
    reference's ``x @ w.astype(x.dtype)``. A weight left in (pinned) host
    memory beside CUDA activations is streamed through the ``stream_matmul``
    kernel with x flattened to 2-D: it is neither cast on the host nor copied
    whole, and its bytes cross the host link once per call. The route
    follows where the tensor lives; the wrapper raises on what it cannot
    stream (e.g. pageable host memory)."""
    if w.device == x.device:
        return x @ w.to(x.dtype)
    out = kops.stream_matmul(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# tree helpers (nested dicts of tensors, keys in sorted order as the
# reference's pytree flattening gives them)
# ---------------------------------------------------------------------------
def cdtype(cfg: ModelConfig) -> torch.dtype:
    return to_dtype(cfg.dtype)


def tree_leaves(tree: PyTree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from tree_leaves(item)
    elif tree is not None:
        yield tree


def tree_bytes(tree: PyTree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if hasattr(x, "dtype"))
