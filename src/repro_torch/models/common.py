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
    leaf's dim-role tuple as metadata; nothing is sharded.

    ``placement`` (leaf path -> memory kind, as ``core.offload.
    param_placement`` gives it from an offload plan) draws each leaf
    straight into its tier on a CUDA device: a host leaf is drawn by the
    same generator call on the device, copied into a pinned host buffer and
    its device copy freed before the next leaf, and a zeros / ones leaf is
    filled where it lives. Leaves come in the same order from the same
    generator calls, so the result is bit for bit an unplaced build moved
    by ``place_tree``, and the device holds at most the resident leaves and
    one host leaf in flight. On the CPU both tiers are one memory and the
    placement changes nothing."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device: torch.device, *, abstract: bool = False,
                 placement: Optional[Dict[str, str]] = None,
                 prefix: str = ""):
        self.cfg = cfg
        self.generator = generator
        self.device = torch.device("meta") if abstract else device
        self.abstract = abstract
        self.placement = placement
        self.prefix = prefix
        self.params: Dict[str, Any] = {}
        self.specs: Dict[str, Any] = {}

    def _on_host(self, name: str) -> bool:
        if self.placement is None:
            return False
        from repro_torch.core.offload import PINNED_HOST_KIND
        kind = self.placement[self.prefix + name]
        return self.device.type == "cuda" and kind == PINNED_HOST_KIND

    def add(self, name: str, shape: Tuple[int, ...], roles: Tuple[str, ...],
            *, scale: Optional[float] = None, init: str = "normal"):
        assert len(shape) == len(roles), (name, shape, roles)
        dtype = to_dtype(self.cfg.param_dtype)
        host = not self.abstract and self._on_host(name)
        if host:
            from repro_torch.core.offload import empty_host, to_host
        if self.abstract:
            arr = torch.empty(shape, dtype=dtype, device="meta")
        elif init in ("zeros", "ones"):
            arr = (empty_host(shape, dtype, self.device) if host else
                   torch.empty(shape, dtype=dtype, device=self.device))
            arr.fill_(0 if init == "zeros" else 1)
        else:
            if scale is None:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            arr = torch.empty(shape, dtype=dtype, device=self.device)
            arr.normal_(0.0, scale, generator=self.generator)
            if host:
                arr = to_host(arr, self.device)
        self.params[name] = arr
        self.specs[name] = tuple(roles)

    def child(self, name: str) -> "ParamBuilder":
        sub = ParamBuilder(self.cfg, self.generator, self.device,
                           abstract=self.abstract, placement=self.placement,
                           prefix=f"{self.prefix}{name}/")
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
    stream (e.g. pageable host memory). The kernel has no backward, so a
    streamed product that autograd would differentiate raises instead of
    losing the gradient.

    A 3-D ``w`` is an expert stack (E, d, f) with x (E, M, d) (any expert
    stride: 0 shares one x among the experts); the product per expert goes
    through ``grouped_matmul``, whose wrapper routes by placement the same
    way: the plain version on the CPU, the kernel on the card for a weight
    on the device or in pinned host memory (streamed), a raise for pageable
    host memory or a gradient wanted through a pinned stack. A stack on x's
    device is cast to x's dtype first, as the reference's einsum on
    ``w.astype(x.dtype)``: fp32 training parameters meet bf16 activations
    as one bf16 product (the ``wgmma`` route), and autograd carries the
    gradient back through the cast. A pinned stack is never cast on the
    host."""
    if w.dim() == 3:
        if w.device == x.device:
            w = w.to(x.dtype)
        return kops.grouped_matmul(x, w)
    if w.device == x.device:
        return x @ w.to(x.dtype)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "a weight placed apart from the activations is streamed through "
            "stream_matmul, which has no backward; training keeps every "
            f"weight on the activations' device (weight on {w.device}, "
            f"activations on {x.device})")
    out = kops.stream_matmul(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# tree helpers (nested dicts of tensors, keys in sorted order as the
# reference's pytree flattening gives them)
# ---------------------------------------------------------------------------
def cdtype(cfg: ModelConfig) -> torch.dtype:
    return to_dtype(cfg.dtype)


def tree_items(tree: PyTree):
    """(path component, child) pairs of one node in the reference's
    flattening order and names: dict keys sorted, NamedTuple fields in order
    as ``.name`` (how jax prints a ``GetAttrKey``), other sequence items by
    index. None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def rebuild(tree: PyTree, children) -> PyTree:
    """A node of ``tree``'s kind from new children in ``tree_items`` order:
    dicts keep ``tree``'s key order, NamedTuples their type."""
    children = list(children)
    if isinstance(tree, dict):
        built = dict(zip(sorted(tree), children))
        return {k: built[k] for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*children)
    return type(tree)(children)


def tree_leaves(tree: PyTree):
    items = tree_items(tree)
    if items is None:
        if tree is not None:
            yield tree
        return
    for _, child in items:
        yield from tree_leaves(child)


def tree_unflatten(like: PyTree, leaves) -> PyTree:
    """The inverse of ``tree_leaves``: ``like``'s structure (dicts, lists,
    tuples, NamedTuples; None stays None) with ``leaves`` taken in
    ``tree_leaves`` order. Dicts keep ``like``'s key order."""
    return _unflatten(like, iter(leaves))


def _unflatten(like: PyTree, it) -> PyTree:
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, which would keep ``leaves`` (a decode tick's
    # materialized KV cache) alive until the garbage collector runs
    items = tree_items(like)
    if items is None:
        return None if like is None else next(it)
    return rebuild(like, (_unflatten(child, it) for _, child in items))


def cast_tree(tree: PyTree, dtype) -> PyTree:
    """Floating leaves cast to ``dtype``; other leaves and the structure kept."""
    dtype = to_dtype(dtype)
    return tree_unflatten(tree, [
        x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point()
        else x for x in tree_leaves(tree)])


def tree_bytes(tree: PyTree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if hasattr(x, "dtype"))
