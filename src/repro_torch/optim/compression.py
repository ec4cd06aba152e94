"""Gradient compression for the cross-pod reduction, the counterpart of
``repro/optim/compression.py``.

int8 block quantization along the last dim with error feedback: the
quantization residual is added back into the next step's gradient, so the
optimizer stays unbiased in expectation (EF-SGD). The arithmetic is the
reference's: blocks of ``BLOCK`` values along the last dim (zero-padded),
one fp32 scale a block (its largest magnitude / 127, plus 1e-12), values
rounded half to even and clipped to [-127, 127].

``cross_pod_sync`` takes the place of the reference's ``shard_map`` over the
mesh's ``"pod"`` axis: the pods are the ranks of a ``torch.distributed``
process group, or of a ``DeviceMesh``'s ``"pod"`` group (each rank syncing
its local shards of ``DTensor`` gradients). With no group, a group of one
rank, or a mesh without a ``"pod"`` axis, it returns its inputs, as the
reference does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import (is_dtensor, shard_local, tree_leaves,
                                       tree_unflatten)

PyTree = Any
BLOCK = 256  # quantization block (last-dim groups)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 along the last dim. Returns (q (..., nblk,
    BLOCK) int8, scale (..., nblk, 1) fp32); a 0-d x is taken as (1,)."""
    xf = x.float()
    if xf.dim() == 0:
        xf = xf[None]
    pad = (-xf.shape[-1]) % BLOCK
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    blocks = xf.reshape(xf.shape[:-1] + (xf.shape[-1] // BLOCK, BLOCK))
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    size: int) -> torch.Tensor:
    """The fp32 values of ``quantize_int8``'s output, cut back to
    ``shape`` (``size``, its element count, is kept for the reference's
    signature)."""
    del size
    full = q.float() * scale
    full = full.reshape(full.shape[:-2] + (full.shape[-2] * BLOCK,))
    last = shape[-1] if len(shape) else 1
    if full.shape[-1] != last:
        full = full[..., :last]
    return full.reshape(tuple(shape))


def compress_residual(x: torch.Tensor, err: torch.Tensor):
    """Error-feedback quantization: ((q, scale) of x + err, the new error
    (x + err) - dequantized)."""
    target = x.float() + err
    q, s = quantize_int8(target)
    deq = dequantize_int8(q, s, tuple(x.shape), x.numel())
    return (q, s), target - deq


def init_error_feedback(grads_like: PyTree) -> PyTree:
    """Zero fp32 error-feedback state in the structure of the gradients
    (``DTensor``s laid out as theirs)."""
    return tree_unflatten(grads_like, [
        torch.zeros_like(g, dtype=torch.float32) if is_dtensor(g) else
        torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for g in tree_leaves(grads_like)])


def _sync_leaf(g, e, group, npods: int, compress: bool):
    if is_dtensor(g):
        out, new_e = _sync_leaf(g.to_local(), e.to_local(), group, npods,
                                compress)
        wrap = lambda t, like: shard_local(t, like.shape, like.placements,
                                           like.device_mesh)
        return wrap(out, g), wrap(new_e, e)
    if not compress:
        out = g.clone()
        dist.all_reduce(out, group=group)
        return out / npods, e
    (q, s), new_e = compress_residual(g, e)
    q_all = [torch.empty_like(q) for _ in range(npods)]
    s_all = [torch.empty_like(s) for _ in range(npods)]
    dist.all_gather(q_all, q.contiguous(), group=group)
    dist.all_gather(s_all, s.contiguous(), group=group)
    total = sum(dequantize_int8(qi, si, tuple(g.shape), g.numel())
                for qi, si in zip(q_all, s_all))
    return (total / npods).to(g.dtype), new_e


def cross_pod_sync(grads: PyTree, err: PyTree, group=None, *,
                   compress: bool = True) -> Tuple[PyTree, PyTree]:
    """Mean of ``grads`` over the ranks of ``group`` (the pods): a process
    group, or a ``DeviceMesh`` whose ``"pod"`` group is taken.

    ``compress=True``: each rank quantizes its gradient plus its error
    feedback to int8, all ranks all-gather the int8 payload and the scales,
    and each sums the dequantized copies locally: 4x fewer bytes than an fp32
    all-reduce. Returns (the mean, the new error feedback). ``compress=False``:
    an all-reduce mean, ``err`` returned as it came. With no group, or one of
    one rank, both are returned as they came."""
    if group is not None and hasattr(group, "mesh_dim_names"):
        if "pod" not in (group.mesh_dim_names or ()):
            return grads, err
        group = group.get_group("pod")
    npods = 1 if group is None else dist.get_world_size(group)
    if npods <= 1:
        return grads, err
    out = [_sync_leaf(g, e, group, npods, compress)
           for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(err, [o[1] for o in out]))

