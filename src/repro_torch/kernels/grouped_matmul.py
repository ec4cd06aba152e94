"""Grouped (per-expert) matmul: wrapper of the hand-written Hopper kernel.

Replaces ``repro/kernels/moe_gmm.py::grouped_matmul`` (the Pallas TPU
kernel, body ``_gmm_kernel``): ``out[e] = x[e] @ w[e]`` over ``(E, M, K) x
(E, K, N) -> (E, M, N)``, an fp32 accumulator, the result in ``x.dtype``.
The kernel is ``csrc/grouped_matmul.cu``; its header says what bounds it on
an H100 and what the design does about that.

Beyond the TPU kernel, it takes any ``M``, ``K``, ``N`` (masked at the
edges: capacities such as 320 are no multiple of 128), an ``x`` with any
expert stride (0 for the MoE decode, where every expert reads the same
rows: ``x.expand(E, M, K)``) and row stride, and a ``w`` in pinned host
memory (an expert stack the offload plan spilled), which is streamed over
the host link in panels through a two-panel device ring, each byte once per
call. ``w``'s dtype may differ from ``x``'s; tiles are converted after
loading, as the reference casts ``w`` before its product.

CPU ``x`` with CPU ``w`` takes ``grouped_matmul_plain`` (with autograd).
CUDA ``x`` with ``w`` on the same device or in pinned host memory launches
the kernel; a pageable host ``w`` raises, and so does a gradient wanted
through the kernel (it has no backward yet: ROADMAP queue A item 16).
``grouped_matmul.launches`` counts calls that launched,
``grouped_matmul.h2d_bytes`` the bytes of ``w`` streamed.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _streamed
from repro_torch.kernels.ref import gmm_ref

BLOCK_K = 2048         # K rows of one streamed panel (whole experts if K fits)
_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [_p, _ll, _ll, _i, _p, _ll, _ll, _i, _i, _p, _p, _p,
             _i, _i, _i, _i, _i, _i, _p]


def _check(x, w):
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x (E, M, K) and w (E, K, N) must be 3-D; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} differ "
                         f"in experts or inner dim")
    _streamed.check_dtypes(x, w)


def grouped_matmul_plain(x, w):
    """The same function in plain PyTorch (``ref.gmm_ref``): an fp32 product
    per expert, cast to x's dtype."""
    _check(x, w)
    return gmm_ref(x, w)


def panel_shape(E: int, K: int, block_k: int) -> Tuple[int, int]:
    """(experts, K rows) of one streamed panel: as many whole experts as fit
    ``block_k`` rows, else ``block_k`` rows of one expert."""
    if K <= block_k:
        return min(E, block_k // K), K
    return 1, block_k


def _unit_inner(t, name):
    if t.shape[2] > 1 and t.stride(2) != 1:
        raise ValueError(f"{name} must have a unit stride in its last dim; "
                         f"strides {t.stride()}")


def grouped_matmul(x, w):
    """x: (E, M, K) activations, any expert and row stride; w: (E, K, N)
    expert weights on x's device or in pinned host memory, streamed in
    panels of ``BLOCK_K`` rows. Returns (E, M, N) in x's dtype on x's
    device, contiguous."""
    _check(x, w)
    on_host = _streamed.w_on_host(x, w)
    if on_host is None:
        return grouped_matmul_plain(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "grouped_matmul's kernel has no backward yet (MoE training on the "
            "card is ROADMAP queue A item 16); run the expert products without "
            "autograd, or on the CPU")
    _unit_inner(x, "x")
    _unit_inner(w, "w")
    E, M, K = x.shape
    N = w.shape[2]
    out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    if E == 0 or M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    pe, pk = panel_shape(E, K, BLOCK_K)
    ring, acc = _streamed.scratch(x, on_host, 2 * pe * pk * N * w.element_size(),
                                  (M, N) if pk < K else None)
    code = _streamed.DTYPE_CODE
    _streamed.launch(
        "grouped_matmul", _streamed.kernel("grouped_matmul", _ARGTYPES), x,
        (x.data_ptr(), x.stride(0), x.stride(1) if M > 1 else K, code[x.dtype],
         w.data_ptr(), w.stride(0), w.stride(1) if K > 1 else N, code[w.dtype],
         int(on_host), _streamed.ptr(ring), _streamed.ptr(acc),
         out.data_ptr(), E, M, N, K, pe, pk),
        f"x {tuple(x.shape)} {x.dtype} strides {x.stride()}, "
        f"w {tuple(w.shape)} {w.dtype} on {w.device}")
    grouped_matmul.launches += 1
    if on_host:
        grouped_matmul.h2d_bytes += E * K * N * w.element_size()
    return out


grouped_matmul.launches = 0
grouped_matmul.h2d_bytes = 0
