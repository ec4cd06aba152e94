"""Streaming matmul: wrapper of the hand-written Hopper kernel.

Replaces ``repro/kernels/stream_matmul.py::stream_matmul`` (the Pallas TPU
kernel, body ``_stream_kernel``): ``x @ w`` with ``x`` resident and ``w`` one
memory tier down, K innermost, an fp32 accumulator, the result in
``x.dtype``. The kernel is ``csrc/stream_matmul.cu``.

On the TPU the tier below is a ``pinned_host`` placement that the Pallas
pipeline would pull through VMEM; here it is real: a ``w`` in pinned host
memory is streamed over the host link in K-panels (``block_k`` rows of K,
all of N) into a two-panel device ring by the copy engine on a side stream,
and the product of one panel runs on the caller's stream while the next
one is in flight. Every byte of ``w`` crosses the link once per call,
whatever M is, so the bound of a host ``w`` is ``K*N*w.element_size()``
bytes over the host link; a device ``w`` is bound by HBM (small M) or the
tensor cores (large M). bf16 ``x`` multiplies on the tensor cores
(``mma.sync``), fp32 ``x`` in true fp32 on the CUDA cores (no TF32).

``w`` is (K, N) with unit column stride, or the transposed view of an (N, K)
row-major table (``tok_embed.T`` of a tied unembedding): the layout is read
from the strides, and the kernel cuts the same K-panels out of the table
with a 2-D copy instead of transposing it on the host. ``w``'s dtype may
differ from ``x``'s; tiles are converted after loading, as the reference
casts ``w`` before its product.

CPU ``x`` with CPU ``w`` takes ``stream_matmul_plain``. CUDA ``x`` with
``w`` on the same device or in pinned host memory launches the kernel; an
unpinned host ``w`` raises (no silent pageable copy), and so does anything
else the kernel cannot take. ``stream_matmul.launches`` counts calls that
launched, ``stream_matmul.h2d_bytes`` the bytes of ``w`` streamed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _streamed

BLOCK_K = 512          # the reference's default panel depth
_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [_p, _ll, _i, _p, _ll, _i, _i, _i, _p, _p, _p, _i, _i, _i, _i, _p]


def _check(x, w):
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"x and w must be 2-D; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"inner dims differ: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    _streamed.check_dtypes(x, w)


def stream_matmul_plain(x, w):
    """The same function in plain PyTorch: fp32 product, cast to x's dtype."""
    _check(x, w)
    return (x.float() @ w.float()).to(x.dtype)


def _w_layout(w):
    """(w_nk, ldw): 0 for (K, N) with unit column stride, 1 for the
    transposed view of an (N, K) row-major table; raises otherwise."""
    K, N = w.shape
    if w.stride(1) == 1 or N == 1:
        return 0, (w.stride(0) if K > 1 else N)
    if w.stride(0) == 1 or K == 1:
        return 1, (w.stride(1) if N > 1 else K)
    raise ValueError(f"w must have a unit stride in one dim; strides "
                     f"{w.stride()}")


def stream_matmul(x, w, *, block_k: int = BLOCK_K):
    """x: (M, K) activations; w: (K, N) weights on x's device or in pinned
    host memory. Returns (M, N) in x's dtype on x's device."""
    _check(x, w)
    on_host = _streamed.w_on_host(x, w)
    if on_host is None:
        return stream_matmul_plain(x, w)
    if x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError("x must have a unit column stride")
    if block_k < 1:
        raise ValueError(f"block_k must be positive, got {block_k}")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    w_nk, ldw = _w_layout(w)
    ring, acc = _streamed.scratch(x, on_host,
                                  2 * min(block_k, K) * N * w.element_size(),
                                  (M, N) if K > block_k else None)
    code = _streamed.DTYPE_CODE
    _streamed.launch(
        "stream_matmul", _streamed.kernel("stream_matmul", _ARGTYPES), x,
        (x.data_ptr(), x.stride(0) if M > 1 else K, code[x.dtype],
         w.data_ptr(), ldw, code[w.dtype], w_nk, int(on_host),
         _streamed.ptr(ring), _streamed.ptr(acc), out.data_ptr(),
         M, N, K, block_k),
        lambda: f"x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)} {w.dtype} "
        f"on {w.device}")
    stream_matmul.launches += 1
    if on_host:
        stream_matmul.h2d_bytes += K * N * w.element_size()
    return out


stream_matmul.launches = 0
stream_matmul.h2d_bytes = 0
