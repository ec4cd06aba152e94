"""Grouped (per-expert) matmul: wrapper of the hand-written Hopper kernel.

Replaces ``repro/kernels/moe_gmm.py::grouped_matmul`` (the Pallas TPU
kernel, body ``_gmm_kernel``): ``out[e] = x[e] @ w[e]`` over ``(E, M, K) x
(E, K, N) -> (E, M, N)``, an fp32 accumulator, the result in ``x.dtype``.
The kernel is ``csrc/grouped_matmul.cu``; its header and
``csrc/tiled_matmul.cuh``'s say what bounds it on an H100 and what the
design does about that.

Beyond the TPU kernel, it takes any ``M``, ``K``, ``N`` (masked at the
edges: capacities such as 320 are no multiple of 128), an ``x`` with any
expert stride (0 for the MoE decode, where every expert reads the same
rows: ``x.expand(E, M, K)``) and row stride, a ``w`` with a unit stride in
either of its last two dims (``(K, N)`` row-major, or the transposed view of
an ``(N, K)`` one), and a ``w`` in pinned host memory (an expert stack the
offload plan spilled), which is streamed over the host link in panels
through a two-panel device ring, each byte once per call. ``w``'s dtype may
differ from ``x``'s; tiles are converted after loading, as the reference
casts ``w`` before its product.

``plan`` picks the kernel of a call by a shape and alignment rule: bf16
``x`` and ``w`` that a TMA descriptor can describe (16-byte-aligned bases,
strides in multiples of 8 elements) take the ``wgmma`` route; any other
bf16 ``x`` the ``mma_sync`` route; fp32 ``x`` the ``fma`` route.

CPU ``x`` with CPU ``w`` takes ``grouped_matmul_plain`` (with autograd).
CUDA ``x`` with ``w`` on the same device or in pinned host memory launches
the kernel; a pageable host ``w`` raises. A gradient wanted through a ``w``
on the device takes ``grouped_matmul_autograd``, whose backward is two more
launches of the same kernel, ``dx[e] = dy[e] @ w[e]^T`` (w's transposed view,
"nk") and ``dw[e] = x[e]^T @ dy[e]`` (x's transposed view, read by the
``wgmma`` route with A's transpose bit; fp32 or an unaligned x is copied
dense first, counted in ``transpose_bytes``). Neither copies a bf16
operand. A pinned ``w`` raises under autograd: training keeps
every weight on the device. ``grouped_matmul.launches`` counts calls that
launched, ``grouped_matmul.launches_by_route`` the same calls by route,
``grouped_matmul.h2d_bytes`` the bytes of ``w`` streamed; each launch's work
(``kernel_cost``) goes to a running step counter (``core.step_analysis``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _counter, _streamed
from repro_torch.kernels.ref import gmm_ref

# K rows of one streamed panel (whole experts if K fits): 8 of granite-moe's
# experts, an 8 MB copy; deeper panels reach the host link better than
# 2-expert ones (chip_smoke.py's grouped_matmul_panel_depths, PERF.md)
BLOCK_K = 8192
_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [_p, _ll, _ll, _i, _i, _p, _ll, _ll, _i, _i, _i, _i, _i, _i,
             _p, _p, _p, _i, _i, _i, _i, _i, _i, _p]
ROUTES = ("wgmma", "mma_sync", "fma")
_ROUTE_CODE = {"wgmma": 1, "mma_sync": 0, "fma": 0}


def _check(x, w):
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x (E, M, K) and w (E, K, N) must be 3-D; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} differ "
                         f"in experts or inner dim")
    _streamed.check_dtypes(x, w)


def kernel_cost(x, w, on_host: bool):
    """(flops, bytes, host_bytes) of one launch: ``2 E M K N`` product
    operations (those of the plain version's ``bmm``), x read once (a shared
    x, expert stride 0, once for all experts), the output written once, and
    w read once: from device memory, or for a pinned w over the host link
    (then its panels are written to and read from the device ring)."""
    E, M, K = x.shape
    N = w.shape[2]
    wb = _counter.tensor_bytes(w)
    out = E * M * N * x.element_size()
    nbytes = _counter.tensor_bytes(x) + out + (2 * wb if on_host else wb)
    return 2.0 * E * M * K * N, nbytes, wb if on_host else 0


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


class Plan(NamedTuple):
    """How one call runs: the kernel (``route``), its output tile
    (``block_m`` x ``block_n``, wgmma only, else 0), and for a pinned ``w``
    the streamed panel (``panel_experts`` whole experts, or ``panel_k`` rows
    of one; 0 for a ``w`` on the card)."""
    route: str
    block_m: int
    block_n: int
    panel_experts: int
    panel_k: int


@functools.lru_cache(maxsize=4096)
def plan(E: int, M: int, K: int, N: int, x_dtype, w_dtype,
         x_strides: Tuple[int, int], w_strides: Tuple[int, int], w_nk: bool,
         aligned: bool, on_host: bool, block_k: int,
         x_t: bool = False) -> Plan:
    """The route of a call, by shape and alignment, decided before launch
    (and remembered per call shape: a decode step repeats the same few
    shapes thousands of times, on a path bound by host time).

    ``x_strides`` (expert, row) and ``w_strides`` (expert, row) are the
    strides handed to the kernel, in elements; ``aligned``: the 16-byte
    alignment of x's base and, for a ``w`` on the card, of w's; ``block_k``
    the depth of a streamed panel (``panel_shape``). fp32 ``x`` -> ``fma``.
    bf16 ``x`` and ``w`` whose every stride is a multiple of 8 elements (16
    bytes, what a TMA descriptor takes) -> ``wgmma``, on 64 x 64 tiles for
    ``M <= 64`` (a decode: bound by w's bytes, so the most blocks) and
    128 x 128 above (a prefill). A pinned ``w`` is read from the dense ring
    slot, whose row stride is ``N`` ("kn") or the panel's depth ("nk"), and
    x at offsets of ``panel_k`` columns. Anything else bf16 ->
    ``mma_sync``. ``x_t``: x given as its transpose (M contiguous, the
    backward's ``x^T``), which only the ``wgmma`` route reads (A's transpose
    bit): bf16 x and "kn" w on the card, TMA-aligned, x not shared; anything
    else raises (``transposed_x`` copies such an x dense instead)."""
    if x_t:
        if not takes_transposed_x(x_dtype, w_dtype, x_strides, w_strides,
                                  w_nk, aligned, on_host):
            raise ValueError("a transposed x takes only the wgmma route: bf16 "
                             "x and 'kn' w on the card, TMA-aligned, x not "
                             "shared")
        bm, bn = (64, 64) if M <= 64 else (128, 128)
        return Plan("wgmma", bm, bn, 0, 0)
    pe, pk = panel_shape(E, K, block_k) if on_host else (0, 0)
    if x_dtype == torch.float32:
        return Plan("fma", 0, 0, pe, pk)
    strides = list(x_strides)
    if on_host:
        strides += [pk, K] if w_nk else [N]
        if pk < K:
            strides.append(pk)
    else:
        strides += list(w_strides)
    if (w_dtype != torch.bfloat16 or not aligned
            or any(s % 8 for s in strides)):
        return Plan("mma_sync", 0, 0, pe, pk)
    bm, bn = (64, 64) if M <= 64 else (128, 128)
    return Plan("wgmma", bm, bn, pe, pk)


def takes_transposed_x(x_dtype, w_dtype, x_strides, w_strides, w_nk: bool,
                       aligned: bool, on_host: bool) -> bool:
    """Whether the kernel reads an x given as its transpose (``plan``)."""
    return (x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16
            and aligned and not on_host and not w_nk and x_strides[0] != 0
            and not any(s % 8 for s in tuple(x_strides) + tuple(w_strides)))


def _x_layout(x):
    """(expert stride, row stride, x_t): x_t = 1 for x given as its
    transpose, a unit stride along M (the row stride is then K's)."""
    _, M, K = x.shape
    if x.stride(2) == 1 or K == 1:
        return x.stride(0), (x.stride(1) if M > 1 else K), 0
    if x.stride(1) == 1 or M == 1:
        return x.stride(0), x.stride(2), 1
    raise ValueError(f"x must have a unit stride in one of its last two "
                     f"dims; strides {x.stride()}")


def transposed_x(x, w):
    """``x.transpose(1, 2)`` as the kernel takes it for ``x^T @ w``: the
    view itself where ``plan`` sends it to the ``wgmma`` route, else (fp32,
    an unaligned buffer, a CPU tensor's plain product aside) a dense copy,
    counted in ``grouped_matmul.transpose_bytes``."""
    xt = x.transpose(1, 2)
    if not xt.is_cuda:
        return xt
    sxe, ldx, x_t = _x_layout(xt)
    w_nk, ldw = _w_layout(w)
    if x_t and takes_transposed_x(
            xt.dtype, w.dtype, (sxe, ldx), (w.stride(0), ldw), bool(w_nk),
            xt.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
            w.device.type == "cpu"):
        return xt
    xt = xt.contiguous()
    grouped_matmul.transpose_bytes += xt.numel() * xt.element_size()
    return xt


def _w_layout(w):
    """(w_nk, ldw): 0 for (K, N) slabs with a unit column stride, 1 for the
    transposed view of (N, K) row-major slabs; raises otherwise."""
    _, K, N = w.shape
    if w.stride(2) == 1 or N == 1:
        return 0, (w.stride(1) if K > 1 else N)
    if w.stride(1) == 1 or K == 1:
        return 1, (w.stride(2) if N > 1 else K)
    raise ValueError(f"w must have a unit stride in one of its last two "
                     f"dims; strides {w.stride()}")


class _GroupedMatmul(torch.autograd.Function):
    """out = ``product(x, w)``; the backward is ``product`` again on the
    transposed operands."""

    @staticmethod
    def forward(ctx, product, x, w):
        ctx.product = product
        ctx.save_for_backward(x, w)
        return product(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dx = ctx.product(dy, w.transpose(1, 2))
        if ctx.needs_input_grad[2]:
            dw = ctx.product(transposed_x(x, dy), dy)
        return None, dx, dw


def grouped_matmul_autograd(product, x, w):
    """``product(x, w)`` (the kernel on the card, ``_launch``; any function
    of ``grouped_matmul_plain``'s contract) as one autograd node whose
    backward computes ``dx`` and ``dw`` by ``product`` too."""
    return _GroupedMatmul.apply(product, x, w)


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
        if on_host:
            raise RuntimeError(
                "grouped_matmul streams a pinned expert stack with no "
                "backward; training keeps every weight on the device")
        return grouped_matmul_autograd(_launch, x, w)
    return _launch(x, w)


def _launch(x, w):
    """One launch of the kernel on ``grouped_matmul``'s arguments, checked
    by the caller (a CPU ``w`` beside CUDA ``x`` is a pinned one)."""
    on_host = w.device.type == "cpu"
    sxe, ldx, x_t = _x_layout(x)
    w_nk, ldw = _w_layout(w)
    E, M, K = x.shape
    N = w.shape[2]
    out = x.new_empty((E, M, N))
    if E == 0 or M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    xp, wp = x.data_ptr(), w.data_ptr()
    p = plan(E, M, K, N, x.dtype, w.dtype, (sxe, ldx), (w.stride(0), ldw),
             bool(w_nk), xp % 16 == 0 and (on_host or wp % 16 == 0), on_host,
             BLOCK_K, bool(x_t))
    ring, acc = _streamed.scratch(
        x, on_host, 2 * p.panel_experts * p.panel_k * N * w.element_size(),
        (M, N) if p.panel_k < K else None)
    code = _streamed.DTYPE_CODE
    _streamed.launch(
        "grouped_matmul", _streamed.kernel("grouped_matmul", _ARGTYPES), x,
        (xp, sxe, ldx, code[x.dtype], x_t, wp, w.stride(0), ldw, code[w.dtype],
         w_nk, int(on_host), _ROUTE_CODE[p.route], p.block_m, p.block_n,
         _streamed.ptr(ring), _streamed.ptr(acc), out.data_ptr(), E, M, N, K,
         p.panel_experts, p.panel_k),
        lambda: f"x {tuple(x.shape)} {x.dtype} strides {x.stride()}, "
        f"w {tuple(w.shape)} {w.dtype} strides {w.stride()} on {w.device}, "
        f"{p}")
    grouped_matmul.launches += 1
    grouped_matmul.launches_by_route[p.route] += 1
    if _counter.active is not None:
        _counter.record_kernel("grouped_matmul", p.route,
                               *kernel_cost(x, w, on_host))
    if on_host:
        grouped_matmul.h2d_bytes += E * K * N * w.element_size()
    return out


grouped_matmul.launches = 0
grouped_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
grouped_matmul.h2d_bytes = 0
grouped_matmul.transpose_bytes = 0
