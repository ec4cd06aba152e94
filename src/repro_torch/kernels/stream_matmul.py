"""Streaming matmul: wrapper of the hand-written Hopper kernel.

Replaces ``repro/kernels/stream_matmul.py::stream_matmul`` (the Pallas TPU
kernel, body ``_stream_kernel``): ``x @ w`` with ``x`` resident and ``w`` one
memory tier down, K innermost, an fp32 accumulator, the result in
``x.dtype``. The kernel is ``csrc/stream_matmul.cu``; its header says what
bounds it on an H100 and what each route does about that.

On the TPU the tier below is a ``pinned_host`` placement that the Pallas
pipeline would pull through VMEM; here it is real. ``plan`` picks the route
of a call before the launch, from where ``w`` lives:

* ``ring``: ``w`` in pinned host memory. The copy engine moves panels,
  contiguous slabs of the host tensor (rows of K for (K, N) ``w``, rows of
  the table for a transposed (N, K) one; by default about ``PANEL_BYTES``
  a panel, ``panel_rows``), into a two-panel device ring on a side stream
  while the caller's stream multiplies the panel before. Every byte of
  ``w`` crosses the link once per call, whatever M is, so the bound of a
  host ``w`` is ``K*N*w.element_size()`` bytes over the host link.
* ``resident``: ``w`` on x's card, one launch over the whole K.

Products: bf16 operands a TMA descriptor takes on ``wgmma``, other bf16 on
``mma.sync``, fp32 ``x`` in true fp32 FMA (no TF32).

``w`` is (K, N) with unit column stride, or the transposed view of an (N, K)
row-major table (``tok_embed.T`` of a tied unembedding): the layout is read
from the strides, and the table is never transposed on the host. ``w``'s
dtype may differ from ``x``'s; values are converted after loading, as the
reference casts ``w`` before its product.

CPU ``x`` with CPU ``w`` takes ``stream_matmul_plain``. CUDA ``x`` with ``w``
on the same device or in pinned host memory launches the kernel; an
unpinned host ``w`` raises (no silent pageable copy), and so does anything
else the kernel cannot take. ``stream_matmul.launches`` counts calls that
launched, ``stream_matmul.launches_by_route`` the same calls by route,
``stream_matmul.h2d_bytes`` the bytes of ``w`` streamed; each launch's work
(``kernel_cost``) goes to a running step counter (``core.step_analysis``)
under the same route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _counter, _streamed

# bytes of w in one ring panel: each panel costs host work to issue and a
# drain of the copy engine between copies, so a decode (products next to
# free) gains from deep panels, while a prefill's last product, which no copy
# hides, grows with them (chip_smoke.py's stream_matmul_ring_depths, PERF.md)
PANEL_BYTES = 32 << 20
ROUTES = ("ring", "resident")
_ROUTE_CODE = {"resident": 0, "ring": 1}
_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [_p, _ll, _i, _p, _ll, _i, _i, _i, _i, _i, _p, _p, _p, _i, _i, _i,
             _i, _p]


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


def kernel_cost(x, w, on_host: bool):
    """(flops, bytes, host_bytes) of one launch: ``2 M K N`` product
    operations (the plain version's ``mm``), x read and the output written
    once, w read once from device memory, or for a pinned w over the host
    link (then its panels are written to and read from the device ring)."""
    M, K = x.shape
    N = w.shape[1]
    wb = K * N * w.element_size()
    nbytes = (M * K + M * N) * x.element_size() + (2 * wb if on_host else wb)
    return 2.0 * M * K * N, nbytes, wb if on_host else 0


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


def panel_rows(K: int, N: int, itemsize: int, w_nk: bool = False) -> int:
    """Rows of w's slab in one ring panel (rows of K for (K, N) ``w``, table
    rows for a transposed (N, K) one): about ``PANEL_BYTES``, a multiple of
    64 rows (so every panel's x offset stays a 16-byte multiple), at most
    the slab's rows."""
    rows, row_bytes = (N, K * itemsize) if w_nk else (K, N * itemsize)
    return min(rows, max(64, PANEL_BYTES // max(row_bytes, 1) // 64 * 64))


class Plan(NamedTuple):
    """How one call runs: the ``route``; the ``product`` kernel (``wgmma``,
    ``mma_sync`` or ``fma``); ``tile``, the wgmma output tile (64 or 128),
    else 0; ``panel``, the slab rows of a ring panel (``panel_rows``), else
    0."""
    route: str
    product: str
    tile: int
    panel: int


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, x_dtype, w_dtype, w_nk: bool, where: str,
         aligned: bool = True, block_k: Optional[int] = None) -> Plan:
    """The route of a call, by shape and placement, decided before launch
    (and remembered per call shape: a decode tick repeats a few shapes
    thousands of times, on a path bound by host time).

    ``where``: ``"pinned"`` (w in pinned host memory) or ``"device"``.
    ``aligned``: x's base is 16-byte aligned and its row stride a multiple of
    8 elements, and so are a device w's. A pinned w -> ``ring`` in panels of
    ``block_k`` slab rows (``panel_rows`` when None), a device w ->
    ``resident``, each on ``wgmma`` when x and w are bf16 and every operand a
    TMA descriptor must describe has 16-byte strides (a ring panel is read
    from its dense slot: row stride N for "kn", with x at offsets of the
    panel's depth; row stride K for "nk"), ``mma_sync`` for any other bf16
    x, ``fma`` for fp32 x. wgmma tiles are 64 x 64 for ``M <= 64``, 128 x
    128 above."""
    if where not in ("pinned", "device"):
        raise ValueError(f"where must be 'pinned' or 'device', got {where!r}")
    route = "ring" if where == "pinned" else "resident"
    bk = 0
    if route == "ring":
        itemsize = 2 if w_dtype == torch.bfloat16 else 4
        bk = (min(block_k, N if w_nk else K) if block_k
              else panel_rows(K, N, itemsize, w_nk))
    if x_dtype == torch.float32:
        return Plan(route, "fma", 0, bk)
    strides = []
    if route == "ring":
        strides = [K] if w_nk else [N, bk]
    if w_dtype != torch.bfloat16 or not aligned or any(s % 8 for s in strides):
        return Plan(route, "mma_sync", 0, bk)
    return Plan(route, "wgmma", 64 if M <= 64 else 128, bk)


def stream_matmul(x, w, *, block_k: Optional[int] = None):
    """x: (M, K) activations; w: (K, N) weights on x's device or in pinned
    host memory, streamed in panels of ``block_k`` rows (``panel_rows`` when
    None). Returns (M, N) in x's dtype on x's device."""
    _check(x, w)
    on_host = _streamed.w_on_host(x, w)
    if on_host is None:
        return stream_matmul_plain(x, w)
    if block_k is not None and block_k < 1:
        raise ValueError(f"block_k must be positive, got {block_k}")
    if x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError("x must have a unit column stride")
    M, K = x.shape
    N = w.shape[1]
    ldx = x.stride(0) if M > 1 else K
    w_nk, ldw = _w_layout(w)
    aligned = x.data_ptr() % 16 == 0 and ldx % 8 == 0
    if not on_host:
        aligned = aligned and w.data_ptr() % 16 == 0 and ldw % 8 == 0
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    p = plan(M, K, N, x.dtype, w.dtype, bool(w_nk),
             "pinned" if on_host else "device", aligned, block_k)
    ring, acc = None, None
    if p.route == "ring":
        rows, cols = (N, K) if w_nk else (K, N)
        panels = -(-rows // p.panel)
        ring, acc = _streamed.scratch(
            x, True, min(2, panels) * p.panel * cols * w.element_size(),
            (M, N) if panels > 1 else None)
    code = _streamed.DTYPE_CODE
    _streamed.launch(
        "stream_matmul", _streamed.kernel("stream_matmul", _ARGTYPES), x,
        (x.data_ptr(), ldx, code[x.dtype],
         w.data_ptr(), ldw, code[w.dtype], w_nk, _ROUTE_CODE[p.route],
         int(p.product == "wgmma"), p.tile, _streamed.ptr(ring),
         _streamed.ptr(acc), out.data_ptr(), M, N, K, p.panel),
        lambda: f"x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)} {w.dtype} "
        f"on {w.device}, {p}")
    stream_matmul.launches += 1
    stream_matmul.launches_by_route[p.route] += 1
    if _counter.active is not None:
        _counter.record_kernel("stream_matmul", p.route,
                               *kernel_cost(x, w, on_host))
    if on_host:
        stream_matmul.h2d_bytes += K * N * w.element_size()
    return out


stream_matmul.launches = 0
stream_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
stream_matmul.h2d_bytes = 0
