"""Mamba2 SSD chunked scan: wrapper of the hand-written Hopper kernels.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (the Pallas TPU kernel, body
``_ssd_kernel``). The kernels are ``csrc/ssd_scan.cu``; its header says what
bounds them on an H100 and what the design does about that.

Per chunk of ``CHUNK`` tokens, with ``cum`` the within-chunk cumulative sum of
``dt * A``: the intra-chunk output ``tril(C B^T * exp(cum_i - cum_j)) (x dt)``,
the carried state's contribution ``exp(cum_i) C h_c^T``, and the state
recurrence ``h_{c+1} = h_c * exp(cum_last) + S_c`` with the chunk's own state
``S_c = sum_j B_j exp(cum_last - cum_j) dt_j x_j``, the ``(hp, N)`` state per
head in fp32. The sequence dependence runs only through ``h``, so the scan
is three steps, each but the second parallel over chunks: ``chunk_states``,
``pass_states`` (the serial, elementwise pass), ``chunk_outputs``. The plain
version is those three functions; the kernels are one launch each, and the
wrapper allocates their scratch with one ``torch.empty`` a call (the chunk
states, fp32, ``B x nc x nh x hp x N``: 12.6 MB for mamba2-130m at 1024
tokens; the state entering each chunk, in x's type, as many; each chunk's
total decay).

Beyond the TPU kernel, this one fulfils ``models.ssm.ssd_chunked``'s contract,
which the serving path needs: it starts from an optional ``init_state``,
returns the final state on request (the cache decode reads), and takes any
``S`` (rows past ``S`` read as zero with ``dt = 0``, the reference's
padding). ``chunk`` and ``nh_block`` are the reference's arguments and are
kept for its signature; the kernels choose their own tiles.

CPU tensors take ``ssd_scan_plain``. CUDA tensors launch the kernels on the
current stream or raise; nothing falls back. ``ssd_scan.launches`` counts the
calls that launched them, and each call's work (``kernel_cost``) goes to a
running step counter (``core.step_analysis``) under the route ``mma_sync``
(the kernels' products are ``mma.sync``; they have no other route).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, _counter

CHUNK = 64            # the kernels' chunk length
MAX_STATE = 256       # largest N the kernels' shared memory takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("ssd_scan")
        fn = lib.ssd_scan
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 7 + [p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_error.argtypes = [ctypes.c_int]
        lib.ssd_scan_error.restype = ctypes.c_char_p
        _fn = (fn, lib.ssd_scan_error)
    return _fn


def _check(x, dt, A, B_, C_, init_state):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, nh, hp); got {tuple(x.shape)}")
    Bb, S, nh, hp = x.shape
    if tuple(dt.shape) != (Bb, S, nh):
        raise ValueError(f"dt must be {(Bb, S, nh)}; got {tuple(dt.shape)}")
    if tuple(A.shape) != (nh,):
        raise ValueError(f"A must be ({nh},); got {tuple(A.shape)}")
    if B_.dim() != 3 or tuple(B_.shape[:2]) != (Bb, S) or B_.shape != C_.shape:
        raise ValueError(f"B_ and C_ must be (B, S, N) with B, S of x; got "
                         f"{tuple(B_.shape)}, {tuple(C_.shape)}")
    N = B_.shape[2]
    if init_state is not None and tuple(init_state.shape) != (Bb, nh, hp, N):
        raise ValueError(f"init_state must be {(Bb, nh, hp, N)}; got "
                         f"{tuple(init_state.shape)}")
    tensors = [("x", x), ("dt", dt), ("A", A), ("B_", B_), ("C_", C_)]
    if init_state is not None:
        tensors.append(("init_state", init_state))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    return tensors


def _chunked(t, Q):
    """(B, S, ...) -> (B, nc, Q, ...), rows past S zero."""
    S = t.shape[1]
    pad = -S % Q
    if pad:
        t = torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], 1)
    return t.reshape(t.shape[0], (S + pad) // Q, Q, *t.shape[2:])


def chunk_states(x, dt, A, B_, chunk: int = CHUNK):
    """Step 1, parallel over chunks: each chunk's own state ``S_c`` (B, nc,
    nh, hp, N) fp32, as if it started from zero, and its total decay
    ``cum_last`` (B, nc, nh)."""
    xc, dtc, Bc = (_chunked(t.float(), chunk) for t in (x, dt, B_))
    cum = torch.cumsum(dtc * A.float(), dim=2)              # (B,nc,Q,nh)
    last = cum[:, :, -1]                                    # (B,nc,nh)
    w = torch.exp(last[:, :, None] - cum) * dtc             # (B,nc,Q,nh)
    return torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc, w, xc), last


def pass_states(S_c, last, init_state: Optional[torch.Tensor] = None):
    """Step 2, the only serial one, elementwise: ``h_{c+1} = h_c *
    exp(last_c) + S_c`` from ``init_state`` (zero when None). Returns the
    state entering every chunk (B, nc, nh, hp, N) and the final state."""
    h = (S_c.new_zeros((S_c.shape[0],) + tuple(S_c.shape[2:]))
         if init_state is None else init_state.float().clone())
    h_in = torch.empty_like(S_c)
    for c in range(S_c.shape[1]):
        h_in[:, c] = h
        h = h * torch.exp(last[:, c])[:, :, None, None] + S_c[:, c]
    return h_in, h


def chunk_outputs(x, dt, A, B_, C_, h_in, chunk: int = CHUNK):
    """Step 3, parallel over chunks: y (B, S, nh, hp) fp32, the intra-chunk
    output ``tril(C B^T o exp(cum_i - cum_j)) (dt x)`` plus the carried one
    ``exp(cum_i) C h_c^T``."""
    S = x.shape[1]
    xc, dtc, Bc, Cc = (_chunked(t.float(), chunk) for t in (x, dt, B_, C_))
    cum = torch.cumsum(dtc * A.float(), dim=2)              # (B,nc,Q,nh)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)             # (B,nc,Q,Q)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    M = torch.where(causal[None, None, :, :, None], G[..., None] * decay, 0.0)
    y = torch.einsum("bcijh,bcjh,bcjhp->bcihp", M, dtc, xc)
    y = y + torch.einsum("bcin,bchpn,bcih->bcihp", Cc, h_in, torch.exp(cum))
    return y.reshape(x.shape[0], y.shape[1] * chunk, *x.shape[2:])[:, :S]


def ssd_scan_plain(x, dt, A, B_, C_, *, chunk: int = CHUNK,
                   init_state: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """The kernels' function in plain PyTorch, in their three steps:
    ``chunk_states``, ``pass_states``, ``chunk_outputs``; fp32 inside, ``y``
    in x's dtype."""
    _check(x, dt, A, B_, C_, init_state)
    S_c, last = chunk_states(x, dt, A, B_, chunk)
    h_in, state = pass_states(S_c, last, init_state)
    y = chunk_outputs(x, dt, A, B_, C_, h_in, chunk).to(x.dtype)
    return (y, state) if return_state else y


def kernel_cost(x, B_, with_init: bool, with_state: bool):
    """(flops, bytes) of one call (three launches) at the kernels' chunk:
    ``C B^T`` once a (batch, chunk) over the pairs of each chunk's causal
    triangle (``2 N`` a pair), then per head the decay-weighted intra-chunk
    product (``2 hp`` a pair), each chunk's state and the carried state's
    output (``2 hp N`` a token each). Bytes: x, dt, A, B_, C_ (and an initial
    state) read once, y (and the final state) written once, and the scratch
    the launches hand on, written once and read once: the fp32 chunk states,
    the state entering each chunk (x's dtype), the chunks' decays."""
    Bb, S, nh, hp = x.shape
    N = B_.shape[2]
    Q = CHUNK
    pairs = sum(v * (v + 1) // 2 for v in (min(Q, S - c) for c in range(0, S, Q)))
    flops = 2.0 * Bb * pairs * N + 2.0 * Bb * nh * (pairs * hp + 2 * S * hp * N)
    nc = -(-S // Q)
    it = x.element_size()
    state = Bb * nh * hp * N * 4
    n_state = Bb * nc * nh * hp * N
    nbytes = (2 * x.numel() * it + 4 * Bb * S * nh + 4 * nh + 2 * B_.numel() * it
              + state * (int(with_init) + int(with_state))
              + 2 * n_state * (4 + it) + 2 * 4 * Bb * nc * nh)
    return flops, nbytes


def _check_launch(tensors, x, B_):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes x in float32 or bfloat16, got {x.dtype}")
    for name, t in tensors:
        want = x.dtype if name in ("x", "B_", "C_") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want} (x is {x.dtype}); got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name not in ("dt", "A") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    hp, N = x.shape[3], B_.shape[2]
    if hp % 16:
        raise ValueError(f"kernel takes hp a multiple of 16, got {hp}")
    if N % 16 or not 16 <= N <= MAX_STATE:
        raise ValueError(f"kernel takes N a multiple of 16 up to {MAX_STATE}, "
                         f"got {N}")


def ssd_scan(x, dt, A, B_, C_, *, chunk: int = 128,
             nh_block: Optional[int] = None,
             init_state: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """x: (B, S, nh, hp); dt: (B, S, nh) fp32, already softplus-ed; A: (nh,)
    fp32, negative; B_, C_: (B, S, N) in x's dtype; init_state: (B, nh, hp,
    N) fp32 or None (zero). Returns y (B, S, nh, hp) in x's dtype, or
    (y, final_state (B, nh, hp, N) fp32) with ``return_state``.

    The kernels take x in fp32 or bf16, every tensor contiguous (x, B_, C_
    and init_state 16-byte aligned), hp a multiple of 16 and N a multiple of 16 up to 256;
    anything else raises.
    """
    del nh_block
    tensors = _check(x, dt, A, B_, C_, init_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B_, C_, chunk=chunk,
                              init_state=init_state, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_launch(tensors, x, B_)
    Bb, S, nh, hp = x.shape
    N = B_.shape[2]
    y = torch.empty_like(x)
    state = (torch.empty((Bb, nh, hp, N), dtype=torch.float32, device=x.device)
             if return_state else None)
    if Bb * nh == 0 or S == 0:           # nothing to scan
        if state is not None and init_state is not None:
            state.copy_(init_state)
        elif state is not None:
            state.zero_()
        return (y, state) if return_state else y
    # one scratch allocation: the chunk states (fp32), the state entering
    # each chunk (x's dtype), each B x nc x nh x hp x N, and the chunks'
    # decays (fp32, B x nc x nh)
    nc = -(-S // CHUNK)
    n_state = Bb * nc * nh * hp * N
    h_off = 4 * n_state
    seg_off = h_off + -(-n_state * x.element_size() // 16) * 16
    scratch = torch.empty(seg_off + 4 * Bb * nc * nh, dtype=torch.uint8,
                          device=x.device)
    base = scratch.data_ptr()
    fn, err_str = _kernel()
    code = _build.call(
        fn, x.device, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B_.data_ptr(), C_.data_ptr(),
        init_state.data_ptr() if init_state is not None else None,
        y.data_ptr(), state.data_ptr() if state is not None else None,
        base, base + seg_off, base + h_off,
        # heads a block of the chunk kernels takes: two where nh allows, so
        # that a chunk's C B^T is computed once for both
        Bb, S, nh, hp, N, 2 if nh % 2 == 0 else 1, _DTYPE_CODE[x.dtype])
    if code != 0:
        raise RuntimeError(
            f"ssd_scan launch failed: CUDA error {code} "
            f"({err_str(code).decode()}) for x {tuple(x.shape)} {x.dtype}, "
            f"N {N}")
    ssd_scan.launches += 1
    if _counter.active is not None:
        _counter.record_kernel("ssd_scan", "mma_sync", *kernel_cost(
            x, B_, init_state is not None, return_state))
    return (y, state) if return_state else y


ssd_scan.launches = 0
