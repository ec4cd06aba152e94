"""Mamba2 SSD chunked scan: wrapper of the hand-written Hopper kernel.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (the Pallas TPU kernel, body
``_ssd_kernel``). The kernel is ``csrc/ssd_scan.cu``; its header says what
bounds it on an H100 and what the design does about that.

Per chunk of ``CHUNK`` tokens, with ``cum`` the within-chunk cumulative sum of
``dt * A``: the intra-chunk output ``tril(C B^T * exp(cum_i - cum_j)) (x dt)``,
the carried state's contribution ``exp(cum_i) C state^T``, and the state
update ``state * exp(cum_last) + sum_j B_j exp(cum_last - cum_j) dt_j x_j``,
the ``(hp, N)`` state per head in fp32.

Beyond the TPU kernel, this one fulfils ``models.ssm.ssd_chunked``'s contract,
which the serving path needs: it starts from an optional ``init_state``,
returns the final state on request (the cache decode reads), and takes any
``S`` (rows past ``S`` are masked, which equals the reference's ``dt = 0``
padding). ``chunk`` and ``nh_block`` are the reference's arguments and are
kept for its signature; the kernel chooses its own tiles.

CPU tensors take ``ssd_scan_plain``, the same loop over chunks in PyTorch
ops. CUDA tensors launch the kernel on the current stream or raise; nothing
falls back. ``ssd_scan.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

CHUNK = 64            # the kernel's chunk length
P_TILE = 16           # head-dim columns of one thread block
MAX_STATE = 256       # largest N the kernel's shared memory takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("ssd_scan")
        fn = lib.ssd_scan
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 6 + [p]
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


def ssd_scan_plain(x, dt, A, B_, C_, *, chunk: int = CHUNK,
                   init_state: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """The kernel's function in plain PyTorch: a loop over chunks of
    ``chunk`` tokens with the fp32 state carried from one to the next, fp32
    inside, ``y`` in x's dtype. Rows past ``S`` in the last chunk get
    ``dt = 0``."""
    _check(x, dt, A, B_, C_, init_state)
    Bb, S, nh, hp = x.shape
    N = B_.shape[2]
    Af = A.float()
    state = (torch.zeros((Bb, nh, hp, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float().clone())
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        xc = x[:, s0:s0 + chunk].float()                      # (B,Q,nh,hp)
        dtc = dt[:, s0:s0 + chunk].float()                    # (B,Q,nh)
        Bc, Cc = B_[:, s0:s0 + chunk].float(), C_[:, s0:s0 + chunk].float()
        Q = xc.shape[1]
        cum = torch.cumsum(dtc * Af, dim=1)                   # (B,Q,nh)
        G = torch.einsum("bin,bjn->bij", Cc, Bc)              # (B,Q,Q)
        causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
        decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])  # (B,i,j,nh)
        M = torch.where(causal[None, :, :, None], G[..., None] * decay, 0.0)
        yc = torch.einsum("bijh,bjh,bjhp->bihp", M, dtc, xc)
        yc = yc + torch.einsum("bin,bhpn,bih->bihp", Cc, state, torch.exp(cum))
        y[:, s0:s0 + Q] = yc
        last = cum[:, -1]                                     # (B,nh)
        w = torch.exp(last[:, None, :] - cum) * dtc           # (B,Q,nh)
        state = (state * torch.exp(last)[:, :, None, None]
                 + torch.einsum("bjn,bjh,bjhp->bhpn", Bc, w, xc))
    y = y.to(x.dtype)
    return (y, state) if return_state else y


def _check_launch(tensors, x, B_):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes x in float32 or bfloat16, got {x.dtype}")
    for name, t in tensors:
        want = x.dtype if name in ("x", "B_", "C_") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want} (x is {x.dtype}); got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    hp, N = x.shape[3], B_.shape[2]
    if hp % P_TILE:
        raise ValueError(f"kernel takes hp a multiple of {P_TILE}, got {hp}")
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

    The kernel takes x in fp32 or bf16, every tensor contiguous, hp a
    multiple of 16 and N a multiple of 16 up to 256; anything else raises.
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
    else:
        fn, err_str = _kernel()
        code = _build.call(
            fn, x.device, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B_.data_ptr(), C_.data_ptr(),
            init_state.data_ptr() if init_state is not None else None,
            y.data_ptr(), state.data_ptr() if state is not None else None,
            Bb, S, nh, hp, N, _DTYPE_CODE[x.dtype])
        if code != 0:
            raise RuntimeError(
                f"ssd_scan launch failed: CUDA error {code} "
                f"({err_str(code).decode()}) for x {tuple(x.shape)} {x.dtype}, "
                f"N {N}")
        ssd_scan.launches += 1
    return (y, state) if return_state else y


ssd_scan.launches = 0
