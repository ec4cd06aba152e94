"""Flash attention, forward and backward: wrappers of the hand-written Hopper
kernels.

Replaces the Pallas TPU kernels of ``repro/kernels/flash_attention.py``:

* ``flash_attention_fwd`` (``_flash_kernel``) and ``flash_attention_fwd_stats``
  (``_flash_stats_kernel``, the same plus ``lse = m + log(max(l, 1e-30))``)
  -> ``csrc/flash_attention_fwd.cu``, one kernel with an optional ``lse``
  output;
* ``flash_attention_bwd``'s two kernels, dk/dv (``_flash_bwd_kernel``) and dq
  (``_flash_dq_kernel``) -> ``csrc/flash_attention_bwd.cu``.

The sources' headers say what each kernel keeps from the TPU kernel (online
softmax, fp32 statistics, the finite mask value, skipped tiles across the
diagonal) and what changes (each sequential grid axis becomes a loop inside
one thread block; the ragged edge is masked by the kernel; every output is
written by one block, so the gradients are deterministic).

Bound on an H100: the forward moves ``4*BH*S*hd*itemsize`` bytes and does
``4*BH*pairs*hd`` operations (``pairs`` = S(S+1)/2 when causal), which bound
it about equally in bf16; the backward's five products make it
operation-bound. bf16 inputs run the products on the tensor cores, fp32
accumulate, probabilities and dS rounded to bf16 for their products, all on
``wgmma`` fed by TMA rings: the forward's and dq's of K and V tiles, dk/dv's
of Q and dO tiles; no operand is transposed in shared memory. fp32 inputs
are multiplied on the CUDA cores in true fp32 (no TF32), as the reference
holds fp32 gradients to 1e-4.

``delta = sum_d dO * O`` stays plain torch ops (``bwd_delta``): the reference
computes it outside any Pallas call.

A tensor on the CPU takes the plain version beside each wrapper. A CUDA
tensor launches the kernel or raises; nothing falls back. Each wrapper counts
its launches in ``<wrapper>.launches``, and by kernel route in
``<wrapper>.launches_by_route`` (``FWD_ROUTES``, ``BWD_ROUTES``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 96, 128)
# the forward kernel by input type: bf16 on wgmma (TMA ring), fp32 on FMA
FWD_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "fma"}
# the backward kernels (dk/dv and dq) by input type, the same two routes
BWD_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "fma"}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_fns = {}


def _kernel(name: str):
    """(C function, error-string function) of one entry point."""
    if name not in _fns:
        lib_name, argtypes = {
            "flash_attention_fwd": ("flash_attention_fwd",
                                    [_P] * 5 + [_I] * 6 + [_F, _P]),
            "flash_attention_bwd_dkdv": ("flash_attention_bwd",
                                         [_P] * 8 + [_I] * 6 + [_F, _P]),
            "flash_attention_bwd_dq": ("flash_attention_bwd",
                                       [_P] * 7 + [_I] * 6 + [_F, _P]),
        }[name]
        lib = _build.load(lib_name)
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{lib_name}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns[name] = (fn, err)
    return _fns[name]


def _launch(name: str, q, *args) -> None:
    fn, err_str = _kernel(name)
    code = _build.call(fn, q.device, *args)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code} "
                           f"({err_str(code).decode()}) for q "
                           f"{tuple(q.shape)} {q.dtype}")


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be (BH, S, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"device mismatch: {q.device}, {k.device}, {v.device}")
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("sequence lengths must be at least 1")


def _check_bwd(q, k, v, dout, lse, delta):
    _check(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must match q: {tuple(dout.shape)} {dout.dtype} "
                         f"vs {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:2])} on "
                             f"{q.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def _on_cpu(q) -> bool:
    """CPU tensors take the plain version; CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return False


def _check_launch(tensors, hd: int, dtype: torch.dtype) -> None:
    """What the kernels take: fp32 or bf16, head dim in HEAD_DIMS, contiguous
    and 16-byte aligned (the fp32 kernels load 16 bytes a thread; a TMA
    descriptor of the bf16 ones takes 16-byte bases, and rows of hd * 2 >= 32
    bytes are whole 16-byte strides)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes head dim in {HEAD_DIMS}, got {hd}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             f"read 16-byte units)")


def _scale(scale, hd) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(hd)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def flash_attention_fwd_stats_plain(q, k, v, *, causal: bool = True,
                                    scale: Optional[float] = None,
                                    block_k: int = 128):
    """The forward in plain PyTorch: online softmax over KV blocks, fp32
    inside, the kernel's mask value, ``acc / max(l, 1e-30)`` and
    ``lse = m + log(max(l, 1e-30))``. q: (BH, Sq, hd); k, v: (BH, Sk, hd);
    returns (out (BH, Sq, hd) in q's dtype, lse (BH, Sq) fp32)."""
    _check(q, k, v)
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    qf = q.float() * _scale(scale, hd)
    rows = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((BH, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((BH, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, Sq, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, block_k):
        if causal and k0 > Sq - 1:
            break                      # every later block is above the diagonal
        kj = k[:, k0:k0 + block_k].float()
        vj = v[:, k0:k0 + block_k].float()
        s = torch.bmm(qf, kj.transpose(1, 2))
        if causal:
            cols = k0 + torch.arange(kj.shape[1], device=q.device)[None, :]
            s = torch.where((rows >= cols)[None], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.max(dim=-1).values)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.bmm(p, vj)
        m = m_new
    denom = l.clamp_min(1e-30)
    return (acc / denom[..., None]).to(q.dtype), m + torch.log(denom)


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              scale: Optional[float] = None,
                              block_k: int = 128):
    """``flash_attention_fwd_stats_plain`` without the statistics."""
    return flash_attention_fwd_stats_plain(q, k, v, causal=causal, scale=scale,
                                           block_k=block_k)[0]


def _fwd_kernel(q, k, v, causal, scale, with_lse: bool, wrapper):
    BH, Sq, hd = q.shape
    _check_launch((("q", q), ("k", k), ("v", v)), hd, q.dtype)
    out = torch.empty_like(q)
    lse = (torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if BH:
        _launch("flash_attention_fwd", q, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None,
                BH, Sq, k.shape[1], hd, _DTYPE_CODE[q.dtype],
                int(bool(causal)), _scale(scale, hd))
        wrapper.launches += 1
        wrapper.launches_by_route[FWD_ROUTES[q.dtype]] += 1
    return out, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None):
    """q: (BH, Sq, hd); k, v: (BH, Sk, hd), heads folded into the leading dim.

    CUDA tensors launch the kernel on the current stream (no synchronise);
    CPU tensors take ``flash_attention_fwd_plain``. The kernel takes fp32 and
    bf16, contiguous, head dim in ``HEAD_DIMS``; anything else raises.
    """
    _check(q, k, v)
    if _on_cpu(q):
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
    return _fwd_kernel(q, k, v, causal, scale, False, flash_attention_fwd)[0]


def flash_attention_fwd_stats(q, k, v, *, causal: bool = True,
                              scale: Optional[float] = None):
    """The forward plus the row statistics the backward needs: returns
    (out (BH, Sq, hd), lse (BH, Sq) fp32). The same kernel as
    ``flash_attention_fwd`` with its ``lse`` output on; counted apart."""
    _check(q, k, v)
    if _on_cpu(q):
        return flash_attention_fwd_stats_plain(q, k, v, causal=causal,
                                               scale=scale)
    return _fwd_kernel(q, k, v, causal, scale, True, flash_attention_fwd_stats)


flash_attention_fwd.launches = 0
flash_attention_fwd_stats.launches = 0
flash_attention_fwd.launches_by_route = dict.fromkeys(FWD_ROUTES.values(), 0)
flash_attention_fwd_stats.launches_by_route = dict.fromkeys(FWD_ROUTES.values(),
                                                            0)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------
def bwd_delta(out, dout):
    """delta = sum_d dO * O per row, fp32 (BH, Sq): plain torch ops, outside
    any kernel, as in the reference. The product promotes ``out`` to fp32
    inside the multiply, so only ``dout`` is copied to fp32 first: the same
    values as casting both, one pass over memory fewer."""
    return (dout.float() * out).sum(dim=-1)


def _bwd_block(qs, k, v, do, lse, delta, k0, block_k, causal):
    """p and dS of kv block [k0, k0 + block_k) against q rows r0.., where r0
    skips the rows wholly above the diagonal. Returns (r0, kj, p, ds)."""
    Sq = qs.shape[1]
    kj = k[:, k0:k0 + block_k].float()
    vj = v[:, k0:k0 + block_k].float()
    r0 = min(k0, Sq) if causal else 0
    s = torch.bmm(qs[:, r0:], kj.transpose(1, 2))
    if causal:
        rows = r0 + torch.arange(Sq - r0, device=qs.device)[:, None]
        cols = k0 + torch.arange(kj.shape[1], device=qs.device)[None, :]
        s = torch.where((rows >= cols)[None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[:, r0:, None])
    dp = torch.bmm(do[:, r0:], vj.transpose(1, 2))
    ds = p * (dp - delta[:, r0:, None])
    return r0, kj, p, ds


def flash_attention_bwd_dkdv_plain(q, k, v, dout, lse, delta, *,
                                   causal: bool = True,
                                   scale: Optional[float] = None,
                                   block_k: int = 128):
    """dk, dv in plain PyTorch, by kv blocks as ``_flash_bwd_kernel``:
    ``p = exp(q k^T * scale - lse)``, ``dV = p^T dO``,
    ``dK = (p * (dO v^T - delta))^T (q * scale)``; fp32 inside, outputs in
    k's and v's dtype."""
    _check_bwd(q, k, v, dout, lse, delta)
    qs = q.float() * _scale(scale, q.shape[2])
    do = dout.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for k0 in range(0, k.shape[1], block_k):
        r0, _, p, ds = _bwd_block(qs, k, v, do, lse, delta, k0, block_k, causal)
        dv[:, k0:k0 + block_k] = torch.bmm(p.transpose(1, 2), do[:, r0:])
        dk[:, k0:k0 + block_k] = torch.bmm(ds.transpose(1, 2), qs[:, r0:])
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, *,
                                 causal: bool = True,
                                 scale: Optional[float] = None,
                                 block_k: int = 128):
    """dq in plain PyTorch, as ``_flash_dq_kernel``: ``dQ = (sum over kv
    blocks of dS k) * scale``; fp32 inside, output in q's dtype."""
    _check_bwd(q, k, v, dout, lse, delta)
    sc = _scale(scale, q.shape[2])
    qs = q.float() * sc
    do = dout.float()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, k.shape[1], block_k):
        if causal and k0 > q.shape[1] - 1:
            break                      # every later block is above the diagonal
        r0, kj, _, ds = _bwd_block(qs, k, v, do, lse, delta, k0, block_k, causal)
        dq[:, r0:] += torch.bmm(ds, kj)
    return (dq * sc).to(q.dtype)


def _bwd_launch_args(q, k, v, dout, lse, delta, scale):
    BH, Sq, hd = q.shape
    _check_launch((("q", q), ("k", k), ("v", v), ("dout", dout),
                   ("lse", lse), ("delta", delta)), hd, q.dtype)
    return BH, Sq, k.shape[1], hd, _DTYPE_CODE[q.dtype], _scale(scale, hd)


def flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, *,
                             causal: bool = True,
                             scale: Optional[float] = None):
    """(dk, dv), each (BH, Sk, hd) in k's dtype, from the dk/dv kernel.
    ``lse`` from ``flash_attention_fwd_stats``, ``delta`` from ``bwd_delta``.
    CPU tensors take ``flash_attention_bwd_dkdv_plain``."""
    _check_bwd(q, k, v, dout, lse, delta)
    if _on_cpu(q):
        return flash_attention_bwd_dkdv_plain(q, k, v, dout, lse, delta,
                                              causal=causal, scale=scale)
    BH, Sq, Sk, hd, code, sc = _bwd_launch_args(q, k, v, dout, lse, delta, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if BH:
        _launch("flash_attention_bwd_dkdv", q, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, Sq, Sk,
                hd, code, int(bool(causal)), sc)
        flash_attention_bwd_dkdv.launches += 1
        flash_attention_bwd_dkdv.launches_by_route[BWD_ROUTES[q.dtype]] += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
                           scale: Optional[float] = None):
    """dq, (BH, Sq, hd) in q's dtype, from the dq kernel. CPU tensors take
    ``flash_attention_bwd_dq_plain``."""
    _check_bwd(q, k, v, dout, lse, delta)
    if _on_cpu(q):
        return flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta,
                                            causal=causal, scale=scale)
    BH, Sq, Sk, hd, code, sc = _bwd_launch_args(q, k, v, dout, lse, delta, scale)
    dq = torch.empty_like(q)
    if BH:
        _launch("flash_attention_bwd_dq", q, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), BH, Sq, Sk, hd, code,
                int(bool(causal)), sc)
        flash_attention_bwd_dq.launches += 1
        flash_attention_bwd_dq.launches_by_route[BWD_ROUTES[q.dtype]] += 1
    return dq


flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkdv.launches_by_route = dict.fromkeys(BWD_ROUTES.values(), 0)
flash_attention_bwd_dq.launches_by_route = dict.fromkeys(BWD_ROUTES.values(), 0)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        scale: Optional[float] = None):
    """Flash backward: (dq, dk, dv), as the reference's two pallas_calls.
    ``out`` and ``lse`` from ``flash_attention_fwd_stats``."""
    delta = bwd_delta(out, dout)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, causal=causal,
                                      scale=scale)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=causal,
                                scale=scale)
    return dq, dk, dv
