"""Flash-attention forward: wrapper of the hand-written Hopper kernel.

Replaces ``repro/kernels/flash_attention.py::flash_attention_fwd`` (the Pallas
TPU kernel). The kernel is ``csrc/flash_attention_fwd.cu``; its header says
what it keeps from the TPU kernel (online softmax, fp32 running max / sum /
accumulator, finite mask value, skipped tiles above the diagonal) and what it
changes (the sequential KV grid axis becomes a loop inside one thread block,
the ragged edge is masked by the kernel).

Bound on an H100: the function moves ``4*BH*S*hd*itemsize`` bytes and does
about ``2*BH*S^2*hd`` operations when causal; in bf16 the two bound it about
equally at the serving shapes, in fp32 the operations do. bf16 inputs run both
products on the tensor cores (``mma.sync``, fp32 accumulate, probabilities
rounded to bf16 for the second product); fp32 inputs are multiplied on the
CUDA cores in true fp32 (no TF32), register-tiled so that shared-memory
traffic stays below the FMA rate. ``wgmma``, TMA and overlapping loads with
products are a later step behind the same interface.

A tensor on the CPU takes the plain version below. A CUDA tensor launches the
kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention_fwd")
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_fwd_error.argtypes = [ctypes.c_int]
        lib.flash_attention_fwd_error.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_fwd_error)
    return _fn


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


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              scale: Optional[float] = None,
                              block_k: int = 128):
    """The same function in plain PyTorch: online softmax over KV blocks,
    fp32 inside, the kernel's mask value and final ``acc / max(l, 1e-30)``.
    q: (BH, Sq, hd); k, v: (BH, Sk, hd); returns (BH, Sq, hd) in q's dtype."""
    _check(q, k, v)
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.float() * scale
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
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None):
    """q: (BH, Sq, hd); k, v: (BH, Sk, hd), heads folded into the leading dim.

    CUDA tensors launch the kernel on the current stream (no synchronise);
    CPU tensors take ``flash_attention_fwd_plain``. The kernel takes fp32 and
    bf16, contiguous, head dim in ``HEAD_DIMS``; anything else raises.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes head dim in {HEAD_DIMS}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"loads 16 bytes a thread)")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    if BH == 0:
        return out
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  BH, Sq, Sk, hd, _DTYPE_CODE[q.dtype], int(bool(causal)),
                  float(scale), stream)
    if code != 0:
        raise RuntimeError(
            f"flash_attention_fwd launch failed: CUDA error {code} "
            f"({err_str(code).decode()}) for q {tuple(q.shape)} {q.dtype}")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
