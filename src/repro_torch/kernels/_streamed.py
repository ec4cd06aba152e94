"""Host side shared by the two wrappers whose weight may be streamed from
pinned host memory, ``stream_matmul`` and ``grouped_matmul``: loading the
kernel's library, the checks of where x and w live, the device ring and
fp32 accumulator of the streamed route, and the launch with its error."""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fns: Dict[str, Tuple[Callable, Callable]] = {}


def kernel(name: str, argtypes: Sequence) -> Tuple[Callable, Callable]:
    """(entry point ``name``, ``name_error``) of ``csrc/<name>.cu``, built at
    first use; the entry point takes ``argtypes`` and returns a CUDA error
    code."""
    if name not in _fns:
        lib = _build.load(name)
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns[name] = (fn, err)
    return _fns[name]


def check_dtypes(x, w) -> None:
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")


def w_on_host(x, w) -> Optional[bool]:
    """None when x and w are both on the CPU (the plain version runs);
    otherwise whether w is streamed from pinned host memory (True) or read
    on x's card (False). Raises for any other placement: a pageable host w
    is never copied behind the caller's back."""
    if x.device.type == "cpu":
        if w.device.type != "cpu":
            raise ValueError(f"x on the CPU with w on {w.device}")
        return None
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    on_host = w.device.type == "cpu"
    if on_host and not w.is_pinned():
        raise ValueError("w is in pageable host memory: the kernel streams "
                         "only pinned host memory (place it with "
                         "core.offload.place_tree or pin_memory())")
    if not on_host and w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    return on_host


def scratch(x, on_host: bool, ring_bytes: int, acc_shape) -> Tuple:
    """(ring, acc) of the streamed route on x's card: ``ring_bytes`` of
    device memory for the panels in flight, and an fp32 buffer when a
    product spans several panels (``acc_shape`` not None). Both None for a
    device w."""
    if not on_host:
        return None, None
    ring = torch.empty(ring_bytes, dtype=torch.uint8, device=x.device)
    acc = (None if acc_shape is None else
           torch.empty(acc_shape, dtype=torch.float32, device=x.device))
    return ring, acc


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(name: str, fns: Tuple[Callable, Callable], x, args: Sequence,
           what: Callable[[], str]) -> None:
    """Calls the entry point with ``args`` and the current stream of x's
    card; a nonzero CUDA error code raises, naming ``what()`` was
    launched."""
    fn, err_str = fns
    code = _build.call(fn, x.device, *args)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code} "
                           f"({err_str(code).decode()}) for {what()}")
