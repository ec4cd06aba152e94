"""Builds the CUDA sources under ``csrc/`` at first use, loads them, and
calls their entry points on the current stream.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``<build dir>/<name>-<hash>.so``, compiled by ``nvcc`` for
``sm_90a`` and loaded with ``ctypes``. The hash covers the source text, the
shared headers ``csrc/*.cuh`` and the compiler flags, so an edited source or
header is rebuilt and an unchanged one is reused. All sources that still
need building are compiled in parallel, one ``nvcc`` process each.

The build directory is ``build/repro_torch_kernels/`` under the root of the
checkout (override with ``REPRO_TORCH_BUILD_DIR``). Nothing is built when the
package is imported; there is no fallback when ``nvcc`` is missing or a
source does not compile — the caller gets the error and the command tried.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}     # name -> what nvcc printed (ptxas -v)


def build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    return None


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library; returns
    name -> library path. Raises RuntimeError naming the command on failure."""
    targets = {src.stem: _target(src) for src in sources()}
    todo = [src for src in sources() if not targets[src.stem].exists()]
    if not todo:
        return targets
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH, $CUDA_HOME, /usr/local/cuda); "
            f"cannot run: nvcc {' '.join(NVCC_FLAGS)} -o <lib>.so "
            f"{' '.join(str(s) for s in todo)}")
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        out = targets[src.stem]
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, cmd,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, out, tmp, cmd, proc in procs:
        text, _ = proc.communicate()
        build_log[src.stem] = text
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{text}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent process sees all or none
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if needed)."""
    if name not in _libs:
        targets = build_all()
        if name not in targets:
            raise KeyError(f"no kernel source csrc/{name}.cu")
        _libs[name] = ctypes.CDLL(str(targets[name]))
    return _libs[name]


def call(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` with ``stream`` the raw handle of ``device``'s
    current stream, ``device`` made current only when it is not already.
    Reading the handle without building a ``torch.cuda.Stream`` and skipping
    a needless device switch saves more host time than a decode-sized kernel
    takes on the card."""
    idx = device.index
    if idx is None:
        idx = torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(idx):
        return fn(*args, stream)
