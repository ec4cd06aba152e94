"""Device meshes, the counterpart of ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names: ``("data", "model")`` for a pod, ``("pod", "data",
"model")`` across pods. Importing this module builds nothing and starts no
process group: every mesh is made inside a factory, and the device type is
always the caller's (``"cuda"`` for the card, ``"cpu"`` for the tests).

A mesh needs a default process group of exactly its size. ``make_host_mesh``
and ``make_production_mesh`` use the one the caller started (gloo on the
CPU, NCCL on the cards: ``init_world``). ``fake_world`` starts the other
kind the dry run uses: N ranks in one process (PyTorch's ``"fake"``
backend), this process being one of them (rank 0 unless asked). Its
collectives are dispatched with their true shapes but **not performed**:
their outputs hold whatever memory they were given, so a step run there has
that rank's local work and undefined values. Nothing that checks numbers
runs on it.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

POD_SHAPE = (16, 16)
POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def _mesh(device_type: str, shape: Sequence[int], axes: Sequence[str]):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= int(s)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of {n} "
            f"ranks: start one first (init_world, or fake_world for the dry "
            f"run's one-rank shard)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                           f"ranks; the process group has "
                           f"{dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 = 256 devices on ("data", "model"); ``multi_pod`` adds a
    leading "pod" axis (2 pods = 512 devices). Parameters never shard over
    "pod"."""
    if multi_pod:
        return _mesh(device_type, MULTI_POD_SHAPE, MULTI_POD_AXES)
    return _mesh(device_type, POD_SHAPE, POD_AXES)


def make_slice_mesh(shape: Tuple[int, int], axis_names: Tuple[str, str] = POD_AXES,
                    *, device_type: str = "cuda"):
    """A mesh over one ``StaticPartitioner`` slice's rectangle (rows x cols
    devices, the slice's process group)."""
    return _mesh(device_type, shape, axis_names)


def make_host_mesh(data: int = 1, model: int = 1, *, pod: Optional[int] = None,
                   device_type: str = "cpu"):
    """A small mesh for tests and examples over the caller's process group
    (gloo ranks on the CPU). ``pod`` adds the leading "pod" axis."""
    if pod is None:
        return _mesh(device_type, (data, model), POD_AXES)
    return _mesh(device_type, (pod, data, model), MULTI_POD_AXES)


def init_world(rank: int, world_size: int, init_method: str, *,
               device_type: str = "cpu", timeout_s: float = 120.0) -> None:
    """Start the real process group a mesh runs on: gloo for the CPU, NCCL
    for CUDA (each rank on its own card)."""
    import datetime
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A process group of ``world_size`` ranks in this one process, which is
    ``rank``, on PyTorch's ``"fake"`` backend: for the dry run only.

    Collectives are dispatched, so a counter sees each one at its shapes, but
    none is performed and their outputs are undefined. A step run here is
    that rank's shard of the step: its compute, its memory and its launches
    are those of one device of the mesh (a mesh built on the group gives the
    rank its coordinates: rank 15 of a 16 x 16 mesh is data 0, model 15, the
    last of a sequence split); its values are not. The group is destroyed on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running; the fake "
                           "world needs this process to itself")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not one of {world_size}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def is_fake_world() -> bool:
    """True inside ``fake_world``: collectives are not performed."""
    return dist.is_initialized() and dist.get_backend() == "fake"
