"""The hook by which a kernel wrapper reports a launch to the step counter.

The hand-written kernels are called through ``ctypes``, so the dispatcher
that ``core.step_analysis.count_step`` listens to never sees them. Each
launching wrapper therefore reports its launch here, with the work its
``kernel_cost`` formula gives. ``active`` is the counter of the running
``count_step`` (or None). A wrapper reads that one global and calls
``record_kernel`` only when it is set, so with no counter no cost is worked
out; its ``launches`` / ``launches_by_route`` counts are never touched from
here.
"""
from __future__ import annotations

active = None   # core.step_analysis._Counter while count_step runs


def tensor_bytes(t) -> int:
    """Bytes of the elements tensor ``t`` spans: each stride-0 (broadcast)
    dimension once, a view at the size of its window."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def record_kernel(name: str, route: str, flops: float, nbytes: float,
                  host_bytes: float = 0.0) -> None:
    """One launch of kernel ``name`` on ``route`` (the key the wrapper's
    ``launches_by_route`` counts it under): ``flops`` operations, ``nbytes``
    device-memory bytes, ``host_bytes`` bytes over the host link. Called
    only while a counter is ``active``."""
    active.record_kernel(name, route, flops, nbytes, host_bytes)
