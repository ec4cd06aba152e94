"""Counted cost of one eager step: the port's counterpart of
``repro/core/hlo_analysis.py`` (``analyze_hlo``).

The reference parses the compiled HLO of a step and sums its dot FLOPs, its
HBM traffic and its collective bytes, with the top cost sites named by the
ops' ``op_name`` metadata. The port runs eager, so ``count_step(fn, *args,
**kwargs) -> (result, StepCost)`` runs the step once under a
``TorchDispatchMode`` and counts the aten ops the step issues:

* **FLOPs** come from products only (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``), by ``torch.utils.flop_counter``'s formulas; the reference
  counts ``dot`` alone.
* **HBM bytes** are the tensor inputs plus outputs of every op that moves
  data. Aliasing ops (views, ``t``, ``permute``, ``expand``, ``slice``,
  ``select``, ``detach``) and allocations (``empty`` and its kin) count zero.
  A tensor counts each element it spans once: a broadcast (stride-0)
  dimension counts once, and a slice at the size of its window. A gather
  (``index``, ``index_select``, ``embedding``, ...) reads only its window, and
  an in-place scatter (``index_put_``, ``index_add_``, ``scatter_``, ...)
  writes only its update, twice its bytes as the reference's
  ``dynamic-slice`` / ``dynamic-update-slice``; a fill writes its output
  only, and a copy reads its source and writes its destination.
* A copy between the host and the card goes to ``host_bytes``, not to HBM.
* ``c10d`` ops count as collectives, under the reference's five names, by
  the bytes they write: the reference's per-chip convention (an HLO
  collective's result bytes), so an all-gather counts the gathered tensor,
  a reduce-scatter the shard it leaves, an all-reduce the whole tensor.
  The functional collectives ``DTensor`` issues on a mesh
  (``_c10d_functional.all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_reduce``) count the same way.
* On a mesh an op may reach the counter with ``DTensor`` operands (a
  parameter's layer slice, the accumulation of its gradient): it is counted
  at the local shards' sizes, the work of this rank.
* A **site** is the innermost frame under ``src/repro_torch/``
  (``models/attention.py:NNN attention_core``), the counterpart of HLO
  ``op_name`` metadata; an op of autograd's own backward formulas is named
  by its node (``(backward) MmBackward0``), one of the port's
  ``autograd.Function`` backwards by its frame. A loop in
  Python is counted once per pass, so no trip count is recovered.
* The hand-written kernels are called through ``ctypes`` and the dispatcher
  never sees them: each launching wrapper reports its launch through
  ``kernels._counter.record_kernel`` with the work of the ``kernel_cost``
  formula beside it, and that work is added to the totals and counted by
  kernel and route.

``count_step`` leaves its mode in a ``finally`` block; a counter started
inside another raises at once and leaves the outer one as it was.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field, replace
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _counter
from repro_torch.kernels._counter import tensor_bytes

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
TOP_K = 12

_aten = torch.ops.aten
_PRODUCTS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}
# aliasing ops whose schema carries no alias annotation
_ALIASES = {"_unsafe_view", "lift_fresh", "_reshape_alias", "view_as_real",
            "view_as_complex", "_conj", "_neg_view"}
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided", "empty_permuted"}
# no data moved: shape queries, scalars read back, bookkeeping
_NO_DATA = {"sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
            "is_same_size", "is_contiguous", "set_", "record_stream",
            "resize_", "_local_scalar_dense", "_has_compatible_shallow_copy_type"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "_unsafe_index"}
_SCATTERS = {"index_put_", "_index_put_impl_", "index_add_", "index_copy_",
             "scatter_", "scatter_add_", "scatter_reduce_", "index_fill_",
             "masked_scatter_"}
_WRITES_ONLY = {"fill_", "zero_", "normal_", "uniform_", "random_",
                "bernoulli_", "exponential_"}
_COPIES = {"copy_", "_to_copy", "_copy_from", "_copy_from_and_resize"}
_C10D = {"allreduce_": "all-reduce", "all_reduce": "all-reduce",
         "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_reduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_out": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "all_to_all_single": "all-to-all",
         "send": "collective-permute", "recv_": "collective-permute"}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_AUTOGRAD_DIR = os.sep + os.path.join("torch", "autograd") + os.sep
_SKIP_FILES = {os.path.abspath(__file__),
               os.path.abspath(_counter.__file__)}


@dataclass
class CostSite:
    """One source site: ``value`` (FLOPs or bytes) summed over the
    ``multiplier`` times the site issued work in the counted step."""
    op_name: str
    kind: str
    value: float
    multiplier: int


@dataclass
class StepCost:
    """The counted work of one step on one device (the fields of the
    reference's ``HloCost`` that ``roofline.analyze`` and the dry run read,
    and the hand-written kernels' share)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    host_bytes: float = 0.0
    ops: int = 0
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    kernel_launches: Dict[str, int] = field(default_factory=dict)
    kernel_launches_by_route: Dict[str, Dict[str, int]] = field(
        default_factory=dict)
    top_flops_sites: List[CostSite] = field(default_factory=list)
    top_bytes_sites: List[CostSite] = field(default_factory=list)
    top_collective_sites: List[CostSite] = field(default_factory=list)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def scaled(self, k: int) -> "StepCost":
        """The cost of ``k`` identical passes of this step."""
        sites = lambda ss: [replace(s, value=s.value * k,
                                    multiplier=s.multiplier * k) for s in ss]
        return StepCost(
            flops=self.flops * k, bytes_accessed=self.bytes_accessed * k,
            collective_bytes={n: b * k for n, b in self.collective_bytes.items()},
            collective_counts={n: c * k for n, c in self.collective_counts.items()},
            host_bytes=self.host_bytes * k, ops=self.ops * k,
            kernel_flops=self.kernel_flops * k,
            kernel_bytes=self.kernel_bytes * k,
            kernel_launches={n: c * k for n, c in self.kernel_launches.items()},
            kernel_launches_by_route={
                n: {r: c * k for r, c in rs.items()}
                for n, rs in self.kernel_launches_by_route.items()},
            top_flops_sites=sites(self.top_flops_sites),
            top_bytes_sites=sites(self.top_bytes_sites),
            top_collective_sites=sites(self.top_collective_sites))

    def __add__(self, other: "StepCost") -> "StepCost":
        def add(a: Dict, b: Dict) -> Dict:
            out = dict(a)
            for n, v in b.items():
                out[n] = out.get(n, 0) + v
            return out

        def merge(a: List[CostSite], b: List[CostSite]) -> List[CostSite]:
            by = {}
            for s in a + b:
                key = (s.op_name, s.kind)
                if key in by:
                    t = by[key]
                    by[key] = replace(t, value=t.value + s.value,
                                      multiplier=t.multiplier + s.multiplier)
                else:
                    by[key] = s
            return sorted(by.values(), key=lambda s: -s.value)[:TOP_K]

        routes = {n: dict(rs) for n, rs in self.kernel_launches_by_route.items()}
        for n, rs in other.kernel_launches_by_route.items():
            routes[n] = add(routes.get(n, {}), rs)
        return StepCost(
            flops=self.flops + other.flops,
            bytes_accessed=self.bytes_accessed + other.bytes_accessed,
            collective_bytes=add(self.collective_bytes, other.collective_bytes),
            collective_counts=add(self.collective_counts,
                                  other.collective_counts),
            host_bytes=self.host_bytes + other.host_bytes,
            ops=self.ops + other.ops,
            kernel_flops=self.kernel_flops + other.kernel_flops,
            kernel_bytes=self.kernel_bytes + other.kernel_bytes,
            kernel_launches=add(self.kernel_launches, other.kernel_launches),
            kernel_launches_by_route=routes,
            top_flops_sites=merge(self.top_flops_sites, other.top_flops_sites),
            top_bytes_sites=merge(self.top_bytes_sites, other.top_bytes_sites),
            top_collective_sites=merge(self.top_collective_sites,
                                       other.top_collective_sites))


def _local_of(x):
    """A ``DTensor``'s local shard; anything else as it is."""
    return getattr(x, "_local_tensor", x) if isinstance(x, torch.Tensor) else x


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _site() -> str:
    """The innermost frame under ``src/repro_torch/`` (this module and the
    kernel hook aside). An op that autograd's engine issues from its own
    backward formulas (the stack reaches ``torch/autograd`` first, or, on a
    device's engine thread, holds no frame of the port) is named by its node;
    the port's ``autograd.Function`` backwards and the forwards remat
    recomputes keep their frames."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG_DIR) and path not in _SKIP_FILES:
            return (f"{path[len(_PKG_DIR):]}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        if _AUTOGRAD_DIR in path:
            break
        f = f.f_back
    # autograd's engine: on the calling thread under torch/autograd, on a
    # device thread with no Python frame at all
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"(backward) {node.name()}"
    return "(outside repro_torch)"


class _Counter(TorchDispatchMode):
    """Counts every aten op of the step it wraps (see the module's rules)."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self._sites: Dict[Tuple[str, str], List[float]] = {}

    def _site_add(self, kind: str, value: float) -> None:
        entry = self._sites.setdefault((_site(), kind), [0.0, 0])
        entry[0] += value
        entry[1] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._account(func, args, kwargs, out)
        return out

    def _account(self, func, args, kwargs, out) -> None:
        if any(type(t) is not torch.Tensor and hasattr(t, "_local_tensor")
               for t in tree_leaves((args, kwargs, out))):
            args, kwargs, out = tree_map(_local_of, (args, kwargs, out))
        name = func._overloadpacket.__name__
        if func.namespace in ("c10d", "_c10d_functional", "c10d_functional"):
            kind = _C10D.get(name)
            if kind is not None:
                written = _tensors(out) or _tensors(args[:1])
                b = float(sum(tensor_bytes(t) for t in written))
                c = self.cost
                c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + b
                c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
                self._site_add(kind, b)
            return
        if (func.is_view or name in _ALIASES or name in _ALLOCATIONS
                or name in _NO_DATA):
            return
        self.cost.ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func._overloadpacket in _PRODUCTS:
            f = float(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
            self.cost.flops += f
            self._site_add("flops", f)
        if name in _COPIES:
            src = (args[1] if name == "copy_" else args[0]) if args else None
            dst = outs[0] if outs else None
            if (isinstance(src, torch.Tensor) and dst is not None
                    and (src.device.type == "cpu") != (dst.device.type == "cpu")):
                self.cost.host_bytes += tensor_bytes(src)
                return
            nbytes = sum(tensor_bytes(t) for t in ([src] if isinstance(
                src, torch.Tensor) else []) + outs[:1])
        elif name in _GATHERS:
            index = [t for t in ins if t is not args[0]]
            nbytes = (2 * sum(tensor_bytes(t) for t in outs)
                      + sum(tensor_bytes(t) for t in index))
        elif name in _SCATTERS:
            base = args[0]
            rest = [t for t in ins if t is not base]
            update = [t for t in rest if t.is_floating_point()]
            index = [t for t in rest if not t.is_floating_point()]
            nbytes = (2 * sum(tensor_bytes(t) for t in update)
                      + sum(tensor_bytes(t) for t in index))
        elif name in _WRITES_ONLY or name.endswith("_like"):
            nbytes = sum(tensor_bytes(t) for t in outs)
        else:
            nbytes = (sum(tensor_bytes(t) for t in ins)
                      + sum(tensor_bytes(t) for t in outs))
        if nbytes:
            self.cost.bytes_accessed += nbytes
            self._site_add("bytes", float(nbytes))

    def record_kernel(self, name: str, route: str, flops: float,
                      nbytes: float, host_bytes: float) -> None:
        c = self.cost
        c.flops += flops
        c.bytes_accessed += nbytes
        c.host_bytes += host_bytes
        c.kernel_flops += flops
        c.kernel_bytes += nbytes
        c.kernel_launches[name] = c.kernel_launches.get(name, 0) + 1
        routes = c.kernel_launches_by_route.setdefault(name, {})
        routes[route] = routes.get(route, 0) + 1
        if flops:
            self._site_add("flops", flops)
        if nbytes:
            self._site_add("bytes", nbytes)

    def result(self) -> StepCost:
        by_kind: Dict[str, List[CostSite]] = {}
        for (site, kind), (value, n) in self._sites.items():
            by_kind.setdefault(kind, []).append(CostSite(site, kind, value, n))
        top = lambda ss: sorted(ss, key=lambda s: -s.value)[:TOP_K]
        c = self.cost
        c.top_flops_sites = top(by_kind.pop("flops", []))
        c.top_bytes_sites = top(by_kind.pop("bytes", []))
        c.top_collective_sites = top([s for ss in by_kind.values() for s in ss])
        return c


def count_step(fn, *args, **kwargs):
    """Runs ``fn(*args, **kwargs)`` once, counting its work; returns
    ``(result, StepCost)``. Counters do not nest: one started while another
    runs raises at once."""
    if _counter.active is not None:
        raise RuntimeError("count_step is already counting a step; counters "
                           "do not nest")
    counter = _Counter()
    _counter.active = counter
    try:
        with counter:
            result = fn(*args, **kwargs)
    finally:
        _counter.active = None
    return result, counter.result()
