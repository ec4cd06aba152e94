"""KVPool — slot-paged KV/state pool with planner-driven host placement.

The pool owns a fixed ``(slots, max_seq)`` cache tree plus the slot free list
and per-slot lengths. Placement is where the paper's §VI-A mechanism becomes
real: an ``OffloadPlan`` maps onto the pool leaf by leaf across two physical
tiers —

* fully offloaded leaves live whole in pinned host memory;
* *partially* spilled leaves are physically split along the sequence axis
  into a device-resident hot prefix and a pinned-host cold tail;
* everything else stays in device memory.

Decode consumes ``materialize()`` (host parts copied to the device, tails
concatenated back on), updates that tree in place, and hands it to
``update()``, which writes cold tails and host leaves back into the **same
pinned buffers** — the DMA round trip of the offload path, executed eagerly
on the current stream. ``paste()`` writes a prefill prefix straight into the
tiers a slot's rows live in, so admitting a request moves only that
request's bytes.

SSM caches (``SSMCache``: the conv window in the pool's dtype, the state in
fp32) have no sequence axis: a spilled one lives whole in the tier the
majority of its bytes were planned for, and ``paste`` overwrites the slot.
Sequence leaves are known by their path (``k``, ``v``), not by their shape
alone: the reference takes any leaf whose dim 2 equals ``max_seq`` for one,
so an SSM state with as many heads as ``max_seq``, or an enc-dec cross K/V
(``cross_k``, ``cross_v``: ``encoder_seq`` frames) when ``max_seq`` equals
``encoder_seq``, would be pasted only in part there. Here the cross leaves
are placed and pasted whole, like an SSM cache, whatever ``max_seq`` is.

When the engine runs on the CPU (the tests), both tiers are plain CPU memory
and the split changes nothing physically; every placement path still runs.

On a mesh (a model built on a ``DeviceMesh``) the pool is this rank's shard
of the cache, each leaf laid out by ``model.cache_specs(slots)``: the slots
over the batch axes, and over the model axis the KV heads or the sequence.
The placement decisions are the reference's on its mesh, taken on each
leaf's global bytes, and a leaf is split into a hot prefix and a pinned cold
tail only where its spec leaves the sequence axis whole, or splits it only
over axes of size 1 (``_spec_allows_seq_split``); elsewhere a partial spill
rounds the leaf to its majority tier. The tensors the pool keeps are this
rank's local shards: ``materialize`` / ``update`` move local shards only and
hand the model ``DTensor``s over them. ``device_bytes`` / ``host_bytes``
report the global sizes the reference reports (a JAX array's size is
global); ``local_device_bytes`` / ``local_host_bytes`` this rank's.
``paste`` gathers a prefill's prefix whole over the sequence (one request's
tokens), and each rank writes the part of it that falls in its part of the
pool, on the rank whose batch shard holds the slot.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.offload import (OffloadPlan, _flatten_with_paths,
                                      empty_host, memory_kind_of)
from repro_torch.models.common import (AxisEnv, local, placements,
                                       shard_local, spec_axes, to_dtype,
                                       tree_unflatten)
from repro_torch.models.model_zoo import _spec_leaves

PyTree = Any

SEQ_AXIS = 2  # layer-stacked caches: (L, slots, seq, heads, head_dim)
SEQ_LEAVES = ("k", "v")   # the leaves that have one (not the cross K/V)


def _has_seq_axis(path: str, leaf, max_seq: int) -> bool:
    return (path.rsplit("/", 1)[-1] in SEQ_LEAVES and leaf.dim() > SEQ_AXIS
            and leaf.shape[SEQ_AXIS] == max_seq)


def _spec_allows_seq_split(spec, env: Optional[AxisEnv]) -> bool:
    """Splitting the seq axis needs that axis unsharded in the leaf spec
    (or sharded only over mesh axes of size 1, where the cut is still a
    whole-shard boundary): the reference's rule."""
    if len(spec) <= SEQ_AXIS or spec[SEQ_AXIS] is None:
        return True
    if env is None:
        return False
    return all(env.axis_sizes.get(a, 1) == 1
               for a in spec_axes(spec[SEQ_AXIS]))


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when ``a`` is ``b`` or a view of all of it (a ``DTensor``'s local
    tensor over a pool leaf)."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride())


def _seq_cut(shape, n: int) -> Tuple[int, ...]:
    """``shape`` with its sequence axis ``n`` long."""
    return tuple(shape[:SEQ_AXIS]) + (n,) + tuple(shape[SEQ_AXIS + 1:])


class KVPool:
    def __init__(self, model, slots: int, max_seq: int, *, device=None,
                 plan: Optional[OffloadPlan] = None, offload_all: bool = False,
                 dtype=torch.bfloat16, prefix: str = "kv"):
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.device = torch.device(model.device if device is None else device)
        self.prefix = prefix
        # the mesh whose cache this pool is one rank's shard of (None: one
        # device, where every local shard is the whole leaf)
        self.env = model.env if model.sharded else None
        self.positions = np.zeros(slots, np.int32)   # per-slot cache length
        self._free: List[int] = list(range(slots))
        # each leaf keeps the dtype ``init_cache`` gives it: ``dtype`` for KV
        # and conv windows, fp32 for SSM states; global shapes
        self._like = model.cache_shapes(slots, max_seq, to_dtype(dtype))
        shapes = _flatten_with_paths(self._like)
        self._paths = [p for p, _ in shapes]
        self._seq = [_has_seq_axis(p, leaf, max_seq) for p, leaf in shapes]
        self._global = [tuple(leaf.shape) for _, leaf in shapes]
        specs = ([None] * len(shapes) if self.env is None
                 else list(_spec_leaves(model.cache_specs(slots))))
        self._pl = [None if sp is None else placements(sp, self.env)
                    for sp in specs]
        # global index of each local shard's first entry
        self._offset: List[Tuple[int, ...]] = []

        self._hot: List[torch.Tensor] = []            # device part, or the
        self._cold: Dict[int, torch.Tensor] = {}      #   whole host leaf
        self._hot_len: Dict[int, int] = {}            # split leaves only
        self._host_leaves: Set[int] = set()           # fully host-placed
        # traffic counters (bytes), for whoever measures the link
        self.h2d_bytes = 0          # materialize: host -> device
        self.d2h_bytes = 0          # update: device -> host write-back
        self.paste_host_bytes = 0   # paste: prefix rows written to host
        self._writeback: Optional[torch.cuda.Event] = None

        for i, (path, meta) in enumerate(shapes):
            full_path = f"{prefix}/{path}" if prefix else path
            splittable = self._seq[i] and (
                specs[i] is None or _spec_allows_seq_split(specs[i], self.env))
            kind, hot_len = self._decide(full_path, meta, splittable, plan,
                                         offload_all)
            shape, offset = self._local_shape(i)
            shape, dt = list(shape), meta.dtype
            self._offset.append(offset)
            if kind == "host":
                self._host_leaves.add(i)
                leaf = empty_host(shape, dt, self.device).zero_()
            elif kind == "split":
                self._hot_len[i] = hot_len
                shape[SEQ_AXIS] = max_seq - hot_len
                self._cold[i] = empty_host(shape, dt, self.device).zero_()
                shape[SEQ_AXIS] = hot_len
                leaf = torch.zeros(shape, dtype=dt, device=self.device)
            else:
                leaf = torch.zeros(shape, dtype=dt, device=self.device)
            self._hot.append(leaf)

    def _local_shape(self, i: int):
        """(shape, global offset) of this rank's shard of leaf ``i``."""
        if self.env is None:
            return self._global[i], (0,) * len(self._global[i])
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        shape, offset = compute_local_shape_and_global_offset(
            self._global[i], self.env.mesh, self._pl[i])
        return tuple(shape), tuple(offset)

    def _wrap(self, i: int, x: torch.Tensor):
        """Leaf ``i``'s local tensor as the model takes it: itself on one
        device, the ``DTensor`` over it on a mesh."""
        if self.env is None:
            return x
        return shard_local(x, self._global[i], self._pl[i], self.env.mesh)

    # ------------------------------------------------------------------
    def _decide(self, full_path: str, leaf, splittable: bool,
                plan: Optional[OffloadPlan],
                offload_all: bool) -> Tuple[str, int]:
        """('device'|'host'|'split', hot_len) for one leaf (its global
        bytes)."""
        if offload_all or (plan is not None and plan.is_offloaded(full_path)):
            return "host", 0
        if plan is None:
            return "device", 0
        spilled = dict(plan.partial).get(full_path)
        if not spilled:
            return "device", 0
        frac = min(1.0, spilled / _nbytes(leaf))
        if splittable:
            cold = min(self.max_seq - 1, max(1, math.ceil(frac * self.max_seq)))
            return "split", self.max_seq - cold
        # no seq axis to cut (state caches), or one the mesh splits: round
        # to the majority side
        return ("host", 0) if frac >= 0.5 else ("device", 0)

    # ------------------------------------------------------------------
    # slot management (the "paged" part — one page per request slot)
    # ------------------------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    def alloc_slot(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def free_slot(self, slot: int) -> None:
        self.positions[slot] = 0
        self._free.append(slot)

    # ------------------------------------------------------------------
    # cache access
    # ------------------------------------------------------------------
    def _wait_writeback(self) -> None:
        """Host buffers are read again only after the last write-back landed."""
        if self._writeback is not None:
            self._writeback.synchronize()
            self._writeback = None

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        self.h2d_bytes += _nbytes(host)
        return host.to(self.device, non_blocking=True)

    def materialize(self) -> PyTree:
        """Full cache tree on the compute device: host leaves copied over,
        cold tails concatenated back on. Device-resident leaves are returned
        as they are, so an in-place decode step updates the pool directly.
        On a mesh, each leaf is the ``DTensor`` over this rank's local
        shard."""
        self._wait_writeback()
        leaves = []
        for i, hot in enumerate(self._hot):
            if i in self._cold:
                leaf = torch.cat([hot, self._to_device(self._cold[i])],
                                 dim=SEQ_AXIS)
            elif i in self._host_leaves:
                leaf = self._to_device(hot)
            else:
                leaf = hot
            leaves.append(self._wrap(i, leaf))
        return tree_unflatten(self._like, leaves)

    def update(self, new_cache: PyTree) -> None:
        """Absorb a decode-updated cache tree: hot prefixes are copied back
        into the device-resident part, cold tails and host leaves are written
        back into their pinned buffers (asynchronously, on the current
        stream). A device-resident leaf that was updated in place is already
        the pool's own tensor."""
        leaves = [local(leaf) for _, leaf in _flatten_with_paths(new_cache)]
        if len(leaves) != len(self._hot):
            raise ValueError("cache structure changed")
        wrote_host = False
        for i, leaf in enumerate(leaves):
            if i in self._cold:
                hot_len = self._hot_len[i]
                self._hot[i].copy_(leaf.narrow(SEQ_AXIS, 0, hot_len))
                tail = leaf.narrow(SEQ_AXIS, hot_len, self.max_seq - hot_len)
                self._cold[i].copy_(tail, non_blocking=True)
                self.d2h_bytes += _nbytes(self._cold[i])
                wrote_host = True
            elif i in self._host_leaves:
                self._hot[i].copy_(leaf, non_blocking=True)
                self.d2h_bytes += _nbytes(self._hot[i])
                wrote_host = True
            elif not _same_memory(leaf, self._hot[i]):
                self._hot[i].copy_(leaf)
        if wrote_host and self.device.type == "cuda":
            self._writeback = torch.cuda.Event()
            self._writeback.record()

    def paste(self, slot: int, prefix_cache: PyTree, plen: int) -> None:
        """Write a prefill prefix into one slot (the admit path), in place:
        each tier receives the rows of the prefix that live in it, rounded to
        the leaf's dtype (an SSM state stays fp32). On a mesh the prefix (a
        one-request prefill's cache, laid out for its own ``plen``
        positions) is first gathered whole over the batch and the sequence;
        the rank whose batch shard holds ``slot`` then writes the positions
        of ``[0, plen)`` that fall in its part of the pool."""
        self._wait_writeback()
        prefs = [leaf for _, leaf in _flatten_with_paths(prefix_cache)]
        if len(prefs) != len(self._hot):
            raise ValueError("cache structure changed")
        for i, pref in enumerate(prefs):
            pool = self._hot[i]
            pref = self._whole_prefix(i, pref)
            row = slot - self._offset[i][1]
            if not 0 <= row < pool.shape[1]:
                continue      # the slot lives on another rank's batch shard
            pref = pref.to(pool.dtype)
            rows = slice(row, row + 1)
            if i in self._cold:
                n_hot = min(plen, self._hot_len[i])
                pool[:, rows, :n_hot].copy_(pref[:, :, :n_hot])
                if plen > n_hot:
                    self._cold[i][:, rows, :plen - n_hot].copy_(
                        pref[:, :, n_hot:plen])
                    self.paste_host_bytes += _nbytes(pref[:, :, n_hot:plen])
            elif self._seq[i]:
                # this rank's positions [lo, lo + S_local) of the sequence
                lo = self._offset[i][SEQ_AXIS]
                hi = min(plen, lo + pool.shape[SEQ_AXIS])
                if hi <= lo:
                    continue
                pool[:, rows, :hi - lo].copy_(pref[:, :, lo:hi])
                if i in self._host_leaves:
                    self.paste_host_bytes += _nbytes(pref[:, :, lo:hi])
            else:  # state caches: (L, B, ...) — overwrite the slot
                pool[:, rows].copy_(pref)
        self.positions[slot] = plen

    def _whole_prefix(self, i: int, pref):
        """A prefix leaf laid out as the pool's leaf ``i`` but whole over
        the batch (one request) and the sequence: its local tensor. One
        request's ``plen`` positions are small, and a sequence split of
        ``plen`` is not the pool's split of ``max_seq``."""
        if self.env is None:
            return pref
        from torch.distributed.tensor import Replicate
        whole = (1, SEQ_AXIS) if self._seq[i] else (1,)
        pl = tuple(Replicate() if p.is_shard() and p.dim in whole else p
                   for p in self._pl[i])
        return pref.redistribute(self.env.mesh, pl).to_local()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def memory_kinds(self) -> Set[str]:
        """The tiers the pool occupies: ``"device"`` and/or ``"pinned_host"``
        on a CUDA engine; ``"unpinned_host"`` for everything on the CPU."""
        return {memory_kind_of(t)
                for t in list(self._hot) + list(self._cold.values())}

    def host_tensors(self) -> List[torch.Tensor]:
        """The host-tier buffers (cold tails, then fully spilled leaves)."""
        return (list(self._cold.values())
                + [self._hot[i] for i in sorted(self._host_leaves)])

    def _global_bytes(self, i: int, n: Optional[int] = None) -> int:
        """Global bytes of leaf ``i``, or of ``n`` positions of its
        sequence."""
        shape = self._global[i] if n is None else _seq_cut(self._global[i], n)
        return math.prod(shape) * self._hot[i].element_size()

    @property
    def device_bytes(self) -> int:
        """Device-resident bytes (hot prefixes + unspilled leaves): the
        whole mesh's on a mesh, as the reference reports them."""
        return sum(self._global_bytes(i, self._hot_len.get(i))
                   for i in range(len(self._hot)) if i not in self._host_leaves)

    @property
    def host_bytes(self) -> int:
        """Host-tier bytes (cold tails + fully spilled leaves): the whole
        mesh's on a mesh."""
        return (sum(self._global_bytes(i, self.max_seq - n)
                    for i, n in self._hot_len.items())
                + sum(self._global_bytes(i) for i in self._host_leaves))

    @property
    def local_device_bytes(self) -> int:
        """This rank's device-resident bytes."""
        return sum(_nbytes(leaf) for i, leaf in enumerate(self._hot)
                   if i not in self._host_leaves)

    @property
    def local_host_bytes(self) -> int:
        """This rank's host-tier bytes."""
        return sum(_nbytes(t) for t in self.host_tensors())

    @property
    def split_leaves(self) -> Dict[str, int]:
        """path -> hot prefix length for every physically split leaf."""
        return {self._paths[i]: n for i, n in self._hot_len.items()}
