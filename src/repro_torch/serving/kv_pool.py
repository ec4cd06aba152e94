"""KVPool — slot-paged KV pool with planner-driven host placement.

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

When the engine runs on the CPU (the tests), both tiers are plain CPU memory
and the split changes nothing physically; every placement path still runs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.offload import (OffloadPlan, _flatten_with_paths,
                                      empty_host, memory_kind_of)
from repro_torch.models.common import to_dtype

PyTree = Any

SEQ_AXIS = 2  # layer-stacked caches: (L, slots, seq, heads, head_dim)


def _has_seq_axis(leaf, max_seq: int) -> bool:
    return leaf.dim() > SEQ_AXIS and leaf.shape[SEQ_AXIS] == max_seq


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


def _unflatten(paths: List[str], leaves: List[Any]) -> PyTree:
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


class KVPool:
    def __init__(self, model, slots: int, max_seq: int, *, device=None,
                 plan: Optional[OffloadPlan] = None, offload_all: bool = False,
                 dtype=torch.bfloat16, prefix: str = "kv"):
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.device = torch.device(model.device if device is None else device)
        self.prefix = prefix
        self.positions = np.zeros(slots, np.int32)   # per-slot cache length
        self._free: List[int] = list(range(slots))
        dtype = to_dtype(dtype)

        shapes = _flatten_with_paths(model.cache_shapes(slots, max_seq, dtype))
        self._paths = [p for p, _ in shapes]

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
            kind, hot_len = self._decide(full_path, meta, plan, offload_all)
            shape = list(meta.shape)
            if kind == "host":
                self._host_leaves.add(i)
                leaf = empty_host(shape, dtype, self.device).zero_()
            elif kind == "split":
                self._hot_len[i] = hot_len
                shape[SEQ_AXIS] = max_seq - hot_len
                self._cold[i] = empty_host(shape, dtype, self.device).zero_()
                shape[SEQ_AXIS] = hot_len
                leaf = torch.zeros(shape, dtype=dtype, device=self.device)
            else:
                leaf = torch.zeros(shape, dtype=dtype, device=self.device)
            self._hot.append(leaf)

    # ------------------------------------------------------------------
    def _decide(self, full_path: str, leaf, plan: Optional[OffloadPlan],
                offload_all: bool) -> Tuple[str, int]:
        """('device'|'host'|'split', hot_len) for one leaf."""
        if offload_all or (plan is not None and plan.is_offloaded(full_path)):
            return "host", 0
        if plan is None:
            return "device", 0
        spilled = dict(plan.partial).get(full_path)
        if not spilled:
            return "device", 0
        frac = min(1.0, spilled / _nbytes(leaf))
        if _has_seq_axis(leaf, self.max_seq):
            cold = min(self.max_seq - 1, max(1, math.ceil(frac * self.max_seq)))
            return "split", self.max_seq - cold
        # no seq axis to cut (state caches): round to majority side
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
        as they are, so an in-place decode step updates the pool directly."""
        self._wait_writeback()
        leaves = []
        for i, hot in enumerate(self._hot):
            if i in self._cold:
                leaves.append(torch.cat([hot, self._to_device(self._cold[i])],
                                        dim=SEQ_AXIS))
            elif i in self._host_leaves:
                leaves.append(self._to_device(hot))
            else:
                leaves.append(hot)
        return _unflatten(self._paths, leaves)

    def update(self, new_cache: PyTree) -> None:
        """Absorb a decode-updated cache tree: hot prefixes are copied back
        into the device-resident part, cold tails and host leaves are written
        back into their pinned buffers (asynchronously, on the current
        stream). A device-resident leaf that was updated in place is already
        the pool's own tensor."""
        leaves = [leaf for _, leaf in _flatten_with_paths(new_cache)]
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
            elif leaf is not self._hot[i]:
                self._hot[i].copy_(leaf)
        if wrote_host and self.device.type == "cuda":
            self._writeback = torch.cuda.Event()
            self._writeback.record()

    def paste(self, slot: int, prefix_cache: PyTree, plen: int) -> None:
        """Write a prefill prefix into one slot (the admit path), in place:
        each tier receives the rows of the prefix that live in it, rounded to
        the pool's dtype."""
        self._wait_writeback()
        prefs = [leaf for _, leaf in _flatten_with_paths(prefix_cache)]
        if len(prefs) != len(self._hot):
            raise ValueError("cache structure changed")
        for i, pref in enumerate(prefs):
            pool = self._hot[i]
            pref = pref.to(pool.dtype)
            if i in self._cold:
                n_hot = min(plen, self._hot_len[i])
                pool[:, slot:slot + 1, :n_hot].copy_(pref[:, :, :n_hot])
                if plen > n_hot:
                    self._cold[i][:, slot:slot + 1, :plen - n_hot].copy_(
                        pref[:, :, n_hot:plen])
                    self.paste_host_bytes += _nbytes(pref[:, :, n_hot:plen])
            elif _has_seq_axis(pool, self.max_seq):
                pool[:, slot:slot + 1, :plen].copy_(pref[:, :, :plen])
                if i in self._host_leaves:
                    self.paste_host_bytes += _nbytes(pref[:, :, :plen])
            else:  # state caches: (L, B, ...) — overwrite the slot
                pool[:, slot:slot + 1].copy_(pref)
        self.positions[slot] = plen

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

    @property
    def device_bytes(self) -> int:
        """Device-resident bytes (hot prefixes + unspilled leaves)."""
        return sum(_nbytes(leaf) for i, leaf in enumerate(self._hot)
                   if i not in self._host_leaves)

    @property
    def host_bytes(self) -> int:
        """Host-tier bytes (cold tails + fully spilled leaves)."""
        return sum(_nbytes(t) for t in self.host_tensors())

    @property
    def split_leaves(self) -> Dict[str, int]:
        """path -> hot prefix length for every physically split leaf."""
        return {self._paths[i]: n for i, n in self._hot_len.items()}
