"""OffloadPlanner — fine-grained host-memory offloading (paper §VI-A).

The paper's scheme: when a workload's footprint is *slightly* above a slice's
memory, offload part of its data to CPU memory instead of doubling the slice.
The planner ranks offloadable tensors by bytes freed per byte of host traffic
added and spills the coldest state first — optimizer moments, embedding
tables, cold KV-cache tails — and only then activations.

The planning half (``TensorInfo``, ``OffloadPlan``, ``plan_offload``, the twin
types, the overlap model) is arithmetic and gives plans equal field by field
to the reference's on the same inventory. The placement half maps a plan onto
two real tiers: ``"device"`` is a tensor on the CUDA device, the host tier is
a **pinned** CPU tensor (``"pinned_host"``) when the target device is CUDA,
and a plain CPU tensor when the caller asked for the CPU, where both tiers
are the same memory.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.hw import ChipSpec, HostSpec, V5E, V5E_HOST
from repro_torch.core.slices import SliceProfile

PyTree = Any

# access multipliers: host-link bytes moved per step per resident byte if the
# tensor is offloaded (read + write counts per training/serving step)
GROUP_TRAFFIC = {
    "opt_state": 2.0,     # read m,v + write back, once per step
    "param": 3.0,         # read for fwd+bwd use, write after update
    "embed": 0.02,        # row-gather: tokens/step × row ≪ table size
    "kv_cache": 0.05,     # decode touches one position + appends
    "kv_cache_prefill": 2.0,
    "activation": 2.0,    # offload at save, fetch at bwd
}
# groups in preferred offload order when traffic ties
GROUP_PRIORITY = ("opt_state", "embed", "kv_cache", "param", "activation")


@dataclass(frozen=True)
class TensorInfo:
    name: str
    bytes: int
    group: str
    offloadable: bool = True
    divisible: bool = False  # can spill a fraction (KV tail, opt shard, rows)
    traffic_multiplier: Optional[float] = None  # override GROUP_TRAFFIC

    @property
    def traffic_per_step(self) -> float:
        m = (self.traffic_multiplier if self.traffic_multiplier is not None
             else GROUP_TRAFFIC.get(self.group, 2.0))
        return m * self.bytes


MIN_SPILL_BYTES = 64 * 1024 * 1024  # finest spill granule for divisible tensors


@dataclass(frozen=True)
class OffloadPlan:
    offloaded: Tuple[str, ...]             # fully-spilled tensor names
    partial: Tuple[Tuple[str, int], ...]   # (name, spilled_bytes)
    resident_bytes: int
    host_bytes: int
    host_traffic_per_step: float
    fits: bool
    # (name, tensor_total_bytes) for every partial entry — what turns the
    # raw spilled byte counts above into true fractions
    partial_totals: Tuple[Tuple[str, int], ...] = ()

    def is_offloaded(self, name: str) -> bool:
        return name in self.offloaded

    def spilled_fraction(self, name: str,
                         total_bytes: Optional[int] = None) -> float:
        """Fraction of ``name``'s bytes spilled to host: 1.0 fully offloaded,
        0.0 resident, and ``spilled/total`` for partial entries. ``total_bytes``
        overrides (or supplies, for hand-built plans without
        ``partial_totals``) the tensor's full size."""
        for n, b in self.partial:
            if n == name:
                total = (total_bytes if total_bytes is not None
                         else dict(self.partial_totals).get(name))
                if not total:
                    raise ValueError(
                        f"partial entry {name!r} has no recorded total size; "
                        f"pass total_bytes=")
                return min(1.0, b / total)
        return 1.0 if name in self.offloaded else 0.0

    @property
    def total_bytes(self) -> int:
        return self.resident_bytes + self.host_bytes


def plan_offload(inventory: Sequence[TensorInfo], hbm_budget: int,
                 host_budget: Optional[int] = None, *,
                 spill_granule: int = MIN_SPILL_BYTES) -> OffloadPlan:
    """Greedy knapsack: spill highest (bytes freed / host traffic added) first.

    *Fine-grained* in the paper's sense: ``divisible`` tensors (KV-cache
    tails, optimizer-state shards, embedding rows) are spilled only as far as
    needed to fit, never all-or-nothing — this is what keeps the added host
    traffic proportional to the *overhang* above the slice, not to the tensor.

    Returns ``fits=False`` if even spilling everything offloadable leaves the
    residents above budget (the caller must take a larger slice — the coarse
    step the paper wants to avoid — or shrink the workload).
    """
    total = sum(t.bytes for t in inventory)
    if total <= hbm_budget:
        return OffloadPlan((), (), total, 0, 0.0, True)

    def ratio(t: TensorInfo) -> float:
        return t.bytes / max(t.traffic_per_step, 1.0)

    prio = {g: i for i, g in enumerate(GROUP_PRIORITY)}
    candidates = sorted(
        [t for t in inventory if t.offloadable],
        key=lambda t: (-ratio(t), prio.get(t.group, len(prio)), -t.bytes))

    offloaded: List[str] = []
    partial: List[Tuple[str, int]] = []
    partial_totals: List[Tuple[str, int]] = []
    resident = total
    host = 0
    traffic = 0.0
    for t in candidates:
        need = resident - hbm_budget
        if need <= 0:
            break
        take = t.bytes
        if t.divisible and t.bytes > need:
            # spill only the overhang (rounded up to the spill granule;
            # ``spill_granule`` shrinks for reduced-scale demos/tests so the
            # partial path stays reachable below 64 MiB tensors)
            take = min(t.bytes, max(need, spill_granule))
        if host_budget is not None and host + take > host_budget:
            take = max(0, host_budget - host)
            # an indivisible tensor cannot spill a fraction: skip it rather
            # than record a partial no placement layer can realize
            if take == 0 or (not t.divisible and take < t.bytes):
                continue
        frac = take / t.bytes
        if take == t.bytes:
            offloaded.append(t.name)
        else:
            partial.append((t.name, int(take)))
            partial_totals.append((t.name, int(t.bytes)))
        resident -= take
        host += take
        traffic += t.traffic_per_step * frac
    return OffloadPlan(tuple(offloaded), tuple(partial), resident, host,
                       traffic, resident <= hbm_budget,
                       tuple(partial_totals))


# ---------------------------------------------------------------------------
# twin-offload co-execution (ZeRO-Offload++-style compute splitting)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TwinSpec:
    """Enablement knobs for twin-offload rungs (default-off at every caller).

    Hashable on purpose: ``perfmodel.get_model`` keys its process-wide memo
    on ``(chip, twin)``, and the spec is folded into ``PerfModel.profile_key``
    so probe caches never mix twin-on and twin-off pricing.
    """
    host: HostSpec = V5E_HOST
    min_speedup: float = 1.02      # emit a rung only if ≥2% faster than plain
    max_cpu_fraction: float = 1.0  # cap on any shard's CPU fraction


@dataclass(frozen=True)
class TwinShard:
    """One divisible compute-bearing shard split between GPU and CPU.

    ``flops``/``cpu_bytes`` describe the *whole* shard per step;
    ``cpu_fraction`` of it runs host-side. ``link_bytes``/``link_bytes_saved``
    are the chip<->host traffic a full (fraction 1.0) split adds/removes —
    the coherence-aware traffic model: running the consumer of spilled state
    on the CPU replaces the state's round trip with the (smaller)
    operand/result exchange.
    """
    name: str
    group: str
    cpu_fraction: float
    flops: float
    cpu_bytes: float
    link_bytes: float
    link_bytes_saved: float = 0.0


@dataclass(frozen=True)
class TwinOffloadPlan:
    """A memory plan plus a compute split: the two-resource schedule.

    The GPU-side terms (compute/HBM/collectives, collapsed into
    ``gpu_floor_s`` here) are deliberately NOT credited for the moved FLOPs —
    the eligible shards carry well under 1% of the counted step FLOPs, so the
    twin win is modeled entirely on the link (``t_link``) against the new CPU
    service time (``t_cpu``). Conservative by construction.
    """
    base: OffloadPlan
    shards: Tuple[TwinShard, ...]
    host: HostSpec
    n_hosts: int
    gpu_floor_s: float
    t_cpu: float
    t_link: float

    @property
    def cpu_fraction(self) -> float:
        total = sum(s.flops for s in self.shards)
        if total <= 0:
            return 0.0
        return sum(s.cpu_fraction * s.flops for s in self.shards) / total

    @property
    def link_traffic_per_step(self) -> float:
        delta = sum(s.cpu_fraction * (s.link_bytes - s.link_bytes_saved)
                    for s in self.shards)
        return max(0.0, self.base.host_traffic_per_step + delta)

    @property
    def step_time(self) -> float:
        return max(self.gpu_floor_s, self.t_cpu, self.t_link)


def plan_twin(base: OffloadPlan, candidates: Sequence[TwinShard], *,
              gpu_floor_s: float, link_bw: float, host: HostSpec = V5E_HOST,
              n_hosts: int = 1, max_cpu_fraction: float = 1.0,
              grid: int = 128) -> TwinOffloadPlan:
    """Choose CPU fractions minimizing ``max(t_gpu, t_cpu, t_link)``.

    ``candidates`` come in with ``cpu_fraction`` ignored; each is resolved
    greedily (best net-link-savings density first) by an exact scan over a
    ``grid``-point fraction lattice — all three terms are linear in the
    fraction, so the scan is a deterministic, float-order-stable LP solve.
    Fractions land in ``[0, max_cpu_fraction]`` and the smallest fraction
    achieving the minimum wins (no pointless CPU work on ties).
    """
    cpu_flops = host.cpu_flops * max(1, n_hosts)
    dram_bw = host.dram_bw * max(1, n_hosts)
    eff_link = link_bw * host.effective_link_scale()

    def service(c: TwinShard) -> float:
        """CPU seconds to run the whole shard host-side (compute or DRAM)."""
        return max(c.flops / cpu_flops, c.cpu_bytes / dram_bw)

    def density(c: TwinShard) -> float:
        saved = (c.link_bytes_saved - c.link_bytes) / eff_link
        return saved / max(service(c), 1e-12)

    order = sorted(range(len(candidates)),
                   key=lambda i: (-density(candidates[i]), i))
    fractions = [0.0] * len(candidates)
    t_cpu = 0.0
    traffic = base.host_traffic_per_step
    cap = min(1.0, max(0.0, max_cpu_fraction))
    for i in order:
        c = candidates[i]
        s, dlink = service(c), c.link_bytes - c.link_bytes_saved
        best_a, best_t = 0.0, max(gpu_floor_s, t_cpu,
                                  max(0.0, traffic) / eff_link)
        for k in range(1, grid + 1):
            a = cap * k / grid
            t = max(gpu_floor_s, t_cpu + a * s,
                    max(0.0, traffic + a * dlink) / eff_link)
            if t < best_t - 1e-15:
                best_a, best_t = a, t
        fractions[i] = best_a
        t_cpu += best_a * s
        traffic += best_a * dlink
    shards = tuple(replace(c, cpu_fraction=f)
                   for c, f in zip(candidates, fractions) if f > 0.0)
    return TwinOffloadPlan(base, shards, host, max(1, n_hosts), gpu_floor_s,
                           t_cpu, max(0.0, traffic) / eff_link)


# When GPU time and host traffic are comparable, the first granule of a
# step's host traffic cannot overlap the compute that produces/consumes it;
# the schedule pays a serial prefix proportional to the *second-largest*
# resource term. 0.1 matches the double-buffer depth the KV pool uses.
OVERLAP_SERIAL_FRACTION = 0.1


def overlap_step_time(t_gpu: float, t_cpu: float, t_link: float) -> float:
    """Two-resource overlap model: ``max(t_gpu, t_cpu, t_link)`` plus the
    non-overlappable serial prefix. Never better than the unconstrained
    ``max`` bound; converges to it when one term dominates."""
    terms = sorted((t_gpu, t_cpu, t_link))
    return terms[2] + OVERLAP_SERIAL_FRACTION * terms[1]


def estimated_step_slowdown(plan, base_step_time: float,
                            profile: SliceProfile, chip: ChipSpec = V5E,
                            host: Optional[HostSpec] = None) -> float:
    """New step time with host traffic overlapped against compute.

    Replaces the old ``max(base, t_host)`` form, which silently assumed the
    host traffic overlaps compute *perfectly* — wrong exactly in the
    crossover region ``base_step_time`` ≈ ``t_host``, where double-buffered
    DMA still serializes on the first granule. Accepts a plain
    ``OffloadPlan`` (no CPU co-execution: ``t_cpu = 0``) or a
    ``TwinOffloadPlan`` (its solved two-resource terms).
    """
    if isinstance(plan, TwinOffloadPlan):
        return overlap_step_time(max(base_step_time, plan.gpu_floor_s),
                                 plan.t_cpu, plan.t_link)
    scale = host.effective_link_scale() if host is not None else 1.0
    t_link = plan.host_traffic_per_step / (profile.host_link_bw(chip) * scale)
    return overlap_step_time(base_step_time, 0.0, t_link)


# ---------------------------------------------------------------------------
# inventories from trees
# ---------------------------------------------------------------------------
def _group_for(path: str) -> Tuple[str, bool]:
    """(group, offloadable) from a tree path."""
    if re.search(r"(^|/)(mu|nu)(/|$)", path):
        return "opt_state", True
    if "tok_embed" in path or "pos_embed" in path:
        return "embed", True
    if re.search(r"(^|/)(k|v|cross_k|cross_v|ssm|conv|state)(/|$)", path):
        return "kv_cache", True
    return "param", True


def _flatten_with_paths(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs with ``/``-joined keys, dict keys in sorted order
    and sequence items by index — the order and names the reference's pytree
    flattening gives."""
    out: List[Tuple[str, Any]] = []
    if isinstance(tree, dict):
        for key in sorted(tree):
            out += _flatten_with_paths(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            out += _flatten_with_paths(item, f"{prefix}{i}/")
    elif tree is not None:
        out.append((prefix[:-1], tree))
    return out


def _nbytes(leaf) -> int:
    return int(leaf.numel()) * leaf.element_size()


def inventory_from_tree(tree: PyTree, *, default_group: Optional[str] = None
                        ) -> List[TensorInfo]:
    """Build a TensorInfo list from any tree of tensors (meta tensors do)."""
    out = []
    for path, leaf in _flatten_with_paths(tree):
        if not hasattr(leaf, "dtype"):
            continue
        group, off = (_group_for(path) if default_group is None
                      else (default_group, True))
        out.append(TensorInfo(path, _nbytes(leaf), group, off))
    return out


# ---------------------------------------------------------------------------
# plan application (real memory tiers)
# ---------------------------------------------------------------------------
DEVICE_KIND = "device"
PINNED_HOST_KIND = "pinned_host"
UNPINNED_HOST_KIND = "unpinned_host"


def host_memory_kind(device) -> str:
    """The host tier for an engine on ``device``: pinned CPU memory beside a
    CUDA device; plain CPU memory when the caller runs on the CPU."""
    return (PINNED_HOST_KIND if torch.device(device).type == "cuda"
            else UNPINNED_HOST_KIND)


def device_memory_kind(device) -> str:
    """The device tier; on the CPU it is the same memory as the host tier."""
    return (DEVICE_KIND if torch.device(device).type == "cuda"
            else UNPINNED_HOST_KIND)


def memory_kind_of(t: torch.Tensor) -> str:
    if t.device.type == "cuda":
        return DEVICE_KIND
    return PINNED_HOST_KIND if t.is_pinned() else UNPINNED_HOST_KIND


def empty_host(shape, dtype, device) -> torch.Tensor:
    """An uninitialised host-tier buffer for an engine on ``device``."""
    pin = torch.device(device).type == "cuda"
    return torch.empty(shape, dtype=dtype, device="cpu", pin_memory=pin)


def to_host(t: torch.Tensor, device) -> torch.Tensor:
    """Copy ``t`` into a new host-tier buffer (pinned beside a CUDA device)."""
    buf = empty_host(t.shape, t.dtype, device)
    buf.copy_(t)
    return buf


def kinds_with_offload(tree: PyTree, plan: OffloadPlan, device, *,
                       partial_host_threshold: float = 0.5) -> Dict[str, str]:
    """path -> memory kind for every leaf: offloaded leaves go to the host
    tier. A leaf lives whole in one tier here, so a partially spilled leaf
    is rounded to the majority side (host when the spilled fraction reaches
    ``partial_host_threshold``); the physically split hot-prefix / cold-tail
    placement of KV pools lives in ``repro_torch.serving.kv_pool.KVPool``."""
    partial_bytes = dict(plan.partial)
    host_kind, dev_kind = host_memory_kind(device), device_memory_kind(device)
    kinds = {}
    for path, leaf in _flatten_with_paths(tree):
        kind = dev_kind
        if plan.is_offloaded(path):
            kind = host_kind
        elif path in partial_bytes and hasattr(leaf, "dtype"):
            if partial_bytes[path] / max(_nbytes(leaf), 1) >= partial_host_threshold:
                kind = host_kind
        kinds[path] = kind
    return kinds


def place_tree(value_tree: PyTree, plan: OffloadPlan, device, *,
               partial_host_threshold: float = 0.5) -> PyTree:
    """Move each leaf whole to its planned tier: the CUDA device, or pinned
    host memory. Leaf paths are matched against the plan's names as they
    are, so wrap the tree the way the inventory was built
    (``place_tree({"params": params}, plan, device)["params"]``)."""
    device = torch.device(device)
    kinds = kinds_with_offload(value_tree, plan, device,
                               partial_host_threshold=partial_host_threshold)
    host_kind = host_memory_kind(device)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}{i}/") for i, v in enumerate(tree))
        if kinds[path[:-1]] == host_kind and device.type == "cuda":
            return to_host(tree, device)
        return tree.to(device)

    return walk(value_tree, "")
