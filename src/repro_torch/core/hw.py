"""Hardware model: chip/host/pod constants for the modeled families.

Every figure in this file describes a *modelled* chip family (v5e-class,
MI300-class) that offload plans and, later, scheduler timelines are priced
against; the values equal the reference package's so plans compare field by
field. None of them is a measurement or a specification of the GPU this
package runs on.

These are the constants the roofline analysis, the offload planner, and the
power model all read from. Sources: assignment-provided roofline constants
(197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI); host-side figures follow
typical v5e host provisioning and are the TPU analogue of the paper's
Grace-Hopper CPU side (NVLink-C2C 450 GB/s there, PCIe-class ~32 GB/s/host
here — the ~30× weaker host link is the main quantitative assumption change,
see DESIGN.md §2/§7).

Power figures are synthetic calibrations to public TDP-class numbers; the
paper's §V-B finding (partitions isolate compute/memory but NOT power
delivery) is reproduced structurally by the shared pod-level cap.

Two chip families live here:

* ``V5E`` — the original TPU v5e family. One partition mode (``fixed``):
  the grid geometry and roofline constants never change at runtime.
* ``MI300X`` — an MI300-class reconfigurable part, modeled at XCD
  granularity (one grid cell = one XCD; eight XCDs = one package = one
  "host" aggregation unit). Its :class:`PartitionMode` table exposes the
  runtime-switchable compute modes (monolithic **SPX** vs per-XCD **CPX**,
  which gate slice granularity) and memory modes (**NPS1** vs **NPS4**
  quadrant interleave, which trade effective local HBM bandwidth against
  visible capacity). The per-mode deltas are *synthetic calibrations* to
  publicly reported MI300 partitioning effects — labeled as such, exactly
  like the power figures above — and flow into the roofline via
  :func:`effective_chip`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple

GiB = 1024 ** 3


@dataclass(frozen=True)
class HostSpec:
    """CPU side of one host — the *compute* half of the offload tier.

    ``OffloadPlan`` only needs the host link and DRAM capacity (both on
    ``ChipSpec``); twin-offload co-execution (``core.offload.plan_twin``)
    additionally needs how fast the host can run the work it receives:
    aggregate CPU throughput, host memory bandwidth (optimizer math is
    memory-bound on CPU), and whether the chip-to-host link is
    cache-coherent. A coherent C2C link (the paper's Grace-Hopper story)
    moves cache lines instead of DMA granules, modeled as a flat
    multiplier on the effective link bandwidth.
    """
    name: str = "v5e-host"
    cpu_flops: float = 3.0e12               # FLOP/s per host (fp32 SIMD)
    dram_bw: float = 300e9                  # bytes/s per host (DDR channels)
    c2c_coherent: bool = False              # cache-coherent chip<->host link?
    c2c_scale: float = 8.0                  # link multiplier when coherent

    def effective_link_scale(self) -> float:
        return self.c2c_scale if self.c2c_coherent else 1.0


V5E_HOST = HostSpec()
# The paper's C2C configuration: same CPU, coherent link (NVLink-C2C-class).
V5E_HOST_C2C = HostSpec(name="v5e-host-c2c", c2c_coherent=True)


@dataclass(frozen=True)
class ChipSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12         # FLOP/s per chip
    hbm_bytes: int = 16 * GiB               # HBM capacity per chip
    hbm_bw: float = 819e9                   # bytes/s per chip
    ici_bw_per_link: float = 50e9           # bytes/s per direction per link
    ici_links: int = 4                      # 2D torus: ±x, ±y
    # host side (the "CPU offload" tier)
    chips_per_host: int = 8
    host_dram_bytes: int = 512 * GiB        # per host
    host_link_bw: float = 32e9              # bytes/s per host (PCIe-class)
    # data-center network: each host carries one 100 GbE-class NIC onto the
    # cluster fabric. Cross-pod tenant migration (cluster/actions.py
    # MigrateAcrossPods) prices its save/restore volumes over this link —
    # the DCN NIC, not the PCIe host link, is the bottleneck of a
    # pod-to-pod move. Units: bytes/s per host.
    dcn_link_bw: float = 12.5e9             # bytes/s per host (100 GbE DCN)
    # power model (synthetic; labeled as such in all outputs)
    idle_watts: float = 60.0
    active_watts: float = 200.0             # chip at full utilization

    @property
    def host_link_bw_per_chip(self) -> float:
        return self.host_link_bw / self.chips_per_host

    @property
    def host_dram_per_chip(self) -> int:
        return self.host_dram_bytes // self.chips_per_host

    @property
    def ici_bw(self) -> float:
        """Aggregate injection bandwidth per chip."""
        return self.ici_bw_per_link * self.ici_links


@dataclass(frozen=True)
class PodSpec:
    chip: ChipSpec
    rows: int = 16
    cols: int = 16
    # shared power delivery: provisioned below sum-of-chip-max (the paper's
    # §V-B interference channel). 0.85 over-subscription factor.
    power_cap_fraction: float = 0.85

    @property
    def n_chips(self) -> int:
        return self.rows * self.cols

    @property
    def hbm_total(self) -> int:
        return self.n_chips * self.chip.hbm_bytes

    @property
    def peak_flops(self) -> float:
        return self.n_chips * self.chip.peak_flops_bf16

    @property
    def power_cap_watts(self) -> float:
        return self.power_cap_fraction * self.n_chips * self.chip.active_watts

    @property
    def n_hosts(self) -> int:
        return max(1, self.n_chips // self.chip.chips_per_host)

    @property
    def host_bw(self) -> float:
        """Aggregate host-link (PCIe-class) bandwidth of the pod, bytes/s —
        the price basis for in-pod migrations and checkpoint save/restore."""
        return self.n_hosts * self.chip.host_link_bw

    @property
    def dcn_bw(self) -> float:
        """Aggregate DCN bandwidth of the pod, bytes/s (``n_hosts`` NICs at
        ``chip.dcn_link_bw`` each; 32 hosts × 12.5 GB/s = 400 GB/s for the
        default 256-chip pod) — the price basis for cross-pod migration."""
        return self.n_hosts * self.chip.dcn_link_bw


V5E = ChipSpec()
V5E_POD = PodSpec(chip=V5E)


# ---------------------------------------------------------------------------
# Partition modes (MI300-class SPX/CPX × NPS1/NPS4) + the chip registry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PartitionMode:
    """One runtime-selectable partitioning of a reconfigurable chip.

    ``compute`` is the compute-partition axis (``"spx"`` — monolithic, the
    whole package is one scheduling unit; ``"cpx"`` — per-XCD). It gates
    *slice granularity*: ``min_slice_chips`` is the smallest rectangle (in
    grid cells) the partitioner may hand out in this mode, so an SPX pod
    only offers the coarse end of the profile ladder. ``memory`` is the
    NUMA-per-socket axis (``"nps1"`` — fully interleaved; ``"nps4"`` —
    quadrant): NPS4 raises effective *local* HBM bandwidth but shrinks the
    capacity visible to one partition. The three ``*_scale`` factors carry
    those deltas into the roofline terms via :func:`effective_chip`; all
    are synthetic calibrations (documented in docs/hardware.md).

    ``switch_downtime_s`` is the fixed wall-clock outage a mode switch
    costs on top of draining the pod — the price basis of the
    ``ReconfigurePartition`` cluster action.
    """
    name: str
    compute: str = "spx"            # "spx" | "cpx"
    memory: str = "nps1"            # "nps1" | "nps4"
    flops_scale: float = 1.0        # × peak FLOP/s per cell
    hbm_bw_scale: float = 1.0       # × effective HBM bytes/s per cell
    hbm_capacity_scale: float = 1.0  # × visible HBM bytes per cell
    min_slice_chips: int = 1        # granularity floor (grid cells)
    switch_downtime_s: float = 30.0

    @property
    def is_identity(self) -> bool:
        """True when the mode leaves the roofline constants untouched."""
        return (self.flops_scale == 1.0 and self.hbm_bw_scale == 1.0
                and self.hbm_capacity_scale == 1.0)


# The v5e is not reconfigurable: one identity mode, zero-cost by construction
# (there is never another mode to switch to).
FIXED_MODE = PartitionMode(name="fixed")

# MI300-class part at XCD granularity: one grid cell = one XCD, eight XCDs =
# one package. Package-level public figures (~1.3 PFLOP/s bf16, 192 GB HBM3,
# 5.3 TB/s) divided by eight; host side is the package's PCIe Gen5-class
# attach. Power is synthetic (750 W-class package / 8).
MI300X = ChipSpec(
    name="mi300x",
    peak_flops_bf16=163e12,         # per XCD (~1.3 PF / 8)
    hbm_bytes=24 * GiB,             # per XCD (192 GB / 8)
    hbm_bw=663e9,                   # per XCD (5.3 TB/s / 8)
    ici_bw_per_link=64e9,           # Infinity-Fabric-class
    ici_links=4,
    chips_per_host=8,               # one package per host unit
    host_dram_bytes=768 * GiB,
    host_link_bw=64e9,              # PCIe Gen5 x16-class per package
    dcn_link_bw=12.5e9,
    idle_watts=12.0,
    active_watts=95.0,              # 750 W-class package / 8
)

# Synthetic per-mode deltas (see docs/hardware.md for the calibration
# story and units). SPX schedules whole packages → the granularity floor
# is 64 cells (an 8×8 rectangle, eight packages); CPX exposes every XCD.
# NPS4 quadrant interleave: +30% effective local bandwidth, 75% visible
# capacity. CPX adds a small locality bonus to per-cell peak FLOP/s.
MI300_MODES: Dict[str, PartitionMode] = {
    "spx-nps1": PartitionMode(
        name="spx-nps1", compute="spx", memory="nps1", min_slice_chips=64),
    "spx-nps4": PartitionMode(
        name="spx-nps4", compute="spx", memory="nps4", hbm_bw_scale=1.30,
        hbm_capacity_scale=0.75, min_slice_chips=64),
    "cpx-nps1": PartitionMode(
        name="cpx-nps1", compute="cpx", memory="nps1", flops_scale=1.05),
    "cpx-nps4": PartitionMode(
        name="cpx-nps4", compute="cpx", memory="nps4", flops_scale=1.05,
        hbm_bw_scale=1.30, hbm_capacity_scale=0.75),
}

MI300_POD = PodSpec(chip=MI300X)

# CLI-facing registry: alias → ChipSpec. ``get_chip`` is the one lookup the
# trace loader and launchers go through, so unknown names fail readably.
CHIPS: Dict[str, ChipSpec] = {"v5e": V5E, "mi300": MI300X}

_MODES_BY_CHIP: Dict[str, Dict[str, PartitionMode]] = {
    V5E.name: {"fixed": FIXED_MODE},
    MI300X.name: MI300_MODES,
}
_DEFAULT_MODE: Dict[str, str] = {V5E.name: "fixed", MI300X.name: "spx-nps1"}


def get_chip(name: str) -> ChipSpec:
    """Resolve a chip alias (``"v5e"``, ``"mi300"``) to its ChipSpec."""
    try:
        return CHIPS[name]
    except KeyError:
        raise ValueError(f"unknown chip {name!r}; valid: "
                         f"{sorted(CHIPS)}") from None


def partition_modes(chip: ChipSpec) -> Dict[str, PartitionMode]:
    """The mode table of ``chip`` (fixed-only for non-reconfigurable
    parts, including derived/effective chips)."""
    return dict(_MODES_BY_CHIP.get(chip.name, {"fixed": FIXED_MODE}))


def default_mode(chip: ChipSpec) -> str:
    """The mode a freshly built pod of ``chip`` boots in."""
    return _DEFAULT_MODE.get(chip.name, "fixed")


def get_mode(chip: ChipSpec, name: str) -> PartitionMode:
    """Resolve one mode of ``chip`` by name; unknown names fail readably."""
    modes = partition_modes(chip)
    try:
        return modes[name]
    except KeyError:
        raise ValueError(f"unknown partition mode {name!r} for chip "
                         f"{chip.name!r}; valid: {sorted(modes)}") from None


_EFFECTIVE: Dict[Tuple[ChipSpec, PartitionMode], ChipSpec] = {}


def effective_chip(base: ChipSpec, mode: PartitionMode) -> ChipSpec:
    """The ChipSpec the roofline actually sees under ``mode``.

    Identity modes return ``base`` itself (same object — every memo keyed
    on the chip stays bit-identical with the fixed-mode default). Scaling
    modes derive a frozen copy with the mode's deltas applied and the mode
    name folded into ``name`` — so every PerfModel memo, ``profile_key``,
    and ProbeCache signature downstream is automatically mode-keyed."""
    if mode.is_identity:
        return base
    key = (base, mode)
    eff = _EFFECTIVE.get(key)
    if eff is None:
        eff = _EFFECTIVE[key] = replace(
            base,
            name=f"{base.name}:{mode.name}",
            peak_flops_bf16=base.peak_flops_bf16 * mode.flops_scale,
            hbm_bw=base.hbm_bw * mode.hbm_bw_scale,
            hbm_bytes=int(base.hbm_bytes * mode.hbm_capacity_scale),
        )
    return eff


def ladder_for(mode: PartitionMode):
    """The slice-profile ladder available under ``mode`` — the full table
    filtered by the mode's granularity floor (smallest first, like
    ``PROFILES``)."""
    from repro_torch.core.slices import PROFILES   # slices imports hw; keep lazy
    return tuple(p for p in PROFILES if p.n_chips >= mode.min_slice_chips)
