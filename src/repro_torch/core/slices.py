"""Slice profiles — the TPU analogue of the paper's MIG profile table (Tab. II).

A *slice* is a contiguous rectangular sub-grid of the pod's 2D ICI mesh with
power-of-two sides. This is the real constraint TPU interconnects impose, and
it reproduces MIG's coarse doubling granularity from first principles: valid
slices on a 16×16 pod are 4×4, 4×8, 8×8, 8×16, 16×16 — each step doubles BOTH
compute and memory, exactly the coupled coarse-grained provisioning the paper
critiques (§IV-C). Compute and HBM cannot be scaled independently; the escape
hatch is the paper's contribution: host-memory offloading (core/offload.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.hw import ChipSpec, PodSpec, V5E_POD, GiB


@dataclass(frozen=True)
class SliceProfile:
    """One entry of the profile table."""
    name: str
    rows: int
    cols: int

    @property
    def n_chips(self) -> int:
        return self.rows * self.cols

    def max_instances(self, pod: PodSpec) -> int:
        return (pod.rows // self.rows) * (pod.cols // self.cols)

    def hbm_bytes(self, chip: ChipSpec) -> int:
        return self.n_chips * chip.hbm_bytes

    def peak_flops(self, chip: ChipSpec) -> float:
        return self.n_chips * chip.peak_flops_bf16

    def host_dram_bytes(self, chip: ChipSpec) -> int:
        return self.n_hosts(chip) * chip.host_dram_bytes

    def host_link_bw(self, chip: ChipSpec) -> float:
        return self.n_hosts(chip) * chip.host_link_bw

    def n_hosts(self, chip: ChipSpec) -> int:
        return max(1, self.n_chips // chip.chips_per_host)

    def mesh_shape(self) -> Tuple[int, int]:
        """(data, model) axis sizes for this slice's sub-mesh."""
        return (self.rows, self.cols)


# The profile table for a 16×16 v5e pod — names follow the MIG convention
# <compute-slices>s.<chips>c (1 compute slice = 16 chips = smallest rectangle).
PROFILES: Tuple[SliceProfile, ...] = (
    SliceProfile("1s.16c", 4, 4),
    SliceProfile("2s.32c", 4, 8),
    SliceProfile("4s.64c", 8, 8),
    SliceProfile("8s.128c", 8, 16),
    SliceProfile("16s.256c", 16, 16),
)
PROFILES_BY_NAME = {p.name: p for p in PROFILES}


def get_profile(name: str) -> SliceProfile:
    try:
        return PROFILES_BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown slice profile {name!r}; valid: "
                       f"{sorted(PROFILES_BY_NAME)}") from None


def profile_table(pod: PodSpec = V5E_POD) -> List[dict]:
    """The paper's Table II analogue: usable/wasted resources per profile."""
    rows = []
    for p in PROFILES:
        n = p.max_instances(pod)
        used = n * p.n_chips
        rows.append({
            "profile": p.name,
            "max_instances": n,
            "chips": p.n_chips,
            "hbm_gib": p.hbm_bytes(pod.chip) / GiB,
            "peak_tflops": p.peak_flops(pod.chip) / 1e12,
            "hosts": p.n_hosts(pod.chip),
            "host_dram_gib": p.host_dram_bytes(pod.chip) / GiB,
            "host_link_gbps": p.host_link_bw(pod.chip) / 1e9,
            "wasted_chips_pct": 100.0 * (pod.n_chips - used) / pod.n_chips,
        })
    return rows


def smallest_fitting(bytes_needed: int, flops_needed: float,
                     pod: PodSpec = V5E_POD) -> Optional[SliceProfile]:
    """Smallest profile whose HBM holds ``bytes_needed`` (paper §VI-A's
    'next larger profile' step — what offloading lets you avoid)."""
    for p in PROFILES:
        if p.hbm_bytes(pod.chip) >= bytes_needed:
            return p
    return None


def capacity_waste(bytes_needed: int, profile: SliceProfile,
                   pod: PodSpec = V5E_POD) -> float:
    """Fraction of the slice's HBM left unused by the workload."""
    cap = profile.hbm_bytes(pod.chip)
    return max(0.0, (cap - bytes_needed) / cap)
