"""Utilization metrics per workload — paper §IV (Figs. 2-3), derived.

The paper samples GPM hardware counters (SM occupancy, bandwidth, capacity);
the modelled chips are not measured here, so the same quantities are derived from
roofline terms (labeled "derived" in every report):

  U_compute  ~ SM occupancy analogue  = t_compute / step_time
  U_bw       ~ memory bandwidth util  = t_memory / step_time
  U_capacity ~ memory capacity util   = resident_bytes / slice HBM
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.hw import ChipSpec, V5E
from repro_torch.core.perfmodel import get_model
from repro_torch.core.slices import PROFILES, SliceProfile
from repro_torch.core.workload import WorkloadEstimate


@dataclass(frozen=True)
class UtilizationReport:
    profile: str
    u_compute: float
    u_bandwidth: float
    u_capacity: float
    fits: bool
    offloaded_bytes: int
    dominant: str

    def waste_compute(self, profile: SliceProfile, pod_chips: int) -> float:
        return (profile.n_chips / pod_chips) * (1 - self.u_compute)


def utilization_on(wl: WorkloadEstimate, profile: SliceProfile,
                   chip: ChipSpec = V5E) -> Optional[UtilizationReport]:
    sc = get_model(chip).score(wl.cfg, wl.shape, profile)
    if sc is None:
        return None
    return UtilizationReport(
        profile=profile.name,
        u_compute=sc.u_compute,
        u_bandwidth=sc.terms.t_memory / sc.step_time if sc.step_time else 0.0,
        u_capacity=min(1.0, sc.plan.resident_bytes / profile.hbm_bytes(chip)),
        fits=True,
        offloaded_bytes=sc.plan.host_bytes,
        dominant=sc.terms.dominant,
    )


def scaling_curve(wl: WorkloadEstimate, chip: ChipSpec = V5E) -> List[dict]:
    """Paper Fig. 4: relative performance vs slice size, normalized to the
    smallest profile the workload fits on WITHOUT offloading (the paper's
    setup — offloaded points are reported separately, marked ``offloaded``)."""
    perf = get_model(chip)
    rows = []
    base_rate = None
    for prof in PROFILES:
        fits_plain = wl.footprint_bytes() <= prof.hbm_bytes(chip)
        sc = perf.score(wl.cfg, wl.shape, prof)
        if not fits_plain:
            if sc is not None:
                rows.append({"profile": prof.name, "fits": False,
                             "offloaded": True,
                             "offload_rate": 1.0 / sc.step_time})
            else:
                rows.append({"profile": prof.name, "fits": False,
                             "offloaded": False})
            continue
        terms = sc.terms
        rate = 1.0 / terms.step_time
        if base_rate is None:
            base_rate = rate
            base_chips = prof.n_chips
        rows.append({
            "profile": prof.name, "fits": True,
            "rel_perf": rate / base_rate,
            "ideal": prof.n_chips / base_chips,
            "dominant": terms.dominant,
            "offloaded": False,
        })
    return rows
