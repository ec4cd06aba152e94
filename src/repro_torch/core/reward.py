"""The paper's reward metric (§VI-B) and configuration selector.

    R = (P / P_full) / (α + W_MEM + W_SM)

with compute waste W_SM → W_compute = (chips_slice/chips_pod)·(1 − U_c) and
memory waste W_MEM = (HBM_slice − resident)/HBM_pod. α ∈ [0,1] is the policy
knob: α = 0 prioritizes reducing underutilization, α → 1 prioritizes
performance (paper Fig. 8).

Performance P is the roofline-model step rate (1/step_time) of the modelled
chip, *estimated* as the reference estimates it, not measured. The
selector sweeps every slice profile, with and without the offload plan, and
returns the argmax — reproducing the paper's "offload on the small slice vs
take the next slice up" decision procedure.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.hw import ChipSpec, PodSpec, V5E_POD
from repro_torch.core.offload import OffloadPlan, estimated_step_slowdown
from repro_torch.core.slices import PROFILES, SliceProfile
from repro_torch.core.workload import WorkloadEstimate


@dataclass(frozen=True)
class RewardPoint:
    profile: SliceProfile
    plan: Optional[OffloadPlan]      # None -> no offloading used/needed
    fits: bool
    step_time: float                 # seconds (roofline estimate)
    perf_rel: float                  # P / P_full
    u_compute: float                 # roofline compute utilization on slice
    w_sm: float
    w_mem: float
    reward: float
    alpha: float

    @property
    def label(self) -> str:
        off = "+offload" if self.plan and self.plan.offloaded else ""
        return f"{self.profile.name}{off}"


def evaluate(wl: WorkloadEstimate, profile: SliceProfile, *, alpha: float,
             use_offload: bool, pod: PodSpec = V5E_POD,
             p_full: Optional[float] = None) -> Optional[RewardPoint]:
    chip = pod.chip
    inv_bytes = wl.footprint_bytes()
    hbm = profile.hbm_bytes(chip)
    plan: Optional[OffloadPlan] = None
    if inv_bytes > hbm:
        if not use_offload:
            return None  # does not fit without offloading
        plan = wl.plan_for(profile, chip)
        if not plan.fits:
            return None
    terms = wl.roofline_on(profile, chip, plan)
    step = terms.step_time
    resident = plan.resident_bytes if plan else inv_bytes
    u_c = terms.t_compute / step if step else 0.0
    w_sm = (profile.n_chips / pod.n_chips) * (1.0 - u_c)
    w_mem = max(0.0, (hbm - resident)) / pod.hbm_total
    if p_full is None:
        p_full = 1.0 / wl.roofline_on(PROFILES[-1], chip).step_time
    perf_rel = (1.0 / step) / p_full
    # ε-floor keeps R finite when a config achieves (near-)zero waste at α=0
    reward = perf_rel / max(alpha + w_mem + w_sm, 1e-3)
    return RewardPoint(profile, plan, True, step, perf_rel, u_c, w_sm, w_mem,
                       reward, alpha)


def sweep(wl: WorkloadEstimate, *, alpha: float, pod: PodSpec = V5E_POD
          ) -> List[RewardPoint]:
    """All feasible (profile × {plain, +offload}) points, best reward first."""
    p_full = 1.0 / wl.roofline_on(PROFILES[-1], pod.chip).step_time
    pts: List[RewardPoint] = []
    for prof in PROFILES:
        plain = evaluate(wl, prof, alpha=alpha, use_offload=False, pod=pod,
                         p_full=p_full)
        if plain is not None:
            pts.append(plain)
        else:
            off = evaluate(wl, prof, alpha=alpha, use_offload=True, pod=pod,
                           p_full=p_full)
            if off is not None:
                pts.append(off)
    return sorted(pts, key=lambda p: -p.reward)


def select(wl: WorkloadEstimate, *, alpha: float, pod: PodSpec = V5E_POD
           ) -> Optional[RewardPoint]:
    pts = sweep(wl, alpha=alpha, pod=pod)
    return pts[0] if pts else None
