"""Co-scheduling simulator — the paper's §V system-level experiments.

Given a workload and a sharing configuration (N copies on N slices of one
pod), compute aggregate throughput and energy, normalized to the serial
full-pod baseline — the structure of paper Figs. 5 and 6 — including the
shared-power-cap throttling interference of Fig. 7. All scoring and power
accounting goes through ``core.perfmodel.PerfModel`` (one shared memo table
with the cluster scheduler and the serving runtime).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.hw import PodSpec, V5E_POD
from repro_torch.core.perfmodel import PerfModel, get_model
from repro_torch.core.slices import PROFILES, SliceProfile, get_profile
from repro_torch.core.workload import WorkloadEstimate


@dataclass(frozen=True)
class CoRunResult:
    config: str
    copies: int
    throughput_norm: float    # aggregate task throughput vs serial baseline
    energy_norm: float        # total energy vs serial baseline
    throttled: bool
    throttle_factor: float
    per_instance_step: float  # effective (throttled) step time per instance


def corun_copies(wl: WorkloadEstimate, profile: SliceProfile, copies: int,
                 pod: PodSpec = V5E_POD, steps: int = 100,
                 perf: Optional[PerfModel] = None) -> Optional[CoRunResult]:
    """N identical copies, one per slice (paper §V-A setup)."""
    if copies > profile.max_instances(pod):
        return None
    perf = perf if perf is not None else get_model(pod.chip)
    sc = perf.score(wl.cfg, wl.shape, profile)
    if sc is None:
        return None
    run = perf.corun([sc.load(steps)] * copies, pod)

    base_sc = perf.score(wl.cfg, wl.shape, PROFILES[-1])
    s_makespan, s_energy = perf.serial_baseline(base_sc.load(steps),
                                               copies, pod)
    return CoRunResult(
        config=f"{copies}x{profile.name}",
        copies=copies,
        throughput_norm=(s_makespan / run.makespan_s
                         if run.makespan_s else 0.0),
        energy_norm=run.energy_J / s_energy if s_energy else 0.0,
        throttled=run.throttled,
        throttle_factor=run.throttle,
        per_instance_step=(max(run.effective_times) / steps
                           if run.effective_times else 0.0),
    )


def sharing_table(wl: WorkloadEstimate, pod: PodSpec = V5E_POD
                  ) -> List[CoRunResult]:
    """Sweep the standard sharing configs (paper Fig. 5's x-axis analogue)."""
    out = []
    for prof_name, copies in (("1s.16c", 16), ("1s.16c", 8), ("2s.32c", 8),
                              ("4s.64c", 4), ("8s.128c", 2)):
        r = corun_copies(wl, get_profile(prof_name), copies, pod)
        if r is not None:
            out.append(r)
    return out


def mixed_tenancy(workloads: Dict[str, WorkloadEstimate],
                  placement: Dict[str, str], pod: PodSpec = V5E_POD,
                  steps: int = 100):
    """Co-run *different* workloads on one pod (beyond-paper: the paper only
    co-runs identical copies). placement: tag -> profile name."""
    from repro_torch.core.partitioner import StaticPartitioner
    perf = get_model(pod.chip)
    part = StaticPartitioner(pod)
    loads = []
    rows = []
    for tag, prof_name in placement.items():
        wl = workloads[tag]
        prof = get_profile(prof_name)
        part.allocate(prof, tag=tag)         # raises if it doesn't pack
        sc = perf.score(wl.cfg, wl.shape, prof)
        if sc is None:
            raise RuntimeError(f"{tag!r} does not fit {prof_name} even "
                               f"with offload")
        loads.append(sc.load(steps))
        rows.append((tag, prof_name, sc.step_time, sc.u_compute,
                     sc.plan.offloaded))
    part.validate()
    run = perf.corun(loads, pod)
    return {
        "placements": rows,
        "makespan_s": run.makespan_s,
        "energy_J": run.energy_J,
        "throttle_factor": run.throttle,
        "pod_utilization": part.utilization(),
        "effective_times": list(run.effective_times),
    }
