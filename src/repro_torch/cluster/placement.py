"""Slice-profile selection and pod/origin scoring for cluster placement.

Two-level decision, per queued job:

1. **Which profile?** MISO-style (arXiv 2207.11428): every feasible
   ``SliceProfile`` × offload plan is scored by the shared
   ``core.perfmodel.PerfModel`` (fine-grained CPU offloading widens the
   feasible set exactly as the paper intends) and ranked by perf-per-chip,
   preferring profiles whose modeled duration meets the job's SLO deadline.
2. **Which pod / origin?** Fragmentation-aware (arXiv 2512.16099): among
   the free aligned origins for the chosen profile, pick the one whose
   placement preserves the largest still-placeable profile, so large
   future jobs are not stranded behind scattered small rectangles.

``FirstFitPolicy`` is the naive baseline: smallest feasible profile, first
pod with room, first free origin (row-major) — the policy whose stranding
``benchmarks/bench_cluster.py`` quantifies.

This module only *enumerates and scores* placements. When no candidate
exists for a deadline job, selection escalates to the Action API
(``cluster/actions.py``): a ``SchedulerPolicy`` probes the allowed
rescue actions (shrink / preempt / cross-pod migrate), prices them, and
commits the cheapest SLO-preserving plan.

Units used throughout this module (and the scheduler): durations and
costs are **nominal seconds** of virtual time (wall-clock seconds once
throttle stretch is applied by ``PodSimulator``), data volumes are
**bytes**, capacities are **chips** (one chip = one grid cell of the
pod; profiles come in power-of-two rectangles of them).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

from repro_torch.configs import get_config, get_shape
from repro_torch.core.hw import ChipSpec, V5E
from repro_torch.core.offload import OffloadPlan
from repro_torch.core.perfmodel import PerfModel, PerfScore, get_model
from repro_torch.core.roofline import RooflineTerms
from repro_torch.core.slices import SliceProfile
from repro_torch.core.workload import WorkloadEstimate

from repro_torch.cluster.trace import Job

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.cluster.scheduler import PodState


@dataclass(frozen=True)
class Candidate:
    """One scored placement option for a job."""
    pod_idx: int
    profile: SliceProfile
    origin: Tuple[int, int]
    plan: OffloadPlan
    terms: RooflineTerms
    duration_s: float        # modeled (unthrottled) or pinned duration
    perf_per_chip: float     # (1/step_time)/n_chips — the MISO score
    largest_after: int       # chips of largest placeable profile after place
    meets_deadline: bool
    rung: str = ""           # PerfScore.rung; "+cpuX.XX" suffix marks a twin


def estimate_for(job: Job) -> WorkloadEstimate:
    """Full-size analytic model for a trace job (pod-scale numbers even when
    execution runs reduced configs)."""
    return WorkloadEstimate(get_config(job.arch), get_shape(job.shape))


def feasible_options(job: Job, chip: ChipSpec = V5E
                     ) -> Tuple[Tuple[SliceProfile, OffloadPlan, RooflineTerms], ...]:
    """(profile, plan, terms) for every profile the job fits on — possibly
    only via offloading — smallest profile first. A pinned ``job.profile``
    restricts the set to that profile. Thin compatibility view over the
    shared ``PerfModel`` memo (``get_model(chip).options``)."""
    return tuple((sc.profile, sc.plan, sc.terms)
                 for sc in get_model(chip).options(job))


def modeled_duration(job: Job, score: PerfScore) -> float:
    """Unthrottled duration of ``job`` on ``score.profile`` in nominal
    seconds (``steps × step_time``); a pinned ``job.duration_s`` is a
    wall-clock contract and is returned as-is."""
    return (job.duration_s if job.duration_s is not None
            else job.steps * score.step_time)


def ideal_duration(job: Job, chip: ChipSpec = V5E,
                   perf: Optional[PerfModel] = None) -> Optional[float]:
    """Duration on the job's fastest feasible profile, unthrottled — the
    SLO reference point (deadline = arrival + slo_factor × ideal)."""
    if job.duration_s is not None:
        return job.duration_s
    perf = perf if perf is not None else get_model(chip)
    opts = perf.options(job)
    if not opts:
        return None
    return min(job.steps * sc.step_time for sc in opts)


class PlacementPolicy:
    name = "base"
    repack_enabled = False

    def candidates(self, job: Job, pods: Sequence["PodState"],
                   chip: ChipSpec, now: float,
                   deadline_s: Optional[float],
                   perf: Optional[PerfModel] = None) -> List[Candidate]:
        raise NotImplementedError


class FirstFitPolicy(PlacementPolicy):
    """Smallest feasible profile, first pod, first origin — no look-ahead."""
    name = "first_fit"

    def candidates(self, job, pods, chip, now, deadline_s, perf=None):
        perf = perf if perf is not None else get_model(chip)
        cands = []
        for sc in perf.options(job):
            dur = modeled_duration(job, sc)
            need = sc.profile.n_chips
            for pod in pods:
                if pod.partitioner.free_chips() < need:
                    continue   # no origin can be free — skip the index
                origins = pod.partitioner.origins_for(sc.profile)
                if not origins:
                    continue
                cands.append(Candidate(
                    pod_idx=pod.idx, profile=sc.profile, origin=origins[0],
                    plan=sc.plan, terms=sc.terms, duration_s=dur,
                    perf_per_chip=sc.perf_per_chip,
                    largest_after=0,
                    meets_deadline=_meets(now, dur, deadline_s),
                    rung=sc.rung))
        return cands


class FragAwarePolicy(PlacementPolicy):
    """MISO profile scoring + stranding-minimizing pod/origin choice."""

    def __init__(self, repack: bool = False):
        self.repack_enabled = repack
        self.name = "frag_repack" if repack else "frag"

    def candidates(self, job, pods, chip, now, deadline_s, perf=None):
        perf = perf if perf is not None else get_model(chip)
        cands = []
        for sc in perf.options(job):
            dur = modeled_duration(job, sc)
            need = sc.profile.n_chips
            for pod in pods:
                if pod.partitioner.free_chips() < need:
                    continue   # no origin can be free — skip the index
                best = _best_origin(pod.partitioner, sc.profile)
                if best is None:
                    continue
                origin, largest_after = best
                cands.append(Candidate(
                    pod_idx=pod.idx, profile=sc.profile, origin=origin,
                    plan=sc.plan, terms=sc.terms, duration_s=dur,
                    perf_per_chip=sc.perf_per_chip,
                    largest_after=largest_after,
                    meets_deadline=_meets(now, dur, deadline_s),
                    rung=sc.rung))
        cands.sort(key=lambda c: (
            not c.meets_deadline,        # SLO-feasible placements first
            -c.perf_per_chip,            # then best perf per chip (MISO)
            -c.largest_after,            # then least stranding
            c.pod_idx, c.origin))
        return cands


def _meets(now: float, duration: float, deadline_s: Optional[float]) -> bool:
    return deadline_s is None or (now + duration) <= deadline_s


def candidate_on(pod: "PodState", job: Job, score: PerfScore, now: float,
                 deadline_s: Optional[float]) -> Optional[Candidate]:
    """Best-origin candidate for a *specific* (pod, profile) — used by the
    Action API's commit paths (repack / shrink / preempt / migrate), which
    already know which pod they reshaped."""
    best = _best_origin(pod.partitioner, score.profile)
    if best is None:
        return None
    origin, largest_after = best
    dur = modeled_duration(job, score)
    return Candidate(pod_idx=pod.idx, profile=score.profile, origin=origin,
                     plan=score.plan, terms=score.terms, duration_s=dur,
                     perf_per_chip=score.perf_per_chip,
                     largest_after=largest_after,
                     meets_deadline=_meets(now, dur, deadline_s),
                     rung=score.rung)


def _best_origin(partitioner, profile: SliceProfile
                 ) -> Optional[Tuple[Tuple[int, int], int]]:
    """(origin, largest_placeable_chips_after) maximizing the look-ahead;
    row-major order breaks ties deterministically. Answered (and memoized
    per grid generation) by the partitioner's free-rectangle index."""
    return partitioner.best_origin_for(profile)


_POLICIES = {
    "first_fit": FirstFitPolicy,
    "frag": lambda: FragAwarePolicy(repack=False),
    "frag_repack": lambda: FragAwarePolicy(repack=True),
}

POLICY_NAMES = tuple(_POLICIES)


def get_policy(name: str) -> PlacementPolicy:
    try:
        return _POLICIES[name]()
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; have {sorted(_POLICIES)}"
                       ) from None
