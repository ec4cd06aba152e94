"""Pod power / energy model with shared-cap throttling (paper §V-B, Figs 6-7).

MIG isolates compute and memory but *not power delivery*: the paper shows
seven concurrent compute-heavy instances collectively exceed the 700 W cap
and throttle, while a single instance never does. Same structure here: chips
draw idle + utilization-proportional dynamic power; the pod's provisioned cap
is below chips×max; when concurrent slices push total draw over the cap, the
whole pod frequency-scales, stretching every instance's compute term.

Synthetic calibration, the reference's (``hw.py``); every output is a model of
the modelled pod, not a measurement of the GPU the port runs on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.core.hw import ChipSpec, PodSpec, V5E_POD


@dataclass(frozen=True)
class InstanceLoad:
    n_chips: int
    u_compute: float       # roofline compute utilization in [0,1]
    step_time: float       # un-throttled step time (s)
    steps: int = 1


def chip_power(u: float, chip: ChipSpec) -> float:
    return chip.idle_watts + (chip.active_watts - chip.idle_watts) * min(max(u, 0.0), 1.0)


def pod_draw(instances: Sequence[InstanceLoad], pod: PodSpec = V5E_POD) -> float:
    used = sum(i.n_chips for i in instances)
    assert used <= pod.n_chips, "over-allocated pod"
    active = sum(i.n_chips * chip_power(i.u_compute, pod.chip) for i in instances)
    idle = (pod.n_chips - used) * pod.chip.idle_watts
    return active + idle


def throttle_factor(instances: Sequence[InstanceLoad], pod: PodSpec = V5E_POD
                    ) -> float:
    """Frequency-scale factor f ≤ 1 applied when draw exceeds the cap.
    Dynamic power ~ f (voltage held), so we solve a linear back-off on the
    dynamic share only — idle power cannot be throttled away."""
    draw = pod_draw(instances, pod)
    cap = pod.power_cap_watts
    if draw <= cap:
        return 1.0
    idle_floor = pod.n_chips * pod.chip.idle_watts
    dynamic = draw - idle_floor
    if dynamic <= 0:
        return 1.0
    return max(0.1, (cap - idle_floor) / dynamic)


def co_run(instances: Sequence[InstanceLoad], pod: PodSpec = V5E_POD
           ) -> Tuple[float, float, List[float]]:
    """Run all instances concurrently.
    Returns (makespan_s, energy_J, per-instance effective step times).

    The throttle factor is held at the full-mix value for every instance's
    whole run (re-solving it at each completion is what ``PodSimulator``
    does); energy is exact for these effective times."""
    f = throttle_factor(instances, pod)
    eff = []
    for i in instances:
        # only the compute share of the step stretches under throttling
        t_comp = i.step_time * i.u_compute
        t_rest = i.step_time - t_comp
        eff.append((t_comp / f + t_rest) * i.steps)
    makespan = max(eff) if eff else 0.0
    # energy integrates draw piecewise over completion events: when an
    # instance finishes, its chips fall back to idle draw for the rest of
    # the makespan (pod_draw counts unused chips at idle watts)
    cap = pod.power_cap_watts
    running = list(range(len(instances)))
    energy = 0.0
    prev = 0.0
    for idx in sorted(running, key=lambda i: eff[i]):
        t = eff[idx]
        if t > prev:
            draw = min(pod_draw([instances[i] for i in running], pod), cap)
            energy += draw * (t - prev)
            prev = t
        running.remove(idx)
    return makespan, energy, eff


def serial_run(instance: InstanceLoad, copies: int, pod: PodSpec = V5E_POD
               ) -> Tuple[float, float]:
    """Paper Fig. 5/6 baseline: run ``copies`` sequentially, each on the full
    pod (scaled step time given), idle chips still burn idle power."""
    makespan = instance.step_time * instance.steps * copies
    draw = pod_draw([instance], pod)
    return makespan, draw * makespan
