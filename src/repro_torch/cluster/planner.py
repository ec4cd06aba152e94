"""Bounded best-first planning over the priced action space.

``SearchPolicy`` generalizes the two fixed selection strategies in
``cluster/actions.py`` — ``GreedyCheapestRescue`` (depth 1: commit the
cheapest single rescue) and ``LookAheadPolicy`` (depth 2, first
improvement: one eviction enabler, then the first chain that lands
inside the SLO) — into a budgeted search for the *cheapest*
SLO-preserving chain of up to ``max_depth`` actions. The transactional
``apply``/``rollback`` surface of the Action API is the trial tree:
every enabler is applied inside a recorded undo-log span, deeper
enablers nest LIFO, and every branch is rolled back bit-exactly before
the next sibling is tried, so the search never leaks state. Structural
probe work inside the tree is memoized by the scheduler's ``ProbeCache``
(untouched pods keep their generations across branches), which is what
makes the extra probing affordable at trace scale.

The search prunes three ways, all deterministic:

* **Budget** — ``budget_probes`` caps the structural probe
  consultations (priced + cache hits, the scheduler's
  ``_probes_priced``/``_probe_hits`` deltas) a single rescue may spend
  beyond the root single-action scan. Exhausting the budget stops
  expansion, never unwinds a found incumbent.
* **Admissible lower bound** — a chain of evictions still needs a
  closer, and the cheapest conceivable closer is a free ``Place`` into a
  freed rectangle, so ``g`` (the chain's accumulated action cost) is an
  admissible completion bound: any branch with ``g >= incumbent`` is
  cut. Priced closers only tighten the incumbent when recorded.
* **Dominance** — among sibling enablers on the *same pod*, one that
  costs no less, drains no less and frees no more chips than an
  already-kept sibling is strictly dominated and dropped: every chain
  through it is available no-worse through the dominator.

``RebalanceController`` is the proactive complement: instead of waiting
for a blocked deadline job, it spends a per-tick probe budget at CONTROL
events relocating cheap tenants off the power-starved pod whenever the
pods' power-headroom spread drifts past a threshold — the same
DCN-priced ``MigrateTenant`` moves the reactive autoscaler uses.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Tuple

from repro_torch.configs import get_config, get_shape

from repro_torch.cluster.actions import (Action, GreedyCheapestRescue, Place,
                                         Preempt, RESCUE_KINDS, _FINDERS,
                                         meets_after, select_cheapest,
                                         slo_profiles)

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.cluster.scheduler import ClusterScheduler, JobRecord, PodState

__all__ = ["SearchPolicy", "RebalanceController"]


class SearchPolicy(GreedyCheapestRescue):
    """Budgeted branch-and-bound over eviction chains, cheapest first.

    Chains are ``[enabler_1, ..., enabler_k, closer]`` with
    ``k + 1 <= max_depth``: enablers are beneficiary-less ``Preempt``
    evictions (their probes are pure arithmetic — the priced structural
    work happens when a branch is closed), the closer is a direct
    ``Place`` into the freed space or any enabled single rescue. Chain
    cost is the sum of member action costs; the save drains of the
    enablers serialize over the pod's host links, so a chain's closer is
    probed with the *accumulated* drain as its start delay — a chain can
    never promise an SLO its own traffic breaks. The cheapest complete
    chain wins; ties never arise because the expansion order is total
    (enabler cost, then victim id) and only strict improvements replace
    the incumbent. ``max_depth=2`` explores exactly the look-ahead
    policy's chain shape but keeps searching for the cheapest chain
    where ``LookAheadPolicy`` commits the first improvement; depth 1
    (the root scan) is the greedy policy."""
    name = "search"
    chains_grow = True

    def __init__(self, budget_probes: int = 96, max_depth: int = 3):
        self.budget_probes = budget_probes
        self.max_depth = max_depth

    # -- probe accounting ------------------------------------------------
    def _spent(self, sched: "ClusterScheduler") -> int:
        return sched._probes_priced + sched._probe_hits - self._base

    def rescue(self, sched: "ClusterScheduler", rec: "JobRecord",
               t: float) -> Optional[List[Action]]:
        # Depth 1, always in budget: the greedy single-action scan seeds
        # the incumbent, so search never does worse than greedy.
        options = [_FINDERS[kind](sched, rec, t)
                   for kind in RESCUE_KINDS
                   if sched.spec.enabled(kind)]
        choice = select_cheapest(options)
        self._best_cost = (choice.outcome.cost_s if choice is not None
                           else float("inf"))
        self._best: Optional[Tuple[List[Preempt], Action]] = \
            (([], choice) if choice is not None else None)
        deeper = (self.max_depth >= 2
                  and rec.deadline_s is not None
                  and sched.spec.enabled("preempt")
                  and any(True for _ in slo_profiles(sched, rec, t)))
        if deeper:
            # batch-reprice the candidate space once: every resident
            # victim's (arch, shape) row lands in the PerfModel score
            # memo in one sweep instead of cold misses inside the tree
            pairs = {(r.job.arch, r.job.shape)
                     for pod in sched.pods for r in pod.jobs.values()}
            pairs.add((rec.job.arch, rec.job.shape))
            sched.perf.score_many({get_config(a) for a, _ in pairs},
                                  {get_shape(s) for _, s in pairs})
            self._base = sched._probes_priced + sched._probe_hits
            self._expand(sched, rec, t, chain=[], drain=0.0, g=0.0)
        if self._best is None:
            return None
        enablers, closer = self._best
        if not enablers:            # the greedy single was already cheapest
            closer.apply(sched, t, record=False)
            return [closer]
        # every trial span was rolled back above, so state is bit-exactly
        # pre-rescue: re-applying the recorded chain reproduces the probed
        # trial states (and the closer's bound candidate) deterministically
        delay = 0.0
        for en in enablers:
            delay += en._cost(sched).save_s
            en.apply(sched, t, record=False)
        closer.apply(sched, t, extra_delay=delay, record=False)
        return [*enablers, closer]

    def _expand(self, sched: "ClusterScheduler", rec: "JobRecord", t: float,
                chain: List[Preempt], drain: float, g: float) -> None:
        """Try one more enabler on the current trial state, cheapest
        first, closing and recursing under budget/bound/dominance."""
        kept: List[Tuple[float, float, int, "PodState"]] = []
        enablers = sorted(
            ((en.probe(sched, t), en) for en in
             Preempt.enablers(sched, rec, t)),
            key=lambda p: (p[0].cost_s, p[1].victim_id))
        for out, en in enablers:
            if self._spent(sched) >= self.budget_probes:
                return
            new_g = g + out.cost_s
            if new_g >= self._best_cost:
                # admissible bound: the cheapest remaining single action
                # is a free Place, so no completion can beat the incumbent
                return   # enablers are cost-sorted: siblings only worsen
            freed = en.victim.n_chips
            if any(c <= out.cost_s and d <= out.start_delay_s and f >= freed
                   and pod is en.pod for c, d, f, pod in kept):
                continue   # strictly dominated by a kept same-pod sibling
            new_drain = drain + out.start_delay_s
            if not any(meets_after(rec, t, sc, new_drain)
                       for sc in slo_profiles(sched, rec, t)):
                continue   # the chain's own save traffic blows the SLO
            kept.append((out.cost_s, out.start_delay_s, freed, en.pod))
            en.apply(sched, t)   # recorded trial span
            closer = self._closer(sched, rec, t, new_drain)
            if closer is not None \
                    and new_g + closer.outcome.cost_s < self._best_cost:
                self._best_cost = new_g + closer.outcome.cost_s
                self._best = (chain + [en], closer)
            if len(chain) + 2 < self.max_depth \
                    and self._spent(sched) < self.budget_probes:
                self._expand(sched, rec, t, chain + [en], new_drain, new_g)
            en.rollback(sched)

    def _closer(self, sched: "ClusterScheduler", rec: "JobRecord", t: float,
                drain: float) -> Optional[Action]:
        """Cheapest completion on the trial state: a free direct placement
        into what the evictions freed, else the cheapest enabled rescue —
        the same completion rule as ``LookAheadPolicy._closer``."""
        cands = sched.candidates_for(rec.job, t, rec.deadline_s)
        for cand in cands:
            act = Place(rec, cand)
            out = act.probe(sched, t, extra_delay=drain)
            if out.feasible and out.meets_slo:
                return act
        options = [_FINDERS[kind](sched, rec, t, extra_delay=drain)
                   for kind in RESCUE_KINDS
                   if sched.spec.enabled(kind)]
        return select_cheapest(options)


class RebalanceController:
    """Proactive cross-pod balancing at CONTROL events.

    Reactive rescues only fire when a deadline job is already blocked.
    This controller watches the pods' *power headroom* — the gap between
    the pod power cap and the uncapped modeled draw — and acts on the
    hazard state where the max-min spread exceeds ``spread_watts``
    *and* the coolest pod is also the packed one: every free rectangle
    then sits on the power-tight pod, where the next hot deadline
    arrival will be power-blocked. It spends up to ``budget_probes``
    ``MigrateTenant`` probes per tick moving the cool pod's cheapest
    (least resident state) tenant to a chip-roomier pod — a cool tenant
    adds little draw, so the destination gate passes where a hot
    placement would not — simultaneously narrowing the draw spread and
    freeing a rectangle where the arrival wants it.

    Duck-typed like ``AutoscaleController`` (``spec.interval_s``,
    ``control``, ``finalize``, ``metrics_fields``) so it plugs into
    ``ClusterScheduler(autoscaler=...)`` unchanged; it keeps no
    per-tenant model state, only a cooldown stamp."""

    class _Spec:
        def __init__(self, interval_s: float):
            self.interval_s = interval_s

    def __init__(self, interval_s: float = 300.0, *,
                 spread_watts: float = 500.0, budget_probes: int = 8,
                 cooldown_s: float = 600.0):
        self.spec = self._Spec(interval_s)
        self.spread_watts = spread_watts
        self.budget_probes = budget_probes
        self.cooldown_s = cooldown_s
        self._last_move_s = -float("inf")
        self.moves = 0
        self.probes = 0

    def _headroom(self, sched: "ClusterScheduler",
                  pod: "PodState") -> float:
        return (sched.pod_spec.power_cap_watts
                - pod.sim.draw(capped=False))

    def control(self, sched: "ClusterScheduler", t: float) -> bool:
        from repro_torch.cluster.autoscale import MigrateTenant
        if len(sched.pods) < 2 or t - self._last_move_s < self.cooldown_s:
            return False
        by_headroom = sorted(sched.pods,
                             key=lambda p: (self._headroom(sched, p), p.idx))
        tight, cool = by_headroom[0], by_headroom[-1]
        spread = (self._headroom(sched, cool)
                  - self._headroom(sched, tight))
        if spread <= self.spread_watts:
            return False
        # the hazard state: the *cool* pod is also the packed one, so the
        # only free rectangles sit on the power-tight pod — the next hot
        # deadline arrival will be power-blocked there. Relieve it by
        # moving the cool pod's cheapest tenant to a chip-roomier pod
        # (cool tenants add little draw, so the gate passes where a hot
        # placement would not).
        if cool.partitioner.free_chips() >= max(
                p.partitioner.free_chips()
                for p in sched.pods if p is not cool):
            return False   # the cool pod is not the packing bottleneck
        victims = sorted((r for r in cool.jobs.values()
                          if not r.executed and not r.finished),
                         key=lambda r: (r.resident_bytes, r.job.job_id))
        dests = sorted((d for d in sched.pods if d is not cool),
                       key=lambda d: (-d.partitioner.free_chips(), d.idx))
        budget = self.budget_probes
        for victim in victims:
            for dest in dests:
                if budget <= 0:
                    return False
                if dest.partitioner.free_chips() \
                        <= cool.partitioner.free_chips():
                    continue
                act = MigrateTenant(cool, victim, dest)
                self.probes += 1
                budget -= 1
                if not act.probe(sched, t).feasible:
                    continue
                act.apply(sched, t, record=False)
                self.moves += 1
                self._last_move_s = t
                # one move per tick: re-measure the spread next interval
                return True
        return False

    def finalize(self, sched: "ClusterScheduler", end_s: float) -> None:
        pass

    def metrics_fields(self) -> dict:
        return {"autoscale_resizes": self.moves}
