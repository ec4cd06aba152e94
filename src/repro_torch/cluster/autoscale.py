"""SLO-driven autoscaling of serving tenants over the priced Action API.

The control loop over the scheduler's elastic mechanisms: every control
interval the ``AutoscaleController`` folds one interval of seeded
arrivals (``loadgen``) into a per-tenant queue model, reads the signals
(virtual queue wait p50/p99, queue depth, admission rejections,
utilization), and — under hysteresis bands with per-tenant cooldowns
and a chip-hours budget — resizes tenants through the transactional
actions:

* **scale up** — ``Grow.find(..., ascending=True, max_chips=...)``
  opens a recorded transaction, the budget check runs against the
  *priced* outcome, and the controller either commits or rolls the
  grid extension back (a denied grow leaves no trace);
* **scale up, blocked locally** — ``MigrateTenant`` relocates the hot
  tenant itself to the pod with headroom (the beneficiary-less variant
  of ``MigrateAcrossPods``), so the next interval's grow has room;
* **scale down** — ``ShrinkTenant`` drops one profile rung in place
  (the beneficiary-less ``Shrink``), but only when the *projected*
  utilization on the smaller slice still clears the low watermark —
  the hysteresis gap that, together with the cooldown, makes
  grow/shrink flapping structurally impossible.

The queue model is an interval-batched Lindley recursion on the
virtual waiting time ``W``: with ``A`` arrivals over an interval of
``dt`` seconds and modeled service rate ``mu`` (``req_per_step`` per
decode step of the tenant's *current* slice — growing the slice is
what raises ``mu``), ``W' = max(0, W + A/mu − dt)``. ``W'`` is the
p99-wait signal (the worst backlogged request), the interval midpoint
``(W + W')/2`` the p50. Deterministic, O(1) per tenant-interval, and
bit-identical across replays of the same seed.

``mode="observe"`` runs the same signals without issuing any action —
the fixed-provisioning baseline in the day-in-the-life benchmark, so
both sides of the chip-hours-vs-p99 comparison report identical
latency accounting.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.slices import get_profile
from repro_torch.cluster.actions import (Action, ActionOutcome, Grow,
                                         MigrateAcrossPods, _realloc_victim)
from repro_torch.cluster.loadgen import LoadCurve, arrival_counts

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.cluster.scheduler import ClusterScheduler, JobRecord, PodState

__all__ = ["AutoscaleSpec", "AutoscaleController", "TenantSignals",
           "ShrinkTenant", "MigrateTenant"]


@dataclass(frozen=True)
class AutoscaleSpec:
    """Knobs of the control loop. Watermarks are utilizations
    (arrival rate / modeled service rate); the hysteresis gap between
    ``hi`` and ``lo`` plus the per-tenant ``cooldown_s`` is the
    anti-flapping guarantee."""
    interval_s: float = 300.0       # control period
    slo_p99_s: float = 60.0         # p99 queue-wait target
    hi_watermark: float = 0.70      # scale up above this utilization
    lo_watermark: float = 0.35      # scale down only below this (projected)
    cooldown_s: float = 1500.0      # min seconds between actions per tenant
    req_per_step: float = 1.0       # requests retired per decode step
    min_chips: int = 16             # smallest profile a shrink may reach
    max_chips: int = 128            # largest profile a grow may reach
    chip_hours_budget: Optional[float] = None   # cap on serving chip-hours
    max_queue: Optional[float] = None           # admission bound (requests)
    ema_alpha: float = 0.5          # smoothing of the utilization signal
    mode: str = "hysteresis"        # "hysteresis" acts, "observe" only watches


@dataclass
class TenantSignals:
    """What the controller saw for one tenant over one interval."""
    queue_depth: float
    wait_p50_s: float
    wait_p99_s: float
    rho: float                      # smoothed arrival rate / service rate
    rejected: float                 # requests dropped at the admission bound
    rate_rps: float


@dataclass
class _TenantState:
    wait_s: float = 0.0             # Lindley virtual waiting time
    ema_rate: Optional[float] = None
    rejected: float = 0.0
    last_action_t: float = -math.inf


class ShrinkTenant(Action):
    """Drop a running serving tenant one profile rung in place — the
    beneficiary-less ``Shrink``: same in-place rectangle swap
    (``_realloc_victim``), same host-link pricing of the re-planned
    resident bytes, but the freed chips *are* the win (fewer chip-hours)
    rather than an origin for somebody else."""
    kind = "shrink"

    def __init__(self, rec: "JobRecord", pod: "PodState", small):
        super().__init__(rec)
        self.pod = pod
        self.small = small

    @classmethod
    def find(cls, sched: "ClusterScheduler", pod: "PodState",
             rec: "JobRecord", t: float,
             min_chips: int = 16) -> Optional["ShrinkTenant"]:
        """One rung down: the largest profile strictly smaller than the
        tenant's current one, floored at ``min_chips``."""
        smaller = [sc for sc in sched.perf.options(rec.job, ignore_pin=True)
                   if min_chips <= sc.profile.n_chips < rec.n_chips]
        if not smaller:
            return None
        # equal-chips tie (a profile and its twin rung): prefer the faster
        # step — the twin rung keeps utilization higher on the same chips
        small = max(smaller,
                    key=lambda sc: (sc.profile.n_chips, -sc.step_time))
        act = cls(rec, pod, small)
        act.probe(sched, t)
        return act

    def probe(self, sched, t, extra_delay=0.0) -> ActionOutcome:
        # power-of-two profile sides: a smaller profile always fits at
        # the tenant's own origin, so a self-shrink is always feasible
        mig_s = int(self.small.plan.resident_bytes) / sched._pod_host_bw
        self.outcome = ActionOutcome(True, cost_s=mig_s,
                                     start_delay_s=mig_s + extra_delay)
        return self.outcome

    def apply(self, sched, t, extra_delay=0.0, record=True) -> None:
        self._begin(sched, record)
        pod, rec, small = self.pod, self.rec, self.small
        applied = _realloc_victim(sched, pod, rec, small.profile)
        assert applied, "a smaller power-of-two profile fits in place"
        sched._shrinks += 1
        moved_bytes = int(small.plan.resident_bytes)
        rec.profile_name = small.profile.name
        rec.rung = small.rung
        rec.u_compute = sched._u_for(rec, small.terms)
        rec.step_time_s = small.step_time
        rec.resident_bytes = moved_bytes
        rec.shrunk = True
        pod.sim.resize(rec.job.job_id, small.profile.n_chips,
                       rec.u_compute, small.step_time)
        sched._charge_migration(pod, moved_bytes, [rec], t)
        sched._reissue_after_resize(pod, rec, t)


class MigrateTenant(MigrateAcrossPods):
    """Relocate the hot tenant *itself* to a pod with more headroom —
    the beneficiary-less ``MigrateAcrossPods`` (the parent's DCN-priced
    ``_relocate`` does the move; nobody takes the drained rectangle).
    The fallback when a grow finds no local rectangle extension: next
    interval, the grow retries on the roomier pod."""
    kind = "migrate"

    def __init__(self, pod: "PodState", victim: "JobRecord",
                 dest: "PodState"):
        Action.__init__(self, None)
        self.src = pod
        self.victim = victim
        self.dest = dest
        self.sc = None
        self.dest_origin: Optional[Tuple[int, int]] = None

    @classmethod
    def find(cls, sched: "ClusterScheduler", pod: "PodState",
             rec: "JobRecord", t: float) -> Optional["MigrateTenant"]:
        """Destination pods by descending free chips (index breaks ties);
        only strictly-roomier pods qualify, which rules out ping-pong
        between equally loaded pods."""
        dests = sorted((d for d in sched.pods if d is not pod),
                       key=lambda d: (-d.partitioner.free_chips(), d.idx))
        for dest in dests:
            if dest.partitioner.free_chips() <= pod.partitioner.free_chips():
                continue
            act = cls(pod, rec, dest)
            if act.probe(sched, t).feasible:
                return act
        return None

    def probe(self, sched, t, extra_delay=0.0) -> ActionOutcome:
        profile = get_profile(self.victim.profile_name)
        origins = self.dest.partitioner.origins_for(profile)
        if not origins:
            self.outcome = ActionOutcome(
                False, reason="destination pod has no aligned origin for "
                              "the tenant's profile")
            return self.outcome
        if not self._dest_power_ok(sched):
            self.outcome = ActionOutcome(
                False, reason="tenant fails the destination power gate")
            return self.outcome
        self.dest_origin = origins[0]
        cost = self._cost(sched)
        self.outcome = ActionOutcome(True, cost_s=cost.total_s,
                                     start_delay_s=cost.total_s + extra_delay)
        return self.outcome

    def apply(self, sched, t, extra_delay=0.0, record=True) -> None:
        self._begin(sched, record)
        self._relocate(sched, t)


class AutoscaleController:
    """The closed loop: per-tenant load curves in, priced resize actions
    out. Handed to ``ClusterScheduler(autoscaler=...)``, which fires
    ``control`` every ``spec.interval_s`` of virtual time and folds
    ``metrics_fields`` into the run's ``ClusterMetrics``."""

    def __init__(self, curves: Dict[int, LoadCurve],
                 spec: Optional[AutoscaleSpec] = None, *, seed: int = 0):
        self.curves = dict(curves)
        self.spec = spec if spec is not None else AutoscaleSpec()
        self.seed = seed
        # (t, job_id, kind) for every committed action — the flapping audit
        self.action_log: List[Tuple[float, int, str]] = []
        self.signal_log: List[Tuple[float, int, TenantSignals]] = []
        self._states: Dict[int, _TenantState] = {}
        self._arrivals: Optional[Dict[int, np.ndarray]] = None
        self._last_t = 0.0
        self._chip_s = 0.0              # exact serving chips × seconds
        self._wait_samples: List[float] = []
        self._hits = 0
        self._intervals = 0
        self._resizes = 0
        self._grows = 0
        self._shrinks = 0
        self._migrations = 0
        self._budget_denials = 0

    # ------------------------------------------------------------------
    # the control tick
    # ------------------------------------------------------------------
    def control(self, sched: "ClusterScheduler", t: float) -> bool:
        """One control interval at virtual time ``t``. Returns True when
        any action committed (the scheduler then re-drains its queue —
        a shrink may have freed chips a queued job wants)."""
        spec = self.spec
        recs = self._live(sched)
        dt = t - self._last_t
        if dt > 0:
            # chips held since the last tick: resizes only ever happen at
            # control ticks, so the piecewise-constant integral is exact
            self._chip_s += sum(r.n_chips for r in recs.values()) * dt
        self._ensure_arrivals(sched)
        k = int(round(t / spec.interval_s)) - 1
        committed = False
        for jid in sorted(recs):
            rec = recs[jid]
            st = self._states.setdefault(jid, _TenantState())
            arr = self._arrivals[jid]
            a = int(arr[k]) if 0 <= k < arr.shape[0] else 0
            mu = spec.req_per_step / rec.step_time_s
            w_prev = st.wait_s
            w = max(0.0, w_prev + a / mu - spec.interval_s)
            rejected = 0.0
            if spec.max_queue is not None and w * mu > spec.max_queue:
                rejected = w * mu - spec.max_queue
                w = spec.max_queue / mu
            st.wait_s = w
            st.rejected += rejected
            rate = a / spec.interval_s
            st.ema_rate = (rate if st.ema_rate is None else
                           spec.ema_alpha * rate
                           + (1.0 - spec.ema_alpha) * st.ema_rate)
            sig = TenantSignals(queue_depth=w * mu,
                                wait_p50_s=0.5 * (w_prev + w),
                                wait_p99_s=w, rho=st.ema_rate / mu,
                                rejected=rejected, rate_rps=rate)
            self.signal_log.append((t, jid, sig))
            self._intervals += 1
            self._wait_samples.append(sig.wait_p99_s)
            if sig.wait_p99_s <= spec.slo_p99_s:
                self._hits += 1
            if spec.mode != "hysteresis":
                continue
            if t - st.last_action_t < spec.cooldown_s:
                continue
            if (sig.wait_p99_s > spec.slo_p99_s or rejected > 0
                    or sig.rho > spec.hi_watermark):
                committed |= self._scale_up(sched, rec, st, t)
            elif sig.rho < spec.lo_watermark:
                committed |= self._scale_down(sched, rec, st, t)
        self._last_t = t
        return committed

    def finalize(self, sched: "ClusterScheduler", end_s: float) -> None:
        """Close the chip-seconds integral at the horizon."""
        if end_s > self._last_t:
            recs = self._live(sched)
            self._chip_s += (sum(r.n_chips for r in recs.values())
                             * (end_s - self._last_t))
            self._last_t = end_s

    def metrics_fields(self) -> Dict[str, float]:
        """The autoscale columns ``summarize`` folds into ClusterMetrics."""
        waits = np.asarray(self._wait_samples, dtype=float)
        chip_h = self._chip_s / 3600.0
        return dict(
            serving_p50_s=(float(np.percentile(waits, 50))
                           if waits.size else 0.0),
            serving_p99_s=(float(np.percentile(waits, 99))
                           if waits.size else 0.0),
            serving_slo_hit_rate=(self._hits / self._intervals
                                  if self._intervals else 0.0),
            serving_chip_hours=chip_h,
            chip_hours_per_slo_hit=(chip_h / self._hits
                                    if self._hits else 0.0),
            autoscale_resizes=self._resizes,
        )

    # ------------------------------------------------------------------
    # decisions
    # ------------------------------------------------------------------
    def _scale_up(self, sched, rec, st: _TenantState, t: float) -> bool:
        pod = sched.pods[rec.pod_idx]
        act = Grow.find(sched, pod, rec, t, record=True,
                        max_chips=self.spec.max_chips, ascending=True)
        if act is None:
            return self._migrate_toward_headroom(sched, pod, rec, st, t)
        if not self._within_budget(sched, rec, act.sc.profile.n_chips, t):
            # the priced probe already extended the grid inside its
            # transaction — a budget denial rolls the extension back
            act.rollback(sched)
            self._budget_denials += 1
            return False
        act.apply(sched, t, record=True)
        act.commit(sched)
        self._grows += 1
        self._log(t, rec, "grow", st)
        return True

    def _scale_down(self, sched, rec, st: _TenantState, t: float) -> bool:
        pod = sched.pods[rec.pod_idx]
        act = ShrinkTenant.find(sched, pod, rec, t,
                                min_chips=self.spec.min_chips)
        if act is None:
            return False
        mu_small = self.spec.req_per_step / act.small.step_time
        if (st.ema_rate is not None
                and st.ema_rate / mu_small >= self.spec.lo_watermark):
            return False    # the smaller slice would leave no headroom
        act.apply(sched, t, record=False)
        self._shrinks += 1
        self._log(t, rec, "shrink", st)
        return True

    def _migrate_toward_headroom(self, sched, pod, rec,
                                 st: _TenantState, t: float) -> bool:
        act = MigrateTenant.find(sched, pod, rec, t)
        if act is None:
            return False
        act.apply(sched, t, record=False)
        self._migrations += 1
        self._log(t, rec, "migrate", st)
        return True

    def _within_budget(self, sched, rec, new_chips: int, t: float) -> bool:
        if self.spec.chip_hours_budget is None:
            return True
        chips_after = (sum(r.n_chips for r in self._live(sched).values())
                       - rec.n_chips + new_chips)
        horizon = sched.horizon_s
        projected = (self._chip_s
                     + chips_after * max(0.0, horizon - t)) / 3600.0
        return projected <= self.spec.chip_hours_budget

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------
    def _log(self, t: float, rec, kind: str, st: _TenantState) -> None:
        self.action_log.append((t, rec.job.job_id, kind))
        st.last_action_t = t
        self._resizes += 1

    def _live(self, sched) -> Dict[int, "JobRecord"]:
        return {r.job.job_id: r
                for pod in sched.pods for r in pod.jobs.values()
                if r.job.job_id in self.curves and not r.finished}

    def _ensure_arrivals(self, sched) -> None:
        if self._arrivals is not None:
            return
        n = int(math.ceil(sched.horizon_s / self.spec.interval_s - 1e-9))
        self._arrivals = {
            jid: arrival_counts(curve, self.spec.interval_s, n,
                                seed=(self.seed, jid))
            for jid, curve in sorted(self.curves.items())}
