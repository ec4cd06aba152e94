"""ClusterScheduler — a thin event loop over the Action API.

Each pod is a ``StaticPartitioner`` grid plus a ``core.perfmodel.
PodSimulator`` (and optionally a live ``SliceRuntime`` so serving jobs
execute on the real engine). The loop is discrete-event in virtual seconds:
arrivals and completions are the events. Everything that *changes* cluster
state at an event is a first-class ``Action`` from
``cluster/actions.py`` — ``Place``, ``Repack``, ``Shrink``, ``Grow``,
``Preempt``, ``MigrateAcrossPods`` — each with a uniform
``probe → ActionOutcome`` (feasibility + priced cost + projected SLO
effect via the shared ``PerfModel``) and transactional
``apply()``/``rollback()``. The scheduler itself only:

1. pops events and advances the timeline integrals (energy / busy chips /
   fragmentation),
2. enumerates placement candidates (``PlacementPolicy``) and probes
   ``Place``/``Repack`` for arrivals,
3. hands blocked deadline jobs to a ``SchedulerPolicy``
   (``GreedyCheapestRescue`` or ``LookAheadPolicy``) that selects and
   commits a rescue plan from the ``PolicySpec`` action allowlist,
4. re-drains the queue after completions (queued jobs have first claim on
   freed chips; ``Grow`` actions then absorb what is still free).

All performance and power questions go through the shared ``PerfModel`` /
``PodSimulator`` pair — no roofline or power-model glue lives here, and no
rescue selection does either (that is the policies' job). Beyond plain
packing, the interference surfaces static partitioning does NOT remove
(paper §V) are modeled:

* **Power** — a candidate placement is rejected when the pod simulator's
  predicted throttle with the new instance falls below ``min_throttle``
  (the §V-B shared-cap effect); the job waits instead of dragging every
  co-tenant below the cap. Admissions, completions, repack delays, and
  elastic resizes re-solve the whole pod and re-project every running
  job's finish under the new mix.
* **Fragmentation** — when a queued job fits a pod's total free chips but
  no aligned rectangle (arXiv 2512.16099 stranding), a repack-enabled
  placement policy triggers the ``Repack`` action: the partitioner's
  transactional ``repack()`` plus a modeled migration cost over the pod's
  host links.

Which elastic moves exist at all is the declarative ``PolicySpec``
allowlist: ``"shrink"`` (resize a running batch job to a smaller
profile), ``"preempt"`` (checkpoint-evict a strictly lower-priority batch
job), ``"grow"`` (extend a running job into freed neighbour chips), and
``"migrate"`` (relocate a lower-priority job to another pod over the DCN
— see ``MigrateAcrossPods``). The legacy ``elastic``/``priorities``/
``grow`` boolean kwargs are deprecation shims onto that allowlist and
reproduce the flag-era timelines bit-for-bit.

``frozen_durations=True`` is the compatibility mode: durations are fixed
at admission time with the legacy float arithmetic and never re-solved,
reproducing the fixed-duration scheduler's numbers bit-for-bit. Crafted jobs with
pinned ``duration_s`` skip throttle modeling in both modes so tests stay
exactly deterministic.

Units, everywhere in this module: virtual time and durations in seconds
(nominal = unthrottled work seconds; wall = after throttle stretch and
delays), state volumes in bytes, slice sizes in chips.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs import tenant_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.hw import (PodSpec, V5E_POD, default_mode, ladder_for,
                                 partition_modes)
from repro_torch.core.offload import TwinSpec
from repro_torch.core.partitioner import StaticPartitioner
from repro_torch.core.perfmodel import (InstanceLoad, PerfModel, PodSimulator,
                                        model_for_mode)
from repro_torch.core.slices import PROFILES, get_profile

from repro_torch.cluster.actions import (Grow, Place, PolicySpec, ProbeCache,
                                         Repack, RESCUE_KINDS,
                                         deprecated_flags_spec,
                                         get_scheduler_policy, txn_touch)
from repro_torch.cluster.metrics import ClusterMetrics, summarize
from repro_torch.cluster.placement import (Candidate, PlacementPolicy, get_policy,
                                           ideal_duration)
from repro_torch.cluster.trace import SERVING, Job


ARRIVE = "arrive"
FINISH = "finish"
CONTROL = "control"   # autoscaler tick (only pushed when autoscaler= is set)
TICK = "tick"         # advance-clock point left behind by heap compaction


@dataclass(frozen=True)
class SuspendSnapshot:
    """Progress frozen at checkpoint-eviction time, restored at resume.

    ``work_done``/``work_total`` are nominal (unthrottled) seconds for
    progress jobs; ``fixed_remaining`` is remaining wall seconds for
    pinned/frozen jobs (``pinned`` tells which); ``step_time`` is the
    evicted slice's nominal seconds per step (re-bases a frozen remainder
    onto a different resume profile); ``bytes`` is the checkpoint volume
    written at save time — the restore pays the same bytes back;
    ``delay_remaining`` is unburned wall delay (seconds) from an earlier
    charged migration, still owed after the resume."""
    work_done: float
    work_total: float
    fixed_remaining: Optional[float]
    pinned: bool
    step_time: float
    bytes: int
    delay_remaining: float = 0.0


@dataclass
class JobRecord:
    """Mutable scheduling state of one trace job.

    Units: ``*_s`` fields are virtual seconds, ``resident_bytes`` /
    ``checkpoint_bytes`` / ``dcn_bytes`` are bytes, profiles imply chips.
    ``place_s`` is the *first* placement (queue delay = ``place_s −
    arrival_s``; a checkpoint resume keeps it), ``duration_s`` is the most
    recent admission's modeled remaining duration."""
    job: Job
    deadline_s: Optional[float] = None
    pod_idx: Optional[int] = None
    slice_id: Optional[int] = None
    profile_name: Optional[str] = None
    rung: Optional[str] = None    # priced rung: profile name, "+cpuX.XX" if twin
    origin: Optional[Tuple[int, int]] = None
    place_s: Optional[float] = None
    finish_s: Optional[float] = None
    duration_s: Optional[float] = None
    u_compute: float = 0.0
    step_time_s: float = 0.0
    resident_bytes: int = 0
    finished: bool = False
    executed: bool = False        # ran on a live SliceRuntime tenant
    shrunk: bool = False          # resized to a smaller profile mid-flight
    grown: bool = False           # absorbed freed chips via extend()
    tokens_out: int = 0
    power_deferred: int = 0
    version: int = 0              # bumps invalidate stale finish events
    # checkpoint preemption bookkeeping
    preemptions: int = 0          # times checkpoint-evicted
    resumes: int = 0              # times resumed from a checkpoint
    suspend_s: Optional[float] = None   # last eviction time
    resume_s: Optional[float] = None    # last resume time
    checkpoint_bytes: int = 0     # total save+restore volume paid (bytes)
    checkpoint_delay_s: float = 0.0     # total save+restore seconds paid
    suspended: Optional[SuspendSnapshot] = None  # set while evicted
    # cross-pod migration bookkeeping (MigrateAcrossPods)
    migrations: int = 0           # times relocated to another pod
    migrate_s: Optional[float] = None   # last relocation time
    dcn_bytes: int = 0            # resident state moved over the DCN (bytes)
    dcn_delay_s: float = 0.0      # save+restore seconds paid over the DCN

    @property
    def placed(self) -> bool:
        return self.place_s is not None

    @property
    def n_chips(self) -> int:
        return get_profile(self.profile_name).n_chips if self.profile_name else 0

    def load(self) -> InstanceLoad:
        return InstanceLoad(self.n_chips, self.u_compute, self.step_time_s, 1)


@dataclass
class PodState:
    idx: int
    partitioner: StaticPartitioner
    sim: PodSimulator
    runtime: Optional[object] = None   # serving.SliceRuntime when executing
    jobs: Dict[int, JobRecord] = field(default_factory=dict)       # by job_id
    slice_jobs: Dict[int, JobRecord] = field(default_factory=dict)  # by slice
    gen: int = 0   # pod-level mutation counter (transaction rollbacks)
    # current partition mode (mutable scheduler state): the name of one of
    # the chip's PartitionModes. "fixed" for the v5e family; MI300-class
    # pods boot in the scheduler's base mode and ReconfigurePartition
    # switches it at runtime (undo-log rollback restores it).
    mode: str = "fixed"

    @property
    def generation(self) -> Tuple:
        """Composite structural-validity token for this pod: the pod-level
        counter plus the current partition mode, the partitioner's grid
        generation and the simulator's mix generation. Every mutation a
        rescue probe can observe — grid shape, partition mode (and with it
        the roofline constants and slice ladder), resident-job membership,
        per-job load parameters, power mix, transaction rollback — moves
        at least one component, so equal tuples mean every cached probe
        outcome against this pod is still exact. The ``ProbeCache`` keys
        on this; the mode component is what keeps cached probe cores from
        leaking across a ReconfigurePartition."""
        return (self.gen, self.mode, self.partitioner.generation,
                self.sim.generation)


class EventHeap:
    """The scheduler's event queue with lazy invalidation.

    Re-projection (``_resync``) never edits or scans pending events: it
    bumps the record's version and pushes a fresh finish event, orphaning
    the old entry, which is recognized as stale in O(1) at pop time by
    comparing its pushed version against the record's current one. Entries
    are ``(t, seq, kind, payload)`` — ``seq`` is the monotone push counter
    that breaks time ties deterministically (FIFO among equal times).

    When ``compact=True``, pushes amortize a purge of stale entries once
    they dominate the heap, bounding tuple/payload retention to O(live).
    Purging must not change *when* the event loop advances virtual time:
    the progress/energy accruals are piecewise float sums whose grouping
    is set by pop times, so dropping a stale pop point regroups the
    summation and drifts the pinned goldens by ulps (measured: the
    progress-mode trace0 timeline sha). Compaction therefore keeps each
    purged entry's bare *time* in a side heap of floats (one boxed
    double per entry vs a ~150+-byte tuple chain whose payload pins
    records and versions alive) and replays it as a
    ``TICK`` event — the integration grid, and with it every accumulated
    float, is bit-identical to the uncompacted heap, which is what lets
    compaction default on."""

    def __init__(self, compact: bool = True):
        self._h: List[tuple] = []
        self._seq = 0
        self.compact = compact
        self._compact_at = 256
        self._ticks: List[float] = []   # heapified purged-entry times

    def __len__(self) -> int:
        return len(self._h) + len(self._ticks)

    def __bool__(self) -> bool:
        return bool(self._h) or bool(self._ticks)

    @staticmethod
    def _stale(entry: tuple) -> bool:
        _, _, kind, payload = entry
        if kind != FINISH:
            return False
        rec, version = payload
        return version != rec.version or rec.finished

    def push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._h, (t, self._seq, kind, payload))
        self._seq += 1
        if self.compact and len(self._h) > self._compact_at:
            live = [e for e in self._h if not self._stale(e)]
            if len(live) * 2 <= len(self._h):
                for e in self._h:
                    if self._stale(e):
                        heapq.heappush(self._ticks, e[0])
                heapq.heapify(live)   # (t, seq) order is preserved exactly
                self._h = live
            self._compact_at = max(256, 2 * len(self._h))

    def pop(self) -> tuple:
        # a tick and a real event at the same time: pop the real event
        # first — the tick's only job is advancing the clock, and the
        # second same-t pop advances by dt=0, so the order is untimed
        if self._ticks and (not self._h or self._ticks[0] < self._h[0][0]):
            return (heapq.heappop(self._ticks), -1, TICK, None)
        return heapq.heappop(self._h)


class ClusterScheduler:
    """Discrete-event scheduler for a job trace over ``n_pods`` pods.

    ``policy`` is the *placement* policy (candidate enumeration:
    ``first_fit``/``frag``/``frag_repack``); ``spec`` is the
    ``PolicySpec`` that declares which elastic actions exist and which
    ``SchedulerPolicy`` selects among them. The default spec (no actions,
    greedy selector) reproduces the baseline scheduler; the deprecated
    ``elastic``/``priorities``/``grow`` booleans shim onto
    ``PolicySpec.from_flags``.

    Units: event times and all ``*_s`` quantities are virtual seconds,
    in-pod migrated/checkpointed volumes are bytes priced over the pod's
    aggregate host-link bandwidth (bytes/s), cross-pod volumes over its
    aggregate DCN bandwidth (``PodSpec.dcn_bw``), slice sizes are chips.
    Instances are single-use: one ``run()`` per scheduler."""

    def __init__(self, n_pods: int = 2,
                 policy: Union[str, PlacementPolicy] = "frag_repack",
                 pod: PodSpec = V5E_POD, *,
                 min_throttle: float = 0.8,
                 horizon_s: Optional[float] = None,
                 frozen_durations: bool = False,
                 spec: Optional[PolicySpec] = None,
                 elastic: Optional[bool] = None,
                 priorities: Optional[bool] = None,
                 grow: Optional[bool] = None,
                 perf: Optional[PerfModel] = None,
                 execute_serving: bool = False,
                 device="cuda",
                 serving_config: Optional[Callable[[str], ModelConfig]] = None,
                 serving_slots: int = 2,
                 serving_max_seq: int = 32,
                 serving_max_new: int = 4,
                 snapshot_rollback: bool = False,
                 heap_compaction: bool = True,
                 probe_cache: bool = True,
                 autoscaler=None,
                 twin: Union[bool, TwinSpec] = False,
                 mode: Optional[str] = None):
        self.pod_spec = pod
        self.chip = pod.chip
        # partition-mode state: the chip's mode table and the base mode
        # every pod boots in ("fixed" for v5e — the only mode it has).
        # ReconfigurePartition mutates per-pod PodState.mode at runtime.
        self._modes = partition_modes(pod.chip)
        self.base_mode = mode if mode is not None else default_mode(pod.chip)
        if self.base_mode not in self._modes:
            raise ValueError(
                f"unknown partition mode {self.base_mode!r} for chip "
                f"{self.chip.name!r}; valid: {sorted(self._modes)}")
        self.policy = get_policy(policy) if isinstance(policy, str) else policy
        self.min_throttle = min_throttle
        self.horizon_s = horizon_s
        self.frozen_durations = frozen_durations
        flag_spec = deprecated_flags_spec(elastic, priorities, grow)
        if flag_spec is not None and spec is not None:
            raise ValueError("pass either spec= or the deprecated "
                             "elastic/priorities/grow booleans, not both")
        self.spec = flag_spec if flag_spec is not None \
            else (spec if spec is not None else PolicySpec())
        self.selector = get_scheduler_policy(self.spec.selector)
        # twin-offload rungs (default off): True enables the default
        # TwinSpec, or pass a TwinSpec directly; an explicit perf= wins
        self.twin = (twin if isinstance(twin, TwinSpec)
                     else (TwinSpec() if twin else None))
        # the base-mode model: for the v5e/fixed default this is exactly
        # get_model(pod.chip, twin=...) — same shared object, same memos,
        # every pre-existing pin untouched
        self.perf = (perf if perf is not None
                     else model_for_mode(pod.chip,
                                         self._modes[self.base_mode],
                                         twin=self.twin))
        self.execute_serving = execute_serving
        self.serving_slots = serving_slots
        self.serving_max_seq = serving_max_seq
        self.serving_max_new = serving_max_new
        self.pods = [PodState(i, StaticPartitioner(pod),
                              PodSimulator(pod, frozen=frozen_durations),
                              mode=self.base_mode)
                     for i in range(n_pods)]
        base_ladder = ladder_for(self._modes[self.base_mode])
        if base_ladder != PROFILES:   # granularity-floored mode (MI300 SPX)
            for p in self.pods:
                p.partitioner.set_profiles(base_ladder)
        # the config a live serving tenant runs, by arch; the default is the
        # reference's reduced one
        self.serving_config = (serving_config if serving_config is not None
                               else tenant_config)
        if execute_serving:
            from repro_torch.serving import SliceRuntime
            for p in self.pods:
                p.runtime = SliceRuntime(pod=pod, device=device,
                                         partitioner=p.partitioner)
        # migration paths: in-pod moves cross the pod's host links once,
        # cross-pod moves cross the DCN (both aggregate bytes/s)
        self._pod_host_bw = pod.n_hosts * self.chip.host_link_bw
        self._dcn_bw = pod.dcn_bw
        # timeline integrals
        self._now = 0.0
        self._busy_chip_s = 0.0
        self._frag_s = 0.0
        self._energy_J = 0.0
        # counters
        self._repacks = 0
        self._repack_failures = 0
        self._shrinks = 0
        self._grows = 0
        self._preemptions = 0
        self._resumes = 0
        self._wasted_checkpoint_chip_s = 0.0
        self._migrated_bytes = 0
        self._migration_s = 0.0
        self._migrations = 0
        self._dcn_migrated_bytes = 0
        self._dcn_migration_s = 0.0
        self._reconfigs = 0
        self._power_deferrals = 0
        self._probes = 0          # placement/rescue probes (perf telemetry)
        # rescue-probe structural cores: priced = actually evaluated
        # (grid trial + power solve), hits = served from the ProbeCache.
        # Deliberately NOT in the transaction counter set — a core priced
        # inside a rolled-back trial branch was still priced.
        self._probes_priced = 0
        self._probe_hits = 0
        self.probe_cache = ProbeCache() if probe_cache else None
        self._heap = EventHeap(compact=heap_compaction)
        self._queue: List[JobRecord] = []
        self._queued_ids: set = set()   # id(rec) mirror for _drain sweeps
        self._min_chips: Dict[int, int] = {}  # id(rec) -> cheapest profile
        self._can_rescue = any(self.spec.enabled(k) for k in RESCUE_KINDS)
        self.snapshot_rollback = snapshot_rollback
        self._txns: List[object] = []   # open undo-log transactions (LIFO)
        # the autoscale control loop (cluster/autoscale.py), duck-typed:
        # spec.interval_s, control(sched, t), finalize(sched, end_s),
        # metrics_fields(). None = no CONTROL events, timelines untouched.
        self.autoscaler = autoscaler
        if autoscaler is not None and horizon_s is None:
            raise ValueError("autoscaler= needs horizon_s: the control "
                             "loop ticks over a bounded virtual day")
        self.records: Optional[List[JobRecord]] = None

    # ------------------------------------------------------------------
    # event loop
    # ------------------------------------------------------------------
    def run(self, jobs: Sequence[Job]) -> Tuple[List[JobRecord], ClusterMetrics]:
        """Schedule ``jobs`` to completion (or ``horizon_s`` virtual
        seconds) and return (per-job records, aggregate metrics). Each
        record's deadline is ``arrival + slo_factor × ideal`` seconds,
        where ideal is the job's fastest unthrottled feasible duration."""
        assert self.records is None, "ClusterScheduler instances are single-use"
        records = []
        for job in sorted(jobs, key=lambda j: (j.arrival_s, j.job_id)):
            ideal = ideal_duration(job, self.chip, self.perf)
            rec = JobRecord(job, deadline_s=(
                job.arrival_s + job.slo_factor * ideal
                if ideal is not None else None))
            records.append(rec)
            self._push(job.arrival_s, ARRIVE, rec)
        self.records = records
        if self.autoscaler is not None:
            dt = self.autoscaler.spec.interval_s
            for k in range(1, int(self.horizon_s / dt) + 1):
                self._push(k * dt, CONTROL, None)

        queue = self._queue
        while self._heap:
            t, _, kind, payload = self._heap.pop()
            if self.horizon_s is not None and t > self.horizon_s:
                break
            self._advance(t)
            if kind == TICK:
                continue   # compaction's advance-clock point, nothing else
            if kind == ARRIVE:
                if not self._try_place(payload, t):
                    self._enqueue(payload)
            elif kind == CONTROL:
                if self.autoscaler.control(self, t):
                    # a shrink/migrate may have freed chips a queued
                    # job was waiting for
                    self._drain(queue, t)
            else:
                rec, version = payload
                if version != rec.version or rec.finished:
                    continue  # stale event (a re-solve moved the finish)
                pod = self.pods[rec.pod_idx]
                self._complete(rec, t)
                self._drain(queue, t)
                if self.spec.enabled("grow"):
                    # queued jobs had first claim on the freed chips; a
                    # running neighbour may absorb what is still free
                    self._grow_into_free(pod, t)

        end_s = self.horizon_s if self.horizon_s is not None else self._now
        if end_s > self._now:
            self._advance(end_s)
        autoscale_kw = {}
        if self.autoscaler is not None:
            self.autoscaler.finalize(self, end_s)
            autoscale_kw = self.autoscaler.metrics_fields()
        metrics = summarize(
            self.policy.name, records,
            elapsed_s=end_s,
            total_chips=len(self.pods) * self.pod_spec.n_chips,
            busy_chip_s=self._busy_chip_s,
            frag_time_avg=(self._frag_s / (len(self.pods) * end_s)
                           if end_s > 0 else 0.0),
            energy_J=self._energy_J,
            repacks=self._repacks,
            repack_failures=self._repack_failures,
            shrinks=self._shrinks,
            grows=self._grows,
            preemptions=self._preemptions,
            resumes=self._resumes,
            wasted_checkpoint_chip_s=self._wasted_checkpoint_chip_s,
            migrated_bytes=self._migrated_bytes,
            migration_s=self._migration_s,
            migrations=self._migrations,
            dcn_migrated_bytes=self._dcn_migrated_bytes,
            dcn_migration_s=self._dcn_migration_s,
            reconfigs=self._reconfigs,
            power_deferrals=self._power_deferrals,
            rescue_probes_priced=self._probes_priced,
            probe_cache_hits=self._probe_hits,
            **autoscale_kw,
        )
        return records, metrics

    def _push(self, t: float, kind: str, payload) -> None:
        self._heap.push(t, kind, payload)

    def _revive_finish(self, rec: JobRecord) -> None:
        """Bump ``rec``'s version (orphaning any events pushed by a rolled-
        back action) and, if the record is a live placement, re-issue its
        finish event at the restored time. Called by ``actions.restore``."""
        rec.version += 1
        if (rec.pod_idx is not None and not rec.finished
                and rec.finish_s is not None
                and rec.job.job_id in self.pods[rec.pod_idx].jobs):
            self._push(rec.finish_s, FINISH, (rec, rec.version))

    def _advance(self, t: float) -> None:
        dt = t - self._now
        if dt <= 0:
            return
        for pod in self.pods:
            self._energy_J += pod.sim.draw(capped=True) * dt
            self._busy_chip_s += pod.partitioner.used_chips() * dt
            self._frag_s += pod.partitioner.fragmentation_ratio() * dt
            pod.sim.advance(t)
        self._now = t

    def _drain(self, queue: List[JobRecord], t: float) -> None:
        """Place every queued job that now fits; sweeps repeat until a
        full pass places nothing. A placement may mutate the queue
        underneath the sweep snapshot (a rescue suspends a victim into
        it, or resumes one out of it), so membership is re-checked by
        identity before each attempt — placing a record twice would
        double-admit it."""
        self._queued_ids = {id(q) for q in queue}
        queued_ids = self._queued_ids
        min_chips = self._min_chips
        # With no rescue actions allowed, a job whose cheapest profile
        # exceeds the largest per-pod free-chip count is provably
        # unplaceable (no origin can be free, Repack.find guards itself
        # out, rescue is a no-op), so the sweep can skip its whole probe
        # cascade. Placements only consume chips on this path, so the
        # bound is refreshed after each success and stays exact.
        gate = not self._can_rescue
        max_free = 0
        progressed = True
        while progressed:
            progressed = False
            if gate:
                max_free = max(p.partitioner.free_chips()
                               for p in self.pods)
            for rec in list(queue):
                if id(rec) not in queued_ids:
                    continue   # resumed by a nested rescue this sweep
                if gate:
                    need = min_chips.get(id(rec))
                    if need is None:
                        need = self._min_need(rec)
                    if need < 0 or need > max_free:
                        continue
                if self._try_place(rec, t):
                    self._unqueue(rec)
                    progressed = True
                    if gate:
                        max_free = max(p.partitioner.free_chips()
                                       for p in self.pods)

    def _enqueue(self, rec: JobRecord) -> None:
        if self._txns:
            self._txns[-1].note_queue("add", rec)
        self._queue.append(rec)
        self._queued_ids.add(id(rec))

    def _min_need(self, rec: JobRecord) -> int:
        """Chips of the job's cheapest feasible profile (−1: none fit),
        memoized by record identity — the drain gate's threshold."""
        need = min((sc.profile.n_chips
                    for sc in self.perf.options(rec.job)), default=-1)
        self._min_chips[id(rec)] = need
        return need

    def _unqueue(self, rec: JobRecord) -> None:
        """Remove ``rec`` from the queue by identity (JobRecord equality
        is field-wise, which could alias distinct records)."""
        self._queued_ids.discard(id(rec))
        for i, q in enumerate(self._queue):
            if q is rec:
                if self._txns:
                    self._txns[-1].note_queue("del", rec, i)
                del self._queue[i]
                return

    # ------------------------------------------------------------------
    # partition-mode surface (ReconfigurePartition and mode-aware scoring)
    # ------------------------------------------------------------------
    def mode_model(self, mode_name: str) -> PerfModel:
        """The shared PerfModel of this cluster's chip under partition mode
        ``mode_name`` — the mode's roofline deltas and slice ladder folded
        in. Hits the process-wide model memo, so repeated lookups are
        dict-cheap."""
        return model_for_mode(self.chip, self._modes[mode_name],
                              twin=self.twin)

    def perf_for(self, pod: PodState) -> PerfModel:
        """The PerfModel matching ``pod``'s *current* mode. Base-mode pods
        (every pod, on a fixed-mode chip) get ``self.perf`` itself — the
        exact object pins were recorded against."""
        if pod.mode == self.base_mode:
            return self.perf
        return self.mode_model(pod.mode)

    def candidates_for(self, job, t: float,
                       deadline_s: Optional[float]) -> List[Candidate]:
        """Placement candidates across all pods, each pod scored under its
        current partition mode. With every pod in the base mode (always
        true for v5e and for any run without ReconfigurePartition) this is
        exactly the legacy single-model enumeration — bit-identical
        ordering. A mode-split cluster enumerates per pod and re-sorts
        with the fragmentation-aware ranking (candidates from different
        modes are still comparable: perf-per-chip and deadlines are
        mode-absolute), falling back to plain pod-order concatenation for
        the first-fit baseline."""
        if all(p.mode == self.base_mode for p in self.pods):
            return self.policy.candidates(job, self.pods, self.chip, t,
                                          deadline_s, perf=self.perf)
        cands: List[Candidate] = []
        for pod in self.pods:
            cands.extend(self.policy.candidates(
                job, (pod,), self.chip, t, deadline_s,
                perf=self.perf_for(pod)))
        if self.policy.name != "first_fit":
            cands.sort(key=lambda c: (
                not c.meets_deadline, -c.perf_per_chip, -c.largest_after,
                c.pod_idx, c.origin))
        return cands

    def _is_fixed(self, rec: JobRecord) -> bool:
        """Fixed-duration jobs (pinned or frozen mode) are event-driven and
        never re-projected; only explicit delays move their finish."""
        return self.frozen_durations or rec.job.duration_s is not None

    def _resync(self, pod: PodState, t: float) -> None:
        """Re-project every progress job on the pod after a mix change and
        re-issue the finish events that moved (stale versions are skipped
        by the event loop). No-op in frozen mode."""
        txn_touch(self, pod)
        for jid, fin in pod.sim.finish_times(t).items():
            rec = pod.jobs.get(jid)
            if rec is None or rec.finished or fin == rec.finish_s:
                continue
            rec.finish_s = fin
            rec.version += 1
            self._push(fin, FINISH, (rec, rec.version))

    # ------------------------------------------------------------------
    # placement: probe Place / Repack, then delegate to the SchedulerPolicy
    # ------------------------------------------------------------------
    def _try_place(self, rec: JobRecord, t: float) -> bool:
        """Place ``rec`` now if any action allows it: a ``Place`` on a free
        aligned origin, a ``Repack``, or a rescue plan selected by the
        ``SchedulerPolicy`` from the ``PolicySpec`` action allowlist.
        Returns False → the job queues."""
        if not self._can_rescue:
            # Same infeasibility gate as the _drain sweep, for the
            # arrival path: if every pod has fewer free chips than the
            # job's smallest profile, the full probe cascade below fails
            # without side effects — skip it outright.
            need = self._min_chips.get(id(rec))
            if need is None:
                need = self._min_need(rec)
            if need < 0 or all(p.partitioner.free_chips() < need
                               for p in self.pods):
                return False
        cands = self.candidates_for(rec.job, t, rec.deadline_s)
        self._probes += 1
        power_blocked = False
        for cand in cands:
            act = Place(rec, cand)
            if act.probe(self, t).feasible:
                act.apply(self, t, record=False)   # the loop never rolls back
                return True
            power_blocked = True
        if power_blocked:
            # shrinking (or evicting, or relocating) a victim lowers its
            # pod's dynamic draw, so a rescue can lift the shared cap too
            if self._rescue_and_place(rec, t):
                return True
            if rec.power_deferred == 0:
                self._power_deferrals += 1  # count jobs, not retry attempts
            rec.power_deferred += 1
            return False
        if self.policy.repack_enabled:
            act = Repack.find(self, rec, t, record=False)
            if act is not None:
                act.apply(self, t, record=False)
                return True
        return self._rescue_and_place(rec, t)

    def _rescue_and_place(self, rec: JobRecord, t: float) -> bool:
        """Hand the blocked deadline job to the ``SchedulerPolicy``: it
        probes the allowed actions (probe → price), selects, and commits a
        plan. Returns False → queue (no SLO-preserving plan exists)."""
        plan = self.selector.rescue(self, rec, t)
        if plan is None:
            return False
        if any(a.kind == "preempt" for a in plan):
            # the evicted victim may fit *right now* — a smaller profile,
            # another pod — instead of idling until the next completion
            # event drains the queue
            for r in [q for q in self._queue if q.suspended is not None]:
                if self._try_place(r, t):
                    self._unqueue(r)
        if self.selector.chains_grow and self.spec.enabled("grow"):
            # chain a grow after the rescue: any committed plan may have
            # freed chips (an eviction's leftover, a shrunk victim's old
            # rectangle), and a running neighbour may absorb them now
            # instead of waiting for the next completion event
            for pod in self.pods:
                self._grow_into_free(pod, t)
        return True

    def _power_ok(self, cand: Candidate, rec: JobRecord) -> bool:
        return self._power_ok_profile(self.pods[cand.pod_idx], rec,
                                      cand.profile, cand.terms)

    def _power_ok_profile(self, pod: PodState, rec: JobRecord,
                          profile, terms) -> bool:
        if not pod.jobs:
            return True  # a job alone on a pod is always admitted
        new = InstanceLoad(profile.n_chips, self._u_for(rec, terms),
                          terms.step_time, 1)
        return pod.sim.throttle(new) >= self.min_throttle

    def _u_for(self, rec: JobRecord, terms) -> float:
        if rec.job.u_compute is not None:
            return rec.job.u_compute
        step = terms.step_time
        return terms.t_compute / step if step else 0.0

    def _place(self, rec: JobRecord, cand: Candidate, t: float,
               start_delay: float = 0.0) -> None:
        """Admit ``rec`` on ``cand``'s pod/profile/origin at time ``t``
        (virtual seconds), optionally after ``start_delay`` wall seconds
        of migration or checkpoint traffic. A suspended record (evicted
        earlier) is *resumed*: its snapshotted progress carries over and
        the checkpoint restore volume is paid before work continues."""
        pod = self.pods[cand.pod_idx]
        txn_touch(self, pod, rec)
        job = rec.job
        u = self._u_for(rec, cand.terms)
        duration = job.duration_s
        admit_kw = {}
        if rec.suspended is not None:
            snap = rec.suspended
            restore_s = self.perf.checkpoint_cost(
                snap.bytes, self._pod_host_bw).restore_s
            # restore traffic, plus any migration delay still owed from
            # before the eviction — suspension never forgives a debt
            start_delay += restore_s + snap.delay_remaining
            self._resumes += 1
            self._wasted_checkpoint_chip_s += (cand.profile.n_chips
                                               * restore_s)
            rec.resumes += 1
            rec.resume_s = t
            rec.checkpoint_bytes += snap.bytes
            rec.checkpoint_delay_s += restore_s
            if snap.fixed_remaining is not None and snap.pinned:
                duration = snap.fixed_remaining   # wall-clock contract
            elif snap.fixed_remaining is not None:
                # frozen remainder re-based onto the resume profile
                admit_kw["fixed_remaining"] = (
                    snap.fixed_remaining
                    * cand.terms.step_time / snap.step_time)
            else:
                frac = (snap.work_done / snap.work_total
                        if snap.work_total else 0.0)
                admit_kw["work_done"] = frac * (job.steps
                                                * cand.terms.step_time)
            rec.suspended = None
        finish = pod.sim.admit(
            job.job_id, cand.profile.n_chips, u, cand.terms.step_time,
            job.steps, t, duration_s=duration, start_delay=start_delay,
            **admit_kw)
        rec.pod_idx = pod.idx
        rec.profile_name = cand.profile.name
        rec.rung = cand.rung or cand.profile.name
        rec.origin = cand.origin
        if rec.place_s is None:
            rec.place_s = t   # queue delay measures the FIRST placement
        rec.duration_s = finish - t - start_delay
        rec.finish_s = finish
        rec.u_compute = u
        rec.step_time_s = cand.terms.step_time
        rec.resident_bytes = int(cand.plan.resident_bytes)
        if (job.kind == SERVING and self.execute_serving
                and pod.runtime is not None):
            rec.slice_id = self._start_tenant(rec, pod, cand)
            rec.executed = True
        else:
            alloc = pod.partitioner.allocate(cand.profile, tag=job.tag,
                                             origin=cand.origin)
            rec.slice_id = alloc.slice_id
        pod.jobs[job.job_id] = rec
        pod.slice_jobs[rec.slice_id] = rec
        rec.version += 1
        self._push(rec.finish_s, FINISH, (rec, rec.version))
        if not self.frozen_durations:
            self._resync(pod, t)   # the new tenant slows every co-tenant

    def _complete(self, rec: JobRecord, t: float) -> None:
        pod = self.pods[rec.pod_idx]
        rec.finished = True
        rec.finish_s = t
        pod.jobs.pop(rec.job.job_id)
        pod.slice_jobs.pop(rec.slice_id)
        pod.sim.remove(rec.job.job_id)
        if rec.executed:
            pod.runtime.remove_tenant(rec.job.tag)
        else:
            pod.partitioner.release(rec.slice_id)
        if not self.frozen_durations:
            self._resync(pod, t)   # survivors speed back up

    # ------------------------------------------------------------------
    # shared pricing mechanics the actions call
    # ------------------------------------------------------------------
    def _migration_cost(self, pod: PodState, moved: Dict[int, tuple],
                        t: float) -> float:
        """Seconds to migrate the moved slices' resident state across the
        pod's host links; stretches the moved running jobs by the same
        amount (their completion events are re-issued)."""
        moved_bytes = sum(pod.slice_jobs[sid].resident_bytes
                          for sid in moved if sid in pod.slice_jobs)
        victims = [pod.slice_jobs[sid] for sid in moved
                   if sid in pod.slice_jobs
                   and not pod.slice_jobs[sid].finished]
        return self._charge_migration(pod, moved_bytes, victims, t)

    def _charge_migration(self, pod: PodState, moved_bytes: int,
                          victims: Sequence[JobRecord], t: float) -> float:
        """Price ``moved_bytes`` over the pod's host links and stretch the
        given running records by the resulting delay — the single pricing
        path for in-pod repack, shrink, and grow migrations."""
        txn_touch(self, pod)
        t_mig = moved_bytes / self._pod_host_bw
        self._migrated_bytes += moved_bytes
        self._migration_s += t_mig
        if t_mig > 0:
            for r in victims:
                pod.sim.delay(r.job.job_id, t_mig)
                if self._is_fixed(r):
                    r.finish_s += t_mig
                    r.version += 1
                    self._push(r.finish_s, FINISH, (r, r.version))
            if not self.frozen_durations:
                self._resync(pod, t)
        return t_mig

    def _reissue_after_resize(self, pod: PodState, rec: JobRecord,
                              t: float) -> None:
        """Frozen durations never self-re-project, but a resize re-bases
        the remaining frozen wall time — re-issue the finish event."""
        if not (self.frozen_durations and rec.job.duration_s is None):
            return
        txn_touch(self, pod)
        fin = pod.sim.projected_finish(rec.job.job_id, t)
        if fin != rec.finish_s:
            rec.finish_s = fin
            rec.version += 1
            self._push(fin, FINISH, (rec, rec.version))

    # ------------------------------------------------------------------
    # elastic grow sweep (the Grow action, after completions and — under
    # the look-ahead policy — after rescue plans that freed chips)
    # ------------------------------------------------------------------
    def _grow_into_free(self, pod: PodState, t: float) -> None:
        """Let running progress jobs absorb still-free neighbouring chips.
        Deterministic order (job id); each job takes at most one grow per
        sweep."""
        for rec in sorted(pod.jobs.values(), key=lambda r: r.job.job_id):
            if rec.executed or rec.finished or rec.job.duration_s is not None:
                continue   # pinned wall-clock jobs gain nothing from chips
            act = Grow.find(self, pod, rec, t, record=False)
            if act is not None:
                act.apply(self, t, record=False)

    # ------------------------------------------------------------------
    # live serving execution
    # ------------------------------------------------------------------
    def _start_tenant(self, rec: JobRecord, pod: PodState,
                      cand: Candidate) -> int:
        """Admit the serving job as a real SliceRuntime tenant (the
        ``serving_config`` of its arch on the runtime's device, same profile
        and origin the scheduler chose) and drain its requests through the
        live engine."""
        from repro_torch.serving import Request, TenantSpec
        job = rec.job
        cfg = self.serving_config(job.arch)
        tenant = pod.runtime.add_tenant(TenantSpec(
            name=job.tag, cfg=cfg, profile=cand.profile,
            origin=cand.origin, slots=self.serving_slots,
            max_seq=self.serving_max_seq, seed=job.job_id))
        if job.requests:
            rng = np.random.default_rng(1000 + job.job_id)
            reqs = [Request(i, rng.integers(
                        0, cfg.vocab_size,
                        size=int(rng.integers(4, 9))).astype(np.int32),
                        self.serving_max_new)
                    for i in range(job.requests)]
            pod.runtime.submit(job.tag, reqs)
            while not tenant.engine.idle:
                tenant.engine.tick()
            rec.tokens_out = tenant.engine.stats.tokens_out
        return tenant.alloc.slice_id
