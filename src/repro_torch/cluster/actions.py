"""The Action API — priced, transactional scheduler actions + policies.

Every way the cluster scheduler may mutate cluster state is a first-class
``Action`` object with one uniform life cycle:

    probe(sched, t) -> ActionOutcome     feasibility + priced cost +
                                         projected SLO effect (PerfModel)
    apply(sched, t)                      commit, recording a transaction
    rollback(sched)                      exact inverse of the last apply

``probe`` never changes observable state (grid trials are rolled back
through the partitioner's transaction primitives); ``apply`` opens a
copy-on-write undo-log ``Transaction`` first, so ``rollback`` restores
partitioner rectangles, the ``PodSimulator`` job sets, and pod power
draw bit-exactly — the property ``tests/test_actions.py`` pins. The log
saves state at first touch (O(touched pods/records), not O(cluster) —
what keeps look-ahead trials cheap on 100k-job traces); the legacy
full-snapshot path (``capture``/``restore``) is kept behind
``ClusterScheduler(snapshot_rollback=True)`` as the equivalence oracle.
That transactionality is what makes a look-ahead policy cheap:
trial-apply an action, probe what it enables, roll back if the chain
goes nowhere. Commit-only call sites pass ``record=False`` to skip
recording (see ``Action``).

The concrete actions:

* ``Place``   — admit a queued job on a scored ``Candidate`` (power-gated).
* ``Repack``  — transactional in-pod defragmentation (``repack()``), priced
  as the moved slices' resident bytes over the pod's host links.
* ``Shrink``  — resize a running batch job to a smaller profile (MISO-style
  online re-selection), priced as a host-link migration.
* ``Preempt`` — checkpoint-evict a strictly lower-priority batch job
  (``PerfModel.checkpoint_cost`` save/restore over the host links); also
  usable as a pure *enabler* (no beneficiary) by the look-ahead policy.
* ``Grow``    — extend a running job into free neighbour chips
  (``StaticPartitioner.extend``), priced like a shrink.
* ``MigrateAcrossPods`` — relocate a running lower-priority job to another
  pod over the **DCN** (``PodSpec.dcn_bw``: ``n_hosts`` NICs at
  ``ChipSpec.dcn_link_bw`` = 12.5e9 bytes/s each): the same
  ``PerfModel.checkpoint_cost`` save/restore pair as a preemption, priced
  over the DCN instead of the host links, except the victim never
  suspends — it resumes on the destination pod in the same event. This is
  the global load-balancing move in-pod rescues cannot express.

Selection is delegated to a ``SchedulerPolicy``: ``GreedyCheapestRescue``
reproduces the legacy ``cheapest_rescue`` comparator (cheapest priced
action wins; ties break least-disruptive: shrink < migrate < preempt),
``LookAheadPolicy`` may chain two actions (evict an enabler victim, then
place/rescue into what that frees — and it grows running neighbours into
rescue leftovers instead of waiting for the next completion event). Which
actions a scheduler may use at all is the declarative ``PolicySpec``
allowlist; the legacy ``elastic``/``priorities``/``grow`` booleans map
onto it via ``PolicySpec.from_flags`` (deprecation shims in
``ClusterScheduler``).

Units: times/costs in virtual seconds, volumes in bytes, slices in chips.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, fields as dc_fields, replace
from typing import (TYPE_CHECKING, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from repro_torch.core.perfmodel import InstanceLoad, PerfScore
from repro_torch.core.slices import get_profile

from repro_torch.cluster.placement import Candidate, candidate_on, modeled_duration
from repro_torch.cluster.trace import BATCH

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.cluster.scheduler import ClusterScheduler, JobRecord, PodState

# ---------------------------------------------------------------------------
# the declarative policy surface
# ---------------------------------------------------------------------------
RESCUE_KINDS = ("shrink", "preempt", "migrate", "reconfigure")
ACTION_KINDS = ("shrink", "preempt", "grow", "migrate", "reconfigure")
SCHEDULER_POLICY_NAMES = ("greedy", "lookahead", "search")

# deterministic tie-break among equally priced rescues: prefer the least
# disruptive — a shrink keeps the victim running in place, a migration
# keeps it running elsewhere, a preemption suspends it entirely, and a
# partition reconfigure drains a whole pod *and* pays mode-switch downtime
_DISRUPTION_RANK = {"shrink": 0, "migrate": 1, "preempt": 2,
                    "reconfigure": 3}


def parse_actions(spec: str) -> Tuple[str, ...]:
    """``"shrink,preempt"`` -> validated, canonically ordered action names.
    Empty string -> no elastic actions (placement/repack still apply)."""
    names = [n.strip() for n in spec.split(",") if n.strip()]
    unknown = [n for n in names if n not in ACTION_KINDS]
    if unknown:
        raise ValueError(f"unknown action(s) {unknown}; "
                         f"valid: {list(ACTION_KINDS)}")
    return tuple(k for k in ACTION_KINDS if k in names)


@dataclass(frozen=True)
class PolicySpec:
    """Declarative scheduler configuration: which reconfiguration actions
    are allowed (``actions`` ⊆ ``ACTION_KINDS``) and which
    ``SchedulerPolicy`` selects among them (``selector``).

    ``PolicySpec()`` is the baseline scheduler (place + policy-gated repack
    only); ``PolicySpec.from_flags(elastic=..., priorities=..., grow=...)``
    maps the deprecated booleans onto the allowlist."""
    selector: str = "greedy"
    actions: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.selector not in SCHEDULER_POLICY_NAMES:
            raise ValueError(f"unknown selector {self.selector!r}; valid: "
                             f"{list(SCHEDULER_POLICY_NAMES)}")
        unknown = [a for a in self.actions if a not in ACTION_KINDS]
        if unknown:
            raise ValueError(f"unknown action(s) {unknown}; "
                             f"valid: {list(ACTION_KINDS)}")
        # canonical order + dedup so specs compare by meaning
        object.__setattr__(
            self, "actions",
            tuple(k for k in ACTION_KINDS if k in self.actions))

    @classmethod
    def from_flags(cls, *, elastic: bool = False, priorities: bool = False,
                   grow: bool = False) -> "PolicySpec":
        """The legacy boolean surface: ``elastic`` -> shrink,
        ``priorities`` -> preempt, ``grow`` -> grow."""
        actions = []
        if elastic:
            actions.append("shrink")
        if priorities:
            actions.append("preempt")
        if grow:
            actions.append("grow")
        return cls(selector="greedy", actions=tuple(actions))

    def enabled(self, kind: str) -> bool:
        return kind in self.actions


def deprecated_flags_spec(elastic, priorities, grow) -> Optional[PolicySpec]:
    """Shim for ``ClusterScheduler(elastic=…, priorities=…, grow=…)``:
    warn once per call site and fold the booleans into a ``PolicySpec``.
    Returns ``None`` when no flag was passed (all still ``None``)."""
    if elastic is None and priorities is None and grow is None:
        return None
    warnings.warn(
        "ClusterScheduler(elastic=, priorities=, grow=) is deprecated; "
        "pass spec=PolicySpec(actions=(...)) instead "
        "(elastic->'shrink', priorities->'preempt', grow->'grow')",
        DeprecationWarning, stacklevel=3)
    return PolicySpec.from_flags(elastic=bool(elastic),
                                 priorities=bool(priorities),
                                 grow=bool(grow))


# ---------------------------------------------------------------------------
# outcomes + transactions
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ActionOutcome:
    """What one probed action would do, before anyone pays for it.

    ``cost_s`` is the priced data movement in seconds (host links for
    in-pod moves, DCN for cross-pod), ``start_delay_s`` the wall delay the
    beneficiary would pay before starting, ``projected_finish_s`` its
    modeled finish (via the shared PerfModel), and ``meets_slo`` whether
    that finish makes the deadline (``None`` when there is no beneficiary
    or no deadline). ``reason`` says why an infeasible probe failed."""
    feasible: bool
    cost_s: float = 0.0
    start_delay_s: float = 0.0
    projected_finish_s: Optional[float] = None
    meets_slo: Optional[bool] = None
    reason: str = ""


_COUNTERS = ("_repacks", "_repack_failures", "_shrinks", "_grows",
             "_preemptions", "_resumes", "_wasted_checkpoint_chip_s",
             "_migrated_bytes", "_migration_s", "_power_deferrals",
             "_migrations", "_dcn_migrated_bytes", "_dcn_migration_s",
             "_reconfigs")


def capture(sched: "ClusterScheduler",
            extra: Sequence["JobRecord"] = ()) -> dict:
    """Snapshot everything an action may mutate: per-pod partitioner state
    (grid, allocation table — object identities preserved so live
    ``SliceRuntime`` tenants keep their ``SliceAllocation``), simulator
    job sets, the scheduler queue, counters, and every reachable
    ``JobRecord``'s fields (``version`` excepted — versions only ever
    advance, so stale finish events stay stale across a rollback).
    ``extra`` adds records not yet reachable from a pod or the queue —
    the beneficiary an action is about to place."""
    from repro_torch.cluster.scheduler import JobRecord
    pods = []
    recset: Dict[int, "JobRecord"] = {}
    for rec in extra:
        if rec is not None:
            recset[id(rec)] = rec
    for pod in sched.pods:
        pods.append(_save_pod(pod))
        for rec in pod.jobs.values():
            recset[id(rec)] = rec
    for rec in sched._queue:
        recset[id(rec)] = rec
    rec_fields = [f.name for f in dc_fields(JobRecord) if f.name != "version"]
    return {
        "pods": pods,
        "queue": list(sched._queue),
        "counters": {n: getattr(sched, n) for n in _COUNTERS},
        "records": [(rec, {k: getattr(rec, k) for k in rec_fields})
                    for rec in recset.values()],
        "rec_fields": rec_fields,
    }


def restore(sched: "ClusterScheduler", snap: dict) -> None:
    """Exact inverse of every mutation since the matching ``capture``.

    Record versions are *bumped*, not restored (monotone versions are what
    keeps ghost finish events pushed during the rolled-back span stale
    forever), and live placements get their finish event re-issued at the
    restored time."""
    for pod, ps in zip(sched.pods, snap["pods"]):
        _restore_pod(pod, ps)
    sched._queue[:] = snap["queue"]
    sched._queued_ids = {id(r) for r in sched._queue}
    for name, value in snap["counters"].items():
        setattr(sched, name, value)
    for rec, saved in snap["records"]:
        for k, v in saved.items():
            setattr(rec, k, v)
        sched._revive_finish(rec)


def _save_pod(pod: "PodState") -> dict:
    """Full copy-on-write snapshot of one pod: partitioner state (grid,
    allocation table — object identities preserved so live tenants keep
    their ``SliceAllocation``), simulator job set, and record membership
    dicts."""
    part = pod.partitioner
    return {
        "grid": part._grid.copy(),
        "next_id": part._next_id,
        "allocs": {sid: (a, a.profile, a.origin, a.devices)
                   for sid, a in part.allocations.items()},
        "sim_now": pod.sim.now,
        "sim_jobs": {k: replace(j) for k, j in pod.sim.jobs.items()},
        "jobs": dict(pod.jobs),
        "slice_jobs": dict(pod.slice_jobs),
        "mode": pod.mode,
        "profiles": part.profiles,
    }


def _restore_pod(pod: "PodState", ps: dict) -> None:
    part = pod.partitioner
    pod.gen += 1   # rollback rewrites pod state wholesale: new generation
    pod.mode = ps["mode"]
    if part.profiles != ps["profiles"]:
        part.set_profiles(ps["profiles"])   # re-derives the ladder + dirties
    part._grid = ps["grid"].copy()
    part.mark_dirty()
    part._next_id = ps["next_id"]
    allocs = {}
    for sid, (obj, profile, origin, devices) in ps["allocs"].items():
        obj.profile, obj.origin, obj.devices = profile, origin, devices
        allocs[sid] = obj
    part.allocations = allocs
    pod.sim.now = ps["sim_now"]
    pod.sim.jobs = {k: replace(j) for k, j in ps["sim_jobs"].items()}
    pod.sim.invalidate()
    pod.jobs = dict(ps["jobs"])
    pod.slice_jobs = dict(ps["slice_jobs"])


_REC_FIELDS: Optional[Tuple[str, ...]] = None


def _rec_fields() -> Tuple[str, ...]:
    global _REC_FIELDS
    if _REC_FIELDS is None:
        from repro_torch.cluster.scheduler import JobRecord
        _REC_FIELDS = tuple(f.name for f in dc_fields(JobRecord)
                            if f.name != "version")
    return _REC_FIELDS


class Transaction:
    """Copy-on-write undo log: the default rollback mechanism.

    Instead of snapshotting the whole cluster up front (``capture``), a
    transaction saves state lazily at first touch while the recorded span
    runs: the first mutation of a pod saves that pod in full (plus every
    record currently resident on it — a resync may move any of their
    finish projections), the first mutation of an off-pod record saves its
    fields, queue membership changes are journaled as ops and replayed in
    reverse, and the (tiny) counter tuple is saved eagerly at begin. Cost
    is O(pods and records actually touched), not O(cluster) — the win
    that lets look-ahead trials run on 100k-job traces.

    Invariants mirrored from ``capture``/``restore``:

    * Record ``version`` is never saved: versions only advance, so ghost
      finish events pushed during the rolled-back span stay stale forever.
      ``rollback`` re-bumps (and re-issues finish events for) *touched*
      records only — untouched records keep their original live events.
    * Transactions nest LIFO on ``sched._txns``; mutations always journal
      into the innermost open transaction (``txn_touch``). A nested
      transaction that *commits* (keeps its mutations — a failed
      ``Repack.find`` keeping its tidy compaction, a look-ahead chain
      landing) is absorbed into its parent so an outer rollback still
      sees pre-span state: first-touch entries the parent lacks moved up
      unchanged (nothing mutated them between the two begins, or the
      parent would already hold an entry), queue ops appended in order.
    """

    def __init__(self, sched: "ClusterScheduler"):
        self.sched = sched
        self.counters = {n: getattr(sched, n) for n in _COUNTERS}
        self.pods: Dict[int, tuple] = {}      # id(pod) -> (pod, saved)
        self.records: Dict[int, tuple] = {}   # id(rec) -> (rec, fields)
        self.queue_ops: List[tuple] = []      # ("add"|"del", rec, pos)

    def touch_pod(self, pod: "PodState") -> None:
        if id(pod) in self.pods:
            return
        self.pods[id(pod)] = (pod, _save_pod(pod))
        for rec in pod.jobs.values():
            self.touch_record(rec)

    def touch_record(self, rec: Optional["JobRecord"]) -> None:
        if rec is None or id(rec) in self.records:
            return
        self.records[id(rec)] = (
            rec, {k: getattr(rec, k) for k in _rec_fields()})

    def note_queue(self, op: str, rec: "JobRecord",
                   pos: Optional[int] = None) -> None:
        self.queue_ops.append((op, rec, pos))

    def absorb(self, child: "Transaction") -> None:
        """Fold a committed nested transaction's journal into this one."""
        for key, entry in child.pods.items():
            self.pods.setdefault(key, entry)
        for key, entry in child.records.items():
            self.records.setdefault(key, entry)
        self.queue_ops.extend(child.queue_ops)
        # counters: this transaction's eager save predates the child's

    def rollback(self) -> None:
        sched = self.sched
        for pod, ps in self.pods.values():
            _restore_pod(pod, ps)
        queue = sched._queue
        for op, rec, pos in reversed(self.queue_ops):
            if op == "add":       # invert an append: drop the last match
                for i in range(len(queue) - 1, -1, -1):
                    if queue[i] is rec:
                        del queue[i]
                        break
                sched._queued_ids.discard(id(rec))
            else:                 # invert a removal: reinsert in place
                queue.insert(pos, rec)
                sched._queued_ids.add(id(rec))
        for name, value in self.counters.items():
            setattr(sched, name, value)
        for rec, saved in self.records.values():
            for k, v in saved.items():
                setattr(rec, k, v)
            sched._revive_finish(rec)


def begin_txn(sched: "ClusterScheduler", *extra: Optional["JobRecord"]):
    """Open a recorded span: an undo-log ``Transaction`` pushed onto
    ``sched._txns`` (default), or a legacy full ``capture`` snapshot when
    the scheduler was built with ``snapshot_rollback=True`` (kept for the
    equivalence property test). ``extra`` pre-touches records not yet
    reachable from a pod or the queue — the beneficiary an action is
    about to place."""
    if sched.snapshot_rollback:
        return capture(sched, tuple(r for r in extra if r is not None))
    txn = Transaction(sched)
    for rec in extra:
        txn.touch_record(rec)
    sched._txns.append(txn)
    return txn


def rollback_txn(sched: "ClusterScheduler", txn) -> None:
    """Undo everything since the matching ``begin_txn``. Undo-log spans
    must close innermost-first (LIFO)."""
    if sched.snapshot_rollback:
        restore(sched, txn)
        return
    assert sched._txns and sched._txns[-1] is txn, \
        "transactions must roll back innermost-first"
    sched._txns.pop()
    txn.rollback()


def commit_txn(sched: "ClusterScheduler", txn) -> None:
    """Close a recorded span *keeping* its mutations. A nested span's
    journal is absorbed by the parent so an outer rollback still restores
    pre-span state. Snapshot mode just drops the capture."""
    if sched.snapshot_rollback:
        return
    assert sched._txns and sched._txns[-1] is txn, \
        "transactions must commit innermost-first"
    sched._txns.pop()
    if sched._txns:
        sched._txns[-1].absorb(txn)


def txn_touch(sched: "ClusterScheduler", pod: Optional["PodState"] = None,
              *recs: Optional["JobRecord"]) -> None:
    """Journal ``pod`` (and any extra records) into the innermost open
    undo transaction before mutating them. No-op when nothing is
    recording (the scheduler's hot path) and in snapshot mode (where
    ``capture`` saved everything up front, so ``sched._txns`` stays
    empty)."""
    txns = sched._txns
    if not txns:
        return
    txn = txns[-1]
    if pod is not None:
        txn.touch_pod(pod)
    for rec in recs:
        txn.touch_record(rec)


# ---------------------------------------------------------------------------
# helpers shared by the rescue actions
# ---------------------------------------------------------------------------
def slo_profiles(sched, rec: "JobRecord", t: float) -> Iterator[PerfScore]:
    """PerfScores (smallest profile first) whose unthrottled modeled
    duration still meets ``rec``'s deadline when started at ``t`` — the
    only placements a rescue action is allowed to buy. Each probe must
    still re-check with its own start delay (``meets_after``).

    Rescue probes iterate this for the same record at many candidate
    times, so the (score, duration) rows come from the PerfModel's
    ``slo_table`` LRU — the filter here is one add + compare per row."""
    if rec.deadline_s is None:
        return
    for sc, dur in sched.perf.slo_table(rec.job):
        if t + dur <= rec.deadline_s:
            yield sc


def meets_after(rec: "JobRecord", t: float, sc: PerfScore,
                delay_s: float) -> bool:
    """Does ``rec`` still meet its deadline when its start is pushed back
    ``delay_s`` seconds by the rescue's own migration/checkpoint traffic?
    Without this, a rescue could disturb a victim and *still* deliver an
    SLO miss."""
    return t + delay_s + modeled_duration(rec.job, sc) <= rec.deadline_s


def shrink_victims(pod: "PodState", rec: "JobRecord") -> List["JobRecord"]:
    """Running non-executed batch jobs, cheapest first: least resident
    state (the migration cost proxy), then job id for determinism."""
    return sorted((r for r in pod.jobs.values()
                   if r.job.kind == BATCH and not r.executed
                   and not r.finished),
                  key=lambda r: (r.resident_bytes, r.job.job_id))


def preempt_victims(pod: "PodState", rec: "JobRecord") -> List["JobRecord"]:
    """Evictable jobs: running non-executed *batch* jobs of strictly lower
    priority. Scanned lowest priority class first, then least resident
    state (the checkpoint-volume cost), then job id — so the first
    feasible victim is also the cheapest eligible one."""
    return sorted((r for r in pod.jobs.values()
                   if r.job.kind == BATCH and not r.executed
                   and not r.finished
                   and r.job.priority < rec.job.priority),
                  key=lambda r: (r.job.priority, r.resident_bytes,
                                 r.job.job_id))


def migrate_victims(pod: "PodState", rec: "JobRecord") -> List["JobRecord"]:
    """Relocatable jobs: running non-executed jobs of strictly lower
    priority, *any* kind — migration never suspends the victim (it keeps
    running on the destination pod after the priced save/restore), so
    training reservations are eligible where eviction would be unsafe.
    Cheapest first: priority class, then resident state (the DCN volume),
    then job id."""
    return sorted((r for r in pod.jobs.values()
                   if not r.executed and not r.finished
                   and r.job.priority < rec.job.priority),
                  key=lambda r: (r.job.priority, r.resident_bytes,
                                 r.job.job_id))


def _realloc_victim(sched: "ClusterScheduler", pod: "PodState",
                    victim: "JobRecord", profile) -> bool:
    """Transactionally swap the victim's rectangle for ``profile`` at its
    current origin (power-of-two profile sides make the origin aligned for
    every smaller profile). On failure the allocation recorded in
    ``victim.profile_name`` — which stays at the committed profile until
    the shrink commits — is restored, so this one helper serves both the
    shrink trial and its rollback. Even self-restoring trials advance
    slice ids and ``_next_id`` — journaled when a transaction is open, so
    an enclosing rollback restores allocation-table order exactly."""
    txn_touch(sched, pod)
    part = pod.partitioner
    part.release(victim.slice_id)
    try:
        alloc = part.allocate(profile, tag=victim.job.tag,
                              origin=victim.origin)
        ok = True
    except RuntimeError:
        alloc = part.allocate(get_profile(victim.profile_name),
                              tag=victim.job.tag, origin=victim.origin)
        ok = False
    pod.slice_jobs.pop(victim.slice_id)
    victim.slice_id = alloc.slice_id
    pod.slice_jobs[alloc.slice_id] = victim
    return ok


# ---------------------------------------------------------------------------
# the probe cache
# ---------------------------------------------------------------------------
class ProbeCache:
    """Memo table for the *structural cores* of rescue probes.

    A rescue probe splits into a time-dependent SLO check (one add and
    compare — always recomputed) and a structural core: grid trials,
    ``origins_for`` queries and the power-gate throttle solve, the parts
    that dominate probe cost. The core reads only pod state — the free
    mask, the resident records' load parameters and the power mix — never
    ``t``, so its outcome is a pure function of the key:

        (kind, pod index, ``PodState.generation`` (a composite of the
         pod-level counter, the partitioner's grid generation and the
         simulator's mix generation), victim job id, the profile names
         involved, the beneficiary job's pricing signature, and
         ``PerfModel.profile_key``)

    Invalidation is structural, not explicit: any ``apply()`` moves the
    touched pod's partitioner/simulator generations, and an undo-log
    ``rollback()`` bumps ``PodState.gen`` (plus ``mark_dirty`` /
    ``invalidate``) — so entries for touched pods silently stop matching
    while untouched pods' entries keep hitting across events and trial-
    tree branches. Self-restoring probe trials re-stamp the partitioner
    generation (``restore_generation``), so sibling probes during one
    rescue scan share a generation and a later identical scan hits.

    Bounded: at ``max_entries`` the table is cleared wholesale (same
    policy as the PerfModel memos) — correctness never depends on
    retention, only speed."""

    __slots__ = ("max_entries", "_table")

    def __init__(self, max_entries: int = 1 << 16):
        self.max_entries = max_entries
        self._table: Dict[tuple, tuple] = {}

    def __len__(self) -> int:
        return len(self._table)

    def get(self, key: tuple) -> Optional[tuple]:
        return self._table.get(key)

    def put(self, key: tuple, value: tuple) -> None:
        if len(self._table) >= self.max_entries:
            self._table.clear()
        self._table[key] = value

    def clear(self) -> None:
        self._table.clear()


def _job_sig(rec: "JobRecord") -> tuple:
    """The beneficiary fields a structural core can read: (arch, shape,
    pinned utilization). Together with the candidate profile name these
    determine the PerfScore terms the power gate prices — job ids are
    deliberately absent so distinct queued jobs with equal pricing share
    cache entries."""
    j = rec.job
    return (j.arch, j.shape, j.u_compute)


def _cached_core(sched: "ClusterScheduler", key: Optional[tuple],
                 core) -> tuple:
    """Evaluate a probe's structural core through the scheduler's
    ``ProbeCache``. Every consultation is counted: a fresh evaluation
    increments ``_probes_priced`` (the work actually done), a hit
    increments ``_probe_hits`` (the work avoided) — the metrics columns
    the ≥3x probe-drop gate reads. With the cache disabled (or no key)
    the core always runs."""
    cache = sched.probe_cache
    if cache is None or key is None:
        sched._probes_priced += 1
        return core(sched)
    val = cache.get(key)
    if val is not None:
        sched._probe_hits += 1
        return val
    sched._probes_priced += 1
    val = core(sched)
    cache.put(key, val)
    return val


def _churn_victim(sched: "ClusterScheduler", pod: "PodState",
                  victim: "JobRecord") -> None:
    """Replay the allocation-table side effect of a skipped probe trial.

    A fresh trial releases and re-allocates the victim's rectangle, which
    moves its entry to the end of the allocation table and advances its
    slice id. ``repack()`` iterates that table (stable sort on profile
    size), so the *order* perturbation is decision-relevant — a cache hit
    that skipped it would drift the pinned timelines. This replays just
    the cheap release/allocate-at-origin pair (no ``origins_for`` query,
    no power solve) and re-stamps the grid generation, leaving the table
    exactly as a fresh probe would."""
    txn_touch(sched, pod)
    part = pod.partitioner
    g = part.generation
    part.release(victim.slice_id)
    alloc = part.allocate(get_profile(victim.profile_name),
                          tag=victim.job.tag, origin=victim.origin)
    pod.slice_jobs.pop(victim.slice_id)
    victim.slice_id = alloc.slice_id
    pod.slice_jobs[alloc.slice_id] = victim
    part.restore_generation(g)


# ---------------------------------------------------------------------------
# the Action base
# ---------------------------------------------------------------------------
class Action:
    """One priced, transactional mutation of cluster state.

    Subclasses bind their parameters (beneficiary record, victim, pod,
    profile score) at construction — usually via the class's ``find``
    scanner — and implement ``probe``/``apply``. ``apply`` records a
    transaction by default; ``rollback`` restores the captured state
    exactly. Commit-only call sites (the scheduler's event loop, a
    policy committing its final choice) pass ``record=False`` to skip
    the snapshot — capturing on every admission costs ~25% of a heavy
    trace's wall time and only look-ahead trials ever roll back.
    ``extra_delay`` threads a chained predecessor's drain time (seconds)
    into both the SLO check and the committed start delay, which is how
    ``LookAheadPolicy`` composes actions."""
    kind = "action"

    def __init__(self, rec: Optional["JobRecord"]):
        self.rec = rec
        self.outcome: Optional[ActionOutcome] = None
        self._txn: Optional[dict] = None

    @property
    def rank(self) -> int:
        return _DISRUPTION_RANK.get(self.kind, 99)

    @property
    def victim_id(self) -> int:
        return -1

    def probe(self, sched: "ClusterScheduler", t: float,
              extra_delay: float = 0.0) -> ActionOutcome:
        raise NotImplementedError

    def apply(self, sched: "ClusterScheduler", t: float,
              extra_delay: float = 0.0, record: bool = True) -> None:
        raise NotImplementedError

    def rollback(self, sched: "ClusterScheduler") -> None:
        assert self._txn is not None, "rollback without a recorded apply"
        rollback_txn(sched, self._txn)
        self._txn = None

    def commit(self, sched: "ClusterScheduler") -> None:
        """Keep the applied mutations but close the recorded span — its
        undo journal is absorbed by the enclosing transaction, if any
        (a look-ahead chain that landed must still be undoable by an
        outer trial)."""
        if self._txn is not None:
            commit_txn(sched, self._txn)
            self._txn = None

    def _begin(self, sched: "ClusterScheduler", record: bool) -> None:
        if record:
            self._txn = begin_txn(sched, self.rec)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        who = self.rec.job.job_id if self.rec is not None else None
        return (f"<{type(self).__name__} rec={who} victim={self.victim_id} "
                f"outcome={self.outcome}>")


class Place(Action):
    """Admit ``rec`` on a scored placement ``Candidate`` (power-gated)."""
    kind = "place"

    def __init__(self, rec: "JobRecord", cand: Candidate):
        super().__init__(rec)
        self.cand = cand

    def probe(self, sched, t, extra_delay=0.0) -> ActionOutcome:
        if not sched._power_ok(self.cand, self.rec):
            self.outcome = ActionOutcome(
                False, reason="power gate: predicted throttle below "
                              f"min_throttle={sched.min_throttle}")
            return self.outcome
        finish = t + extra_delay + self.cand.duration_s
        meets = (None if self.rec.deadline_s is None
                 else finish <= self.rec.deadline_s)
        self.outcome = ActionOutcome(True, cost_s=0.0,
                                     start_delay_s=extra_delay,
                                     projected_finish_s=finish,
                                     meets_slo=meets)
        return self.outcome

    def apply(self, sched, t, extra_delay=0.0, record=True) -> None:
        self._begin(sched, record)
        sched._place(self.rec, self.cand, t, start_delay=extra_delay)


class Repack(Action):
    """In-pod defragmentation: transactional ``repack()`` plus placement
    of the stranded beneficiary, priced as the moved slices' resident
    bytes over the pod's host links (arXiv 2512.16099 stranding fix).

    ``find`` mirrors the legacy scan exactly, including its documented
    quirk: a compaction that fails to mint the needed origin is *kept*
    (the grid stays valid and tidier) and charged nothing. The action's
    transaction therefore spans ``find``+``apply`` — ``rollback`` returns
    to the state before the scan began."""
    kind = "repack"

    def __init__(self, rec: "JobRecord"):
        super().__init__(rec)
        self.pod: Optional["PodState"] = None
        self.moved: Dict[int, tuple] = {}
        self.cand: Optional[Candidate] = None

    @classmethod
    def find(cls, sched: "ClusterScheduler", rec: "JobRecord", t: float,
             record: bool = True) -> Optional["Repack"]:
        act = cls(rec)
        act._txn = begin_txn(sched, rec) if record else None
        for sc in sched.perf.options(rec.job):
            for pod in sched.pods:
                part = pod.partitioner
                if (part.free_chips() < sc.profile.n_chips
                        or part.origins_for(sc.profile)):
                    continue  # either truly full, or no stranding to fix
                # power gate BEFORE paying for migration: a repack whose
                # beneficiary then fails admission would stretch the moved
                # jobs for nothing
                if not sched._power_ok_profile(pod, rec, sc.profile,
                                               sc.terms):
                    continue
                txn_touch(sched, pod)   # repack rewrites the whole grid
                try:
                    moved = part.repack()
                except RuntimeError:
                    sched._repack_failures += 1
                    continue
                for sid, origin in moved.items():
                    # keep records truthful: a later shrink/preempt
                    # re-allocates at the record's origin, so a stale one
                    # would rebuild the victim on the wrong rectangle
                    if sid in pod.slice_jobs:
                        pod.slice_jobs[sid].origin = origin
                cand = candidate_on(pod, rec.job, sc, t, rec.deadline_s)
                if cand is None:
                    # compaction could not mint an aligned origin after
                    # all; the grid stays valid (and tidier) — charge
                    # nothing, keep looking
                    continue
                moved_bytes = sum(pod.slice_jobs[sid].resident_bytes
                                  for sid in moved if sid in pod.slice_jobs)
                t_mig = moved_bytes / sched._pod_host_bw
                act.pod, act.moved, act.cand = pod, moved, cand
                finish = t + t_mig + cand.duration_s
                act.outcome = ActionOutcome(
                    True, cost_s=t_mig, start_delay_s=t_mig,
                    projected_finish_s=finish,
                    meets_slo=(None if rec.deadline_s is None
                               else finish <= rec.deadline_s))
                return act
        if act._txn is not None:   # failed scans keep their tidy
            commit_txn(sched, act._txn)   # compactions — journal upward
            act._txn = None
        return None

    def probe(self, sched, t, extra_delay=0.0) -> ActionOutcome:
        txn = begin_txn(sched)
        found = Repack.find(sched, self.rec, t, record=False)
        rollback_txn(sched, txn)
        if found is None:
            self.outcome = ActionOutcome(False,
                                         reason="no repack mints an origin")
        else:
            self.outcome = found.outcome
        return self.outcome

    def apply(self, sched, t, extra_delay=0.0, record=True) -> None:
        assert self.cand is not None, "apply() requires a successful find()"
        # the transaction spans find()+apply(): find(record=True) already
        # captured (before the compaction) — apply must not re-capture,
        # and a find(record=False) binding cannot become rollbackable here
        assert not record or self._txn is not None, \
            "Repack transactions open in find(); bind with find(record=True)"
        sched._repacks += 1
        t_mig = sched._migration_cost(self.pod, self.moved, t)
        sched._place(self.rec, self.cand, t,
                     start_delay=t_mig + extra_delay)


class Shrink(Action):
    """Resize a running batch victim to a smaller profile so the blocked
    deadline job ``rec`` places now — MISO-style online re-selection,
    priced as the victim's post-shrink resident bytes over the pod's host
    links. A shrink can help two ways: mint an aligned origin on a full
    pod, or (when the power gate blocked admission) drop the victim's
    dynamic draw below the shared cap."""
    kind = "shrink"

    def __init__(self, rec: "JobRecord", pod: "PodState",
                 victim: "JobRecord", small: PerfScore, sc: PerfScore):
        super().__init__(rec)
        self.pod = pod
        self.victim = victim
        self.small = small
        self.sc = sc

    @property
    def victim_id(self) -> int:
        return self.victim.job.job_id

    @classmethod
    def find(cls, sched: "ClusterScheduler", rec: "JobRecord", t: float,
             extra_delay: float = 0.0) -> Optional["Shrink"]:
        """First feasible shrink, scanned victims-cheapest-first within
        each (SLO profile, pod) — the legacy probe order."""
        for sc in slo_profiles(sched, rec, t):
            for pod in sched.pods:
                for victim in shrink_victims(pod, rec):
                    for small in sched.perf.options(victim.job,
                                                    ignore_pin=True):
                        if small.profile.n_chips >= victim.n_chips:
                            continue
                        act = cls(rec, pod, victim, small, sc)
                        if act.probe(sched, t, extra_delay).feasible:
                            return act
        return None

    def probe(self, sched, t, extra_delay=0.0) -> ActionOutcome:
        """Trial-only: would shrinking ``victim`` to ``small`` free an
        origin for ``sc.profile`` under the power gate, with the migration
        delay still inside ``rec``'s deadline? The grid is restored before
        returning, found or not. The structural core (the two realloc
        trials, the origin query and the power solve) is memoized per pod
        generation in the scheduler's ``ProbeCache``; the SLO arithmetic
        is recomputed fresh every call."""
        pod, victim, small, sc = self.pod, self.victim, self.small, self.sc
        mig_s = int(small.plan.resident_bytes) / sched._pod_host_bw
        if not meets_after(self.rec, t, sc, mig_s + extra_delay):
            self.outcome = ActionOutcome(
                False, reason="the shrink migration would blow the SLO")
            return self.outcome
        key = None
        if sched.probe_cache is not None:
            # rung (not profile.name): a twin and a plain score share the
            # rectangle but not the power/step outcome — they must not
            # collide in the cache
            key = ("shrink", pod.idx, pod.generation, victim.job.job_id,
                   small.rung, sc.rung, _job_sig(self.rec),
                   sched.perf.profile_key)
            if sched.probe_cache.get(key) is not None:
                _churn_victim(sched, pod, victim)
        ok, reason = _cached_core(sched, key, self._core)
        if not ok:
            self.outcome = ActionOutcome(False, reason=reason)
            return self.outcome
        finish = t + mig_s + extra_delay + modeled_duration(self.rec.job, sc)
        self.outcome = ActionOutcome(
            True, cost_s=mig_s, start_delay_s=mig_s + extra_delay,
            projected_finish_s=finish,
            meets_slo=finish <= self.rec.deadline_s)
        return self.outcome

    def _core(self, sched) -> tuple:
        """Structural core: does ``small`` fit at the victim's origin, and
        does the shrunk grid mint an aligned origin for ``sc`` under the
        power gate? Pure pod-state function (no ``t``). The two realloc
        trials cancel on the free mask, so the starting grid generation is
        re-stamped — sibling probes in the same rescue scan share it."""
        pod, victim, small, sc = self.pod, self.victim, self.small, self.sc
        part = pod.partitioner
        g = part.generation
        if not _realloc_victim(sched, pod, victim, small.profile):
            part.restore_generation(g)
            return (False, "smaller profile does not fit at the "
                           "victim's origin")
        ok = (bool(part.origins_for(sc.profile))
              and self._power_ok(sched))
        restored = _realloc_victim(sched, pod, victim,
                                   get_profile(victim.profile_name))
        assert restored, "shrink rollback must always fit"
        part.restore_generation(g)
        if not ok:
            return (False, "shrink mints no origin / fails power gate")
        return (True, None)

    def _power_ok(self, sched) -> bool:
        loads = []
        for r in self.pod.jobs.values():
            if r is self.victim:
                loads.append(InstanceLoad(
                    self.small.profile.n_chips,
                    sched._u_for(self.victim, self.small.terms),
                    self.small.step_time, 1))
            else:
                loads.append(r.load())
        loads.append(InstanceLoad(self.sc.profile.n_chips,
                                  sched._u_for(self.rec, self.sc.terms),
                                  self.sc.step_time, 1))
        return sched.perf.throttle(loads, sched.pod_spec) \
            >= sched.min_throttle

    def apply(self, sched, t, extra_delay=0.0, record=True) -> None:
        self._begin(sched, record)
        pod, victim, small, sc = self.pod, self.victim, self.small, self.sc
        applied = _realloc_victim(sched, pod, victim, small.profile)
        assert applied, "probed shrink must re-apply"
        sched._shrinks += 1
        moved_bytes = int(small.plan.resident_bytes)
        victim.profile_name = small.profile.name
        victim.rung = small.rung
        victim.u_compute = sched._u_for(victim, small.terms)
        victim.step_time_s = small.step_time
        victim.resident_bytes = moved_bytes
        victim.shrunk = True
        pod.sim.resize(victim.job.job_id, small.profile.n_chips,
                       victim.u_compute, small.step_time)
        t_mig = sched._charge_migration(pod, moved_bytes, [victim], t)
        sched._reissue_after_resize(pod, victim, t)
        cand = candidate_on(pod, self.rec.job, sc, t, self.rec.deadline_s)
        assert cand is not None, "origins_for was just checked"
        sched._place(self.rec, cand, t, start_delay=t_mig + extra_delay)


class Preempt(Action):
    """Checkpoint-evict a strictly lower-priority running batch job and
    (when a beneficiary is bound) place ``rec`` in its rectangle.

    Priced via ``PerfModel.checkpoint_cost``: the save volume (the
    victim's resident bytes — what ``train/checkpoint.py`` host-gathers)
    crosses the pod's host links before the rectangle is usable, so the
    beneficiary starts after ``save_s``; the victim's progress survives in
    a ``SuspendSnapshot`` and the job re-queues for a later resume, paying
    ``restore_s`` then. With ``rec=None`` the action is a pure *enabler*
    (look-ahead chaining): the eviction happens, nobody is placed, and the
    save drain is handed to the chained action as its ``extra_delay``."""
    kind = "preempt"

    def __init__(self, rec: Optional["JobRecord"], pod: "PodState",
                 victim: "JobRecord", sc: Optional[PerfScore]):
        super().__init__(rec)
        self.pod = pod
        self.victim = victim
        self.sc = sc

    @property
    def victim_id(self) -> int:
        return self.victim.job.job_id

    @classmethod
    def find(cls, sched: "ClusterScheduler", rec: "JobRecord", t: float,
             extra_delay: float = 0.0) -> Optional["Preempt"]:
        """First feasible checkpoint-eviction with a bound beneficiary,
        victims scanned cheapest-first (priority class, resident bytes) —
        the legacy probe order."""
        for sc in slo_profiles(sched, rec, t):
            for pod in sched.pods:
                for victim in preempt_victims(pod, rec):
                    act = cls(rec, pod, victim, sc)
                    if act.probe(sched, t, extra_delay).feasible:
                        return act
        return None

    @classmethod
    def enablers(cls, sched: "ClusterScheduler", rec: "JobRecord", t: float
                 ) -> Iterator["Preempt"]:
        """Beneficiary-less evictions the look-ahead may trial-apply,
        cheapest victims first per pod."""
        for pod in sched.pods:
            for victim in preempt_victims(pod, rec):
                yield cls(None, pod, victim, None)

    def _cost(self, sched):
        return sched.perf.checkpoint_cost(self.victim.resident_bytes,
                                          sched._pod_host_bw)

    def probe(self, sched, t, extra_delay=0.0) -> ActionOutcome:
        """Trial-only: the victim's rectangle is released and re-allocated
        in place — grid state is unchanged on return (only its internal
        slice id advances). The structural core (release/origin/power
        trial) is memoized per pod generation; the SLO arithmetic and the
        checkpoint price are recomputed fresh every call."""
        pod, victim, sc = self.pod, self.victim, self.sc
        cost = self._cost(sched)
        if self.rec is None:   # pure enabler: eligibility is feasibility
            self.outcome = ActionOutcome(True, cost_s=cost.total_s,
                                         start_delay_s=cost.save_s)
            return self.outcome
        if not meets_after(self.rec, t, sc, cost.save_s + extra_delay):
            self.outcome = ActionOutcome(
                False, reason="the checkpoint save drain would blow the SLO")
            return self.outcome
        key = None
        if sched.probe_cache is not None:
            key = ("preempt", pod.idx, pod.generation, victim.job.job_id,
                   sc.rung, _job_sig(self.rec),
                   sched.perf.profile_key)
            if sched.probe_cache.get(key) is not None:
                _churn_victim(sched, pod, victim)
        ok, reason = _cached_core(sched, key, self._core)
        if not ok:
            self.outcome = ActionOutcome(False, reason=reason)
            return self.outcome
        finish = (t + cost.save_s + extra_delay
                  + modeled_duration(self.rec.job, sc))
        self.outcome = ActionOutcome(
            True, cost_s=cost.total_s,
            start_delay_s=cost.save_s + extra_delay,
            projected_finish_s=finish,
            meets_slo=finish <= self.rec.deadline_s)
        return self.outcome

    def _core(self, sched) -> tuple:
        """Structural core: with the victim's rectangle released, does the
        pod mint an aligned origin for ``sc`` and pass the power gate?
        Pure pod-state function (no ``t``); the release/re-allocate pair
        cancels on the free mask, so the grid generation is re-stamped."""
        pod, victim, sc = self.pod, self.victim, self.sc
        txn_touch(sched, pod)
        part = pod.partitioner
        g = part.generation
        profile = get_profile(victim.profile_name)
        origin = victim.origin
        part.release(victim.slice_id)
        ok = (bool(part.origins_for(sc.profile))
              and self._power_ok(sched))
        alloc = part.allocate(profile, tag=victim.job.tag, origin=origin)
        pod.slice_jobs.pop(victim.slice_id)
        victim.slice_id = alloc.slice_id
        pod.slice_jobs[alloc.slice_id] = victim
        part.restore_generation(g)
        if not ok:
            return (False, "eviction mints no origin / fails power gate")
        return (True, None)

    def _power_ok(self, sched) -> bool:
        loads = [r.load() for r in self.pod.jobs.values()
                 if r is not self.victim]
        loads.append(InstanceLoad(self.sc.profile.n_chips,
                                  sched._u_for(self.rec, self.sc.terms),
                                  self.sc.step_time, 1))
        return sched.perf.throttle(loads, sched.pod_spec) \
            >= sched.min_throttle

    def apply(self, sched, t, extra_delay=0.0, record=True) -> None:
        self._begin(sched, record)
        self._evict(sched, t)
        if self.rec is not None:
            cand = candidate_on(self.pod, self.rec.job, self.sc, t,
                                self.rec.deadline_s)
            assert cand is not None, "eviction was probed to mint an origin"
            sched._place(self.rec, cand, t,
                         start_delay=self._cost(sched).save_s + extra_delay)

    def _evict(self, sched, t: float) -> None:
        from repro_torch.cluster.scheduler import SuspendSnapshot
        pod, victim = self.pod, self.victim
        txn_touch(sched, pod)
        sched._preemptions += 1
        cost = self._cost(sched)
        sched._wasted_checkpoint_chip_s += victim.n_chips * cost.save_s
        sim = pod.sim.remove(victim.job.job_id)
        victim.suspended = SuspendSnapshot(
            work_done=sim.work_done, work_total=sim.work_total,
            fixed_remaining=sim.fixed_s, pinned=sim.pinned,
            step_time=sim.step_time, bytes=cost.bytes,
            delay_remaining=sim.delay_s)
        victim.preemptions += 1
        victim.suspend_s = t
        victim.checkpoint_bytes += cost.bytes
        victim.checkpoint_delay_s += cost.save_s
        pod.jobs.pop(victim.job.job_id)
        pod.slice_jobs.pop(victim.slice_id)
        pod.partitioner.release(victim.slice_id)
        victim.pod_idx = None
        victim.slice_id = None
        victim.finish_s = None
        victim.version += 1   # orphan the victim's pending finish event
        sched._enqueue(victim)


class MigrateAcrossPods(Action):
    """Relocate a running lower-priority victim to *another pod* so the
    blocked deadline job ``rec`` takes its rectangle — the cross-pod
    balancing move (ROADMAP item one) in-pod rescues cannot express.

    The move is the same save/restore pair as a checkpoint preemption
    (``PerfModel.checkpoint_cost``), priced over the pod's **DCN**
    bandwidth (``PodSpec.dcn_bw``, bytes/s — the per-host 100 GbE-class
    NICs, the bottleneck of a pod-to-pod transfer) instead of the host
    links. Unlike a preemption the victim never suspends: it is re-admitted
    on the destination pod in the same event, its progress intact, delayed
    by ``save_s + restore_s`` (plus any unburned migration debt). The
    beneficiary's rectangle is usable after ``save_s`` (the state must
    drain off the source slice first). Any job kind of strictly lower
    priority is eligible — relocation preserves the victim's reservation,
    so training holders may move where eviction would be unsafe."""
    kind = "migrate"

    def __init__(self, rec: "JobRecord", src: "PodState",
                 victim: "JobRecord", dest: "PodState", sc: PerfScore):
        super().__init__(rec)
        self.src = src
        self.victim = victim
        self.dest = dest
        self.sc = sc
        self.dest_origin: Optional[Tuple[int, int]] = None

    @property
    def victim_id(self) -> int:
        return self.victim.job.job_id

    @classmethod
    def find(cls, sched: "ClusterScheduler", rec: "JobRecord", t: float,
             extra_delay: float = 0.0) -> Optional["MigrateAcrossPods"]:
        """First feasible cross-pod relocation: source pods in index
        order, victims cheapest-first, destinations in index order."""
        if len(sched.pods) < 2:
            return None
        for sc in slo_profiles(sched, rec, t):
            for src in sched.pods:
                for victim in migrate_victims(src, rec):
                    for dest in sched.pods:
                        if dest is src:
                            continue
                        act = cls(rec, src, victim, dest, sc)
                        if act.probe(sched, t, extra_delay).feasible:
                            return act
        return None

    def _cost(self, sched):
        return sched.perf.checkpoint_cost(self.victim.resident_bytes,
                                          sched._dcn_bw)

    def probe(self, sched, t, extra_delay=0.0) -> ActionOutcome:
        """Trial-only; grid state of both pods is unchanged on return.
        The destination check (origin + power gate, read-only) and the
        source trial (release/origin/power) are memoized as *separate*
        structural cores: the destination core is keyed on the victim's
        profile and load alone so it is shared across beneficiary
        profiles, and the source core is destination-independent so one
        victim probed against many destinations prices it once."""
        src, dest, victim, sc = self.src, self.dest, self.victim, self.sc
        cost = self._cost(sched)
        if not meets_after(self.rec, t, sc, cost.save_s + extra_delay):
            self.outcome = ActionOutcome(
                False, reason="the DCN save drain would blow the SLO")
            return self.outcome
        dkey = None
        if sched.probe_cache is not None:
            dkey = ("mig-dest", dest.idx, dest.generation,
                    victim.profile_name, victim.load(),
                    sched.perf.profile_key)
        dest_origin, reason = _cached_core(sched, dkey, self._dest_core)
        if dest_origin is None:
            self.outcome = ActionOutcome(False, reason=reason)
            return self.outcome
        skey = None
        if sched.probe_cache is not None:
            skey = ("mig-src", src.idx, src.generation, victim.job.job_id,
                    sc.rung, _job_sig(self.rec),
                    sched.perf.profile_key)
            if sched.probe_cache.get(skey) is not None:
                _churn_victim(sched, src, victim)
        ok, reason = _cached_core(sched, skey, self._src_core)
        if not ok:
            self.outcome = ActionOutcome(False, reason=reason)
            return self.outcome
        self.dest_origin = dest_origin
        finish = (t + cost.save_s + extra_delay
                  + modeled_duration(self.rec.job, sc))
        self.outcome = ActionOutcome(
            True, cost_s=cost.total_s,
            start_delay_s=cost.save_s + extra_delay,
            projected_finish_s=finish,
            meets_slo=finish <= self.rec.deadline_s)
        return self.outcome

    def _dest_core(self, sched) -> tuple:
        """Read-only destination check: an aligned origin for the victim's
        profile plus the destination power gate. Returns (origin, None) or
        (None, reason)."""
        dest, victim = self.dest, self.victim
        profile = get_profile(victim.profile_name)
        dest_origins = dest.partitioner.origins_for(profile)
        if not dest_origins:
            return (None, "destination pod has no aligned origin for "
                          "the victim's profile")
        if not self._dest_power_ok(sched):
            return (None, "victim fails the destination power gate")
        return (dest_origins[0], None)

    def _src_core(self, sched) -> tuple:
        """Source-side structural core: with the victim's rectangle
        released, does the source mint an origin for ``sc`` under the
        power gate? Same self-restoring release/re-allocate trial as the
        preemption core."""
        src, victim, sc = self.src, self.victim, self.sc
        txn_touch(sched, src)
        part = src.partitioner
        g = part.generation
        profile = get_profile(victim.profile_name)
        origin = victim.origin
        part.release(victim.slice_id)
        ok = (bool(part.origins_for(sc.profile))
              and self._src_power_ok(sched))
        alloc = part.allocate(profile, tag=victim.job.tag, origin=origin)
        src.slice_jobs.pop(victim.slice_id)
        victim.slice_id = alloc.slice_id
        src.slice_jobs[alloc.slice_id] = victim
        part.restore_generation(g)
        if not ok:
            return (False, "relocation mints no origin / fails the "
                           "source power gate")
        return (True, None)

    def _dest_power_ok(self, sched) -> bool:
        if not self.dest.jobs:
            return True
        return self.dest.sim.throttle(self.victim.load()) \
            >= sched.min_throttle

    def _src_power_ok(self, sched) -> bool:
        loads = [r.load() for r in self.src.jobs.values()
                 if r is not self.victim]
        loads.append(InstanceLoad(self.sc.profile.n_chips,
                                  sched._u_for(self.rec, self.sc.terms),
                                  self.sc.step_time, 1))
        return sched.perf.throttle(loads, sched.pod_spec) \
            >= sched.min_throttle

    def apply(self, sched, t, extra_delay=0.0, record=True) -> None:
        self._begin(sched, record)
        cost = self._relocate(sched, t)
        # the beneficiary takes the drained source rectangle
        cand = candidate_on(self.src, self.rec.job, self.sc, t,
                            self.rec.deadline_s)
        assert cand is not None, "relocation was probed to mint an origin"
        sched._place(self.rec, cand, t,
                     start_delay=cost.save_s + extra_delay)

    def _relocate(self, sched, t):
        """Move ``victim`` from ``src`` to ``dest`` (progress intact,
        DCN-priced) and return the checkpoint cost. Shared by the rescue
        ``apply`` above and the autoscaler's beneficiary-less
        ``MigrateTenant`` — the tenant moving *is* the point there."""
        src, dest, victim = self.src, self.dest, self.victim
        assert self.dest_origin is not None, \
            "apply() requires a successful probe()"
        txn_touch(sched, src)
        txn_touch(sched, dest)
        cost = self._cost(sched)
        sched._migrations += 1
        sched._dcn_migrated_bytes += cost.bytes
        sched._dcn_migration_s += cost.total_s
        # chips idle under checkpoint traffic on both ends of the move
        sched._wasted_checkpoint_chip_s += victim.n_chips * cost.total_s
        profile = get_profile(victim.profile_name)
        sim = src.sim.remove(victim.job.job_id)
        src.jobs.pop(victim.job.job_id)
        src.slice_jobs.pop(victim.slice_id)
        src.partitioner.release(victim.slice_id)
        # re-admit on the destination with progress intact; the relocation
        # pipeline (save + restore over the DCN) and any unburned earlier
        # migration debt delay its restart
        admit_kw = {}
        duration = None
        if sim.pinned:
            duration = sim.fixed_s          # wall-clock contract
        elif sim.fixed_s is not None:
            admit_kw["fixed_remaining"] = sim.fixed_s
        else:
            admit_kw["work_done"] = sim.work_done
        finish = dest.sim.admit(
            victim.job.job_id, sim.n_chips, sim.u_compute, sim.step_time,
            sim.steps, t, duration_s=duration,
            start_delay=cost.total_s + sim.delay_s, **admit_kw)
        alloc = dest.partitioner.allocate(profile, tag=victim.job.tag,
                                          origin=self.dest_origin)
        victim.pod_idx = dest.idx
        victim.slice_id = alloc.slice_id
        victim.origin = self.dest_origin
        victim.finish_s = finish
        victim.migrations += 1
        victim.migrate_s = t
        victim.dcn_bytes += cost.bytes
        victim.dcn_delay_s += cost.total_s
        dest.jobs[victim.job.job_id] = victim
        dest.slice_jobs[alloc.slice_id] = victim
        victim.version += 1
        sched._push(finish, "finish", (victim, victim.version))
        if not sched.frozen_durations:
            sched._resync(dest, t)   # the newcomer slows dest co-tenants
        return cost


class ReconfigurePartition(Action):
    """Switch a pod to another hardware partition mode so the blocked
    deadline job ``rec`` fits where no fixed-mode rescue can help — e.g.
    a bandwidth-starved job that misses its SLO under NPS1 but meets it
    under NPS4's interleaving uplift (``core.hw.PartitionMode``).

    Feasibility requires the pod *drainable*: every resident tenant must
    relocate to another pod (the beneficiary-less ``MigrateTenant`` move,
    DCN-priced), because a mode switch resets the pod's memory/compute
    partitioning. The priced cost is the tenants' drain traffic plus the
    mode's fixed ``switch_downtime_s``; the beneficiary re-admits on the
    reconfigured pod under the *target mode's* PerfModel
    (``sched.mode_model``), whose slice ladder may differ (CPX exposes
    per-XCD slices, SPX only whole-socket ones). ``probe`` trial-applies
    the whole drain inside a transaction and rolls it back bit-exactly;
    ``apply`` replays the recorded drain plan, flips ``pod.mode``,
    re-derives the partitioner's profile ladder, and places ``rec``.

    On a single-mode chip (v5e's ``fixed``) ``find`` has nothing to scan,
    so legacy configurations never change behaviour even when the kind is
    enabled."""
    kind = "reconfigure"

    def __init__(self, rec: Optional["JobRecord"], pod: "PodState",
                 mode_name: str):
        super().__init__(rec)
        self.pod = pod
        self.mode_name = mode_name
        self.sc: Optional[PerfScore] = None
        self.plan: List[Tuple[int, int]] = []   # (victim job id, dest idx)
        self.drain_save_s = 0.0
        self.drain_total_s = 0.0

    @classmethod
    def find(cls, sched: "ClusterScheduler", rec: "JobRecord", t: float,
             extra_delay: float = 0.0) -> Optional["ReconfigurePartition"]:
        """First feasible (pod, target mode) pair — pods in index order,
        modes in sorted-name order, the current mode skipped."""
        for pod in sched.pods:
            for name in sorted(sched._modes):
                if name == pod.mode:
                    continue
                act = cls(rec, pod, name)
                if act.probe(sched, t, extra_delay=extra_delay).feasible:
                    return act
        return None

    def probe(self, sched, t, extra_delay=0.0) -> ActionOutcome:
        from repro_torch.cluster.autoscale import MigrateTenant
        rec, pod = self.rec, self.pod
        mode = sched._modes[self.mode_name]
        if rec is None or rec.deadline_s is None:
            self.outcome = ActionOutcome(
                False, reason="reconfigure only rescues deadline jobs")
            return self.outcome
        if any(r.executed or r.finished for r in pod.jobs.values()):
            self.outcome = ActionOutcome(
                False, reason="pod tenants include a non-relocatable job")
            return self.outcome
        # trial-drain every tenant inside a recorded span, priced as the
        # DCN moves it would really take; rolled back before returning
        txn = begin_txn(sched, rec)
        tenants = sorted(pod.jobs.values(),
                         key=lambda r: (r.resident_bytes, r.job.job_id))
        drain_save = drain_total = 0.0
        plan: List[Tuple[int, int]] = []
        drained = True
        for victim in tenants:
            moved = False
            dests = sorted((d for d in sched.pods if d is not pod),
                           key=lambda d: (-d.partitioner.free_chips(),
                                          d.idx))
            for dest in dests:
                mv = MigrateTenant(pod, victim, dest)
                if not mv.probe(sched, t).feasible:
                    continue
                cost = mv._cost(sched)
                mv.apply(sched, t, record=False)   # journals into txn
                drain_save += cost.save_s
                drain_total += cost.total_s
                plan.append((victim.job.job_id, dest.idx))
                moved = True
                break
            if not moved:
                drained = False
                break
        sc_found = None
        if drained:
            # the beneficiary admits under the *target* mode's model:
            # smallest profile whose modeled duration — after the drain's
            # save traffic and the fixed switch downtime — meets the SLO
            delay = extra_delay + drain_save + mode.switch_downtime_s
            mm = sched.mode_model(self.mode_name)
            for sc, dur in mm.slo_table(rec.job):
                if t + delay + dur > rec.deadline_s:
                    continue
                if sc.profile.n_chips > sched.pod_spec.n_chips:
                    continue
                load = InstanceLoad(sc.profile.n_chips,
                                    sched._u_for(rec, sc.terms),
                                    sc.step_time, 1)
                if mm.throttle([load], sched.pod_spec) < sched.min_throttle:
                    continue
                sc_found = sc
                break
        rollback_txn(sched, txn)
        if not drained:
            self.outcome = ActionOutcome(
                False, reason="pod is not drainable: a tenant found no "
                              "destination rectangle")
            return self.outcome
        if sc_found is None:
            self.outcome = ActionOutcome(
                False, reason=f"no profile meets the SLO under mode "
                              f"{self.mode_name!r} after drain + downtime")
            return self.outcome
        self.sc = sc_found
        self.plan = plan
        self.drain_save_s = drain_save
        self.drain_total_s = drain_total
        delay = extra_delay + drain_save + mode.switch_downtime_s
        finish = t + delay + modeled_duration(rec.job, sc_found)
        self.outcome = ActionOutcome(
            True, cost_s=drain_total + mode.switch_downtime_s,
            start_delay_s=delay, projected_finish_s=finish,
            meets_slo=finish <= rec.deadline_s)
        return self.outcome

    def apply(self, sched, t, extra_delay=0.0, record=True) -> None:
        from repro_torch.core.hw import ladder_for
        from repro_torch.cluster.autoscale import MigrateTenant
        assert self.sc is not None, "apply() requires a successful probe()"
        self._begin(sched, record)
        pod = self.pod
        mode = sched._modes[self.mode_name]
        txn_touch(sched, pod)
        # replay the probed drain plan (re-probing each move binds its
        # destination origin on the current state)
        for vid, didx in self.plan:
            victim = pod.jobs[vid]
            mv = MigrateTenant(pod, victim, sched.pods[didx])
            out = mv.probe(sched, t)
            assert out.feasible, "probed drain plan must replay"
            mv.apply(sched, t, record=False)
        sched._reconfigs += 1
        pod.mode = self.mode_name
        pod.partitioner.set_profiles(ladder_for(mode))
        pod.gen += 1   # mode flip invalidates every cached structural core
        delay = extra_delay + self.drain_save_s + mode.switch_downtime_s
        cand = candidate_on(pod, self.rec.job, self.sc, t,
                            self.rec.deadline_s)
        assert cand is not None, "drained pod must admit the beneficiary"
        sched._place(self.rec, cand, t, start_delay=delay)


class Grow(Action):
    """Extend the running job ``rec`` into free neighbour chips via the
    partitioner's transactional ``extend()`` — the symmetric move to a
    shrink, priced identically (the re-planned resident bytes cross the
    pod's host links) and power-gated like an admission.

    Like ``Repack``, ``find`` commits the grid extension as it scans (the
    primitive is transactional on its own), so the action's transaction
    spans ``find``+``apply``."""
    kind = "grow"

    def __init__(self, rec: "JobRecord", pod: "PodState"):
        super().__init__(rec)
        self.pod = pod
        self.sc: Optional[PerfScore] = None

    @classmethod
    def find(cls, sched: "ClusterScheduler", pod: "PodState",
             rec: "JobRecord", t: float,
             record: bool = True, max_chips: Optional[int] = None,
             ascending: bool = False) -> Optional["Grow"]:
        """Largest power-feasible profile whose rectangle extension fits
        the free neighbourhood and whose step time beats the current one.
        ``max_chips`` caps the candidate ladder and ``ascending=True``
        flips the scan to the *smallest* qualifying profile — the gentle
        rung-by-rung step-up the autoscaler wants, versus the scheduler's
        default grab-everything-free sweep."""
        act = cls(rec, pod)
        act._txn = begin_txn(sched, rec) if record else None
        bigger = sorted((sc for sc in sched.perf.options(rec.job,
                                                         ignore_pin=True)
                         if sc.profile.n_chips > rec.n_chips
                         and sc.step_time < rec.step_time_s
                         and (max_chips is None
                              or sc.profile.n_chips <= max_chips)),
                        key=lambda sc: (sc.profile.n_chips if ascending
                                        else -sc.profile.n_chips))
        free = pod.partitioner.free_chips()
        for sc in bigger:
            if sc.profile.n_chips - rec.n_chips > free:
                continue   # not even the chip count fits, let alone power
            if not act._power_ok(sched, sc):
                continue
            txn_touch(sched, pod)
            try:
                pod.partitioner.extend(rec.slice_id, sc.profile)
            except (RuntimeError, ValueError):
                continue   # extend is transactional: nothing changed
            act.sc = sc
            t_mig = int(sc.plan.resident_bytes) / sched._pod_host_bw
            act.outcome = ActionOutcome(True, cost_s=t_mig,
                                        start_delay_s=t_mig)
            return act
        if act._txn is not None:
            commit_txn(sched, act._txn)
            act._txn = None
        return None

    def probe(self, sched, t, extra_delay=0.0) -> ActionOutcome:
        txn = begin_txn(sched)
        found = Grow.find(sched, self.pod, self.rec, t, record=False)
        rollback_txn(sched, txn)
        if found is None:
            self.outcome = ActionOutcome(
                False, reason="no feasible rectangle extension")
        else:
            self.outcome = found.outcome
        return self.outcome

    def _power_ok(self, sched, sc: PerfScore) -> bool:
        loads = [InstanceLoad(sc.profile.n_chips,
                              sched._u_for(self.rec, sc.terms),
                              sc.step_time, 1)
                 if r is self.rec else r.load()
                 for r in self.pod.jobs.values()]
        return sched.perf.throttle(loads, sched.pod_spec) \
            >= sched.min_throttle

    def apply(self, sched, t, extra_delay=0.0, record=True) -> None:
        assert self.sc is not None, "apply() requires a successful find()"
        # like Repack: the transaction spans find()+apply() (the grid was
        # already extended in find) — see the assertion rationale there
        assert not record or self._txn is not None, \
            "Grow transactions open in find(); bind with find(record=True)"
        pod, rec, sc = self.pod, self.rec, self.sc
        sched._grows += 1
        moved_bytes = int(sc.plan.resident_bytes)
        rec.profile_name = sc.profile.name
        rec.rung = sc.rung
        rec.origin = pod.partitioner.allocations[rec.slice_id].origin
        rec.u_compute = sched._u_for(rec, sc.terms)
        rec.step_time_s = sc.step_time
        rec.resident_bytes = moved_bytes
        rec.grown = True
        pod.sim.resize(rec.job.job_id, sc.profile.n_chips,
                       rec.u_compute, sc.step_time)
        sched._charge_migration(pod, moved_bytes, [rec], t)
        sched._reissue_after_resize(pod, rec, t)


# the find() scanners the policies enumerate, in deterministic kind order
_FINDERS = {
    "shrink": Shrink.find,
    "preempt": Preempt.find,
    "migrate": MigrateAcrossPods.find,
    "reconfigure": ReconfigurePartition.find,
}


def select_cheapest(options: Sequence[Action]) -> Optional[Action]:
    """The probe → price → select comparator: among feasible, SLO-
    preserving rescue actions, pick the smallest modeled cost in seconds;
    ties break toward the least disruptive kind (shrink < migrate <
    preempt), then the lowest victim job id. An empty option set returns
    ``None`` — the job queues (the cheapest action is to wait)."""
    options = [o for o in options
               if o is not None and o.outcome is not None
               and o.outcome.feasible]
    if not options:
        return None
    return min(options, key=lambda o: (o.outcome.cost_s, o.rank,
                                       o.victim_id))


# ---------------------------------------------------------------------------
# scheduler policies (the selection layer)
# ---------------------------------------------------------------------------
class SchedulerPolicy:
    """Protocol: given a blocked deadline job, pick and *commit* a rescue
    plan. ``rescue`` returns the list of committed actions (in order), or
    ``None`` after leaving state untouched — committed trials must be
    rolled back before returning ``None``. A chaining policy sets
    ``chains_grow`` so the scheduler runs a grow sweep right after a
    committed plan (instead of only after completion events)."""
    name = "base"
    chains_grow = False

    def rescue(self, sched: "ClusterScheduler", rec: "JobRecord",
               t: float) -> Optional[List[Action]]:
        raise NotImplementedError


class GreedyCheapestRescue(SchedulerPolicy):
    """The legacy ``cheapest_rescue`` behaviour: probe every enabled
    rescue kind, price the first feasible option of each, commit the
    cheapest single action."""
    name = "greedy"

    def rescue(self, sched, rec, t) -> Optional[List[Action]]:
        options = [_FINDERS[kind](sched, rec, t)
                   for kind in RESCUE_KINDS
                   if sched.spec.enabled(kind)]
        choice = select_cheapest(options)
        if choice is None:
            return None
        choice.apply(sched, t, record=False)   # final choice: no rollback
        return [choice]


class LookAheadPolicy(GreedyCheapestRescue):
    """Greedy plus a two-action look-ahead: when no single action rescues
    the blocked job, trial-apply a beneficiary-less eviction (``Preempt``
    enabler, cheapest victims first), re-probe the whole single-action
    space on the resulting state — a direct ``Place`` into what the
    eviction freed, or any enabled rescue — and commit the pair if the
    chain lands inside the SLO; otherwise roll the trial back exactly.
    The enabler's checkpoint drain is threaded into the chained action's
    start delay, so a chain can never promise an SLO its own traffic
    breaks. Requires ``"preempt"`` in the action allowlist (the enabler
    is an eviction)."""
    name = "lookahead"
    chains_grow = True

    def rescue(self, sched, rec, t) -> Optional[List[Action]]:
        single = super().rescue(sched, rec, t)
        if single is not None:
            return single
        if rec.deadline_s is None or not sched.spec.enabled("preempt"):
            return None
        if not any(True for _ in slo_profiles(sched, rec, t)):
            return None   # no profile meets the deadline even undelayed
        for enabler in Preempt.enablers(sched, rec, t):
            out = enabler.probe(sched, t)
            if not any(meets_after(rec, t, sc, out.start_delay_s)
                       for sc in slo_profiles(sched, rec, t)):
                continue   # this victim's drain alone blows the deadline
            enabler.apply(sched, t)   # trial: records, may roll back
            closer = self._closer(sched, rec, t, out.start_delay_s)
            if closer is not None:
                # the chain lands: close the enabler's recorded span
                # (journaling into any outer trial) before committing
                # the closer on top of it
                enabler.commit(sched)
                closer.apply(sched, t, extra_delay=out.start_delay_s,
                             record=False)
                return [enabler, closer]
            enabler.rollback(sched)
        return None

    def _closer(self, sched, rec, t, extra_delay) -> Optional[Action]:
        """Best follow-up on the trial state: a direct placement into what
        the enabler freed, else the cheapest enabled rescue."""
        cands = sched.candidates_for(rec.job, t, rec.deadline_s)
        for cand in cands:
            act = Place(rec, cand)
            out = act.probe(sched, t, extra_delay=extra_delay)
            if out.feasible and out.meets_slo:
                return act
        options = [_FINDERS[kind](sched, rec, t, extra_delay=extra_delay)
                   for kind in RESCUE_KINDS
                   if sched.spec.enabled(kind)]
        return select_cheapest(options)


_SCHEDULER_POLICIES = {
    "greedy": GreedyCheapestRescue,
    "lookahead": LookAheadPolicy,
}


def get_scheduler_policy(name: str) -> SchedulerPolicy:
    if name == "search" and "search" not in _SCHEDULER_POLICIES:
        # lazy: planner.py imports this module, so registering at import
        # time would be a cycle — the first "search" request resolves it
        from repro_torch.cluster.planner import SearchPolicy
        _SCHEDULER_POLICIES["search"] = SearchPolicy
    try:
        return _SCHEDULER_POLICIES[name]()
    except KeyError:
        raise KeyError(f"unknown scheduler policy {name!r}; have "
                       f"{sorted(_SCHEDULER_POLICIES)}") from None
