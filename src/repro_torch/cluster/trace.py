"""Seeded synthetic job traces for the cluster scheduler.

Three job classes mirror the paper's §V co-scheduling mix:

* ``serving``  — LLM inference tenants from the model zoo (decode-shaped,
  memory-bound: the paper's Fig. 2 "GPU busy but half-idle" class). These
  are the jobs ``launch/cluster.py`` can execute through a real
  ``SliceRuntime`` at reduced scale.
* ``training`` — compute-heavy runs (the NekRS-like HPC analogue): long
  holders of large slices, the jobs that create and suffer fragmentation.
* ``batch``    — analytics-style jobs with paper-style low utilization
  (§IV Figs. 2-3): short, small, pinned to single-digit compute
  utilization so they throttle nobody but still occupy chips.

Arrivals are Poisson (exponential inter-arrival gaps) from a single seeded
``numpy`` generator, so a trace is a pure function of its ``TraceConfig`` —
every scheduler comparison in ``benchmarks/bench_cluster.py`` replays the
identical stream under each policy.
"""
from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

SERVING = "serving"
TRAINING = "training"
BATCH = "batch"
KINDS = (SERVING, TRAINING, BATCH)

# arch pools per job class (all resolvable via repro_torch.configs.get_config;
# the serving pool is restricted to decoder-only archs the live
# TenantEngine can execute at reduced scale)
SERVING_ARCHS = ("gpt2-124m", "llama3-8b", "phi3-mini-3.8b", "qwen3-32b")
TRAINING_ARCHS = ("llama3-8b", "starcoder2-7b", "qwen3-32b", "command-r-35b")
BATCH_ARCHS = ("gpt2-124m", "mamba2-130m", "zamba2-1.2b")

KIND_SHAPE = {SERVING: "decode_32k", TRAINING: "train_4k", BATCH: "decode_32k"}

# default priority class per job kind (higher preempts lower): serving
# tenants are latency-critical, training runs hold reservations, batch
# analytics are the paper's low-utilization opportunistic filler — the
# class MISO-style schedulers reclaim chips from first
KIND_PRIORITY = {SERVING: 2, TRAINING: 1, BATCH: 0}


@dataclass(frozen=True)
class Job:
    """One unit of the arrival stream. Modeled fields (steps/shape) drive
    the analytic duration; the optional pinned fields let crafted traces
    (tests, the fragmentation showcase) control timing exactly.

    Units: ``arrival_s``/``duration_s`` are virtual seconds, ``steps`` are
    model steps (duration = steps × modeled step time unless pinned),
    ``priority`` is an integer class (higher may checkpoint-evict strictly
    lower-priority *batch* jobs when the scheduler runs with priorities
    enabled)."""
    job_id: int
    kind: str                       # serving | training | batch
    arch: str
    shape: str                      # ShapeSuite name for WorkloadEstimate
    arrival_s: float
    steps: int
    slo_factor: float = 4.0         # deadline = arrival + factor × ideal
    profile: Optional[str] = None   # pin the slice profile (skip scoring)
    duration_s: Optional[float] = None  # pin duration (skip roofline model)
    u_compute: Optional[float] = None   # pin power-model utilization
    requests: int = 0               # serving: live requests to execute
    priority: int = 0               # preemption class (higher evicts lower)

    @property
    def tag(self) -> str:
        return f"job{self.job_id}.{self.kind}.{self.arch}"


@dataclass(frozen=True)
class TraceConfig:
    seed: int = 0
    n_jobs: int = 24
    mean_interarrival_s: float = 45.0
    mix: Tuple[float, float, float] = (0.5, 0.25, 0.25)  # serving/train/batch
    serving_steps: Tuple[int, int] = (100, 400)
    training_steps: Tuple[int, int] = (20, 80)
    batch_steps: Tuple[int, int] = (50, 200)
    slo_range: Tuple[float, float] = (2.5, 6.0)
    batch_u_range: Tuple[float, float] = (0.03, 0.15)
    requests_per_serving: int = 2


def generate_trace(cfg: TraceConfig = TraceConfig()) -> List[Job]:
    """Deterministic mixed trace: same config (incl. seed) → same jobs."""
    rng = np.random.default_rng(cfg.seed)
    probs = np.asarray(cfg.mix, dtype=float)
    probs = probs / probs.sum()
    jobs: List[Job] = []
    t = 0.0
    for jid in range(cfg.n_jobs):
        t += float(rng.exponential(cfg.mean_interarrival_s))
        kind = KINDS[int(rng.choice(len(KINDS), p=probs))]
        if kind == SERVING:
            arch = SERVING_ARCHS[int(rng.integers(len(SERVING_ARCHS)))]
            steps = int(rng.integers(*cfg.serving_steps))
            extra = {"requests": cfg.requests_per_serving}
        elif kind == TRAINING:
            arch = TRAINING_ARCHS[int(rng.integers(len(TRAINING_ARCHS)))]
            steps = int(rng.integers(*cfg.training_steps))
            extra = {}
        else:
            arch = BATCH_ARCHS[int(rng.integers(len(BATCH_ARCHS)))]
            steps = int(rng.integers(*cfg.batch_steps))
            extra = {"u_compute": float(rng.uniform(*cfg.batch_u_range))}
        jobs.append(Job(
            job_id=jid, kind=kind, arch=arch, shape=KIND_SHAPE[kind],
            arrival_s=round(t, 3), steps=steps,
            slo_factor=round(float(rng.uniform(*cfg.slo_range)), 2),
            priority=KIND_PRIORITY[kind],   # by class: no rng draw, so the
            **extra))                       # arrival stream is unchanged
    return jobs


# ---------------------------------------------------------------------------
# public-trace loader (Philly / Alibaba-style CSV schemas)
# ---------------------------------------------------------------------------
# accepted header aliases, per field (first match in file-header order wins)
_CSV_ARRIVAL = ("submit_time_s", "submit_time", "submitted_time",
                "arrival_s", "arrival", "timestamp")
_CSV_DURATION = ("duration_s", "duration", "run_time_s", "run_time",
                 "runtime")
_CSV_GPUS = ("gpus", "gpu_request", "num_gpus", "gpu_num", "plan_gpu")
_CSV_CLASS = ("class", "job_class", "kind", "type")

# public-trace job-class vocabulary → the three paper classes
_CSV_KINDS = {
    SERVING: SERVING, "inference": SERVING, "latency": SERVING,
    TRAINING: TRAINING, "train": TRAINING, "production": TRAINING,
    BATCH: BATCH, "best_effort": BATCH, "best-effort": BATCH,
    "opportunistic": BATCH, "analytics": BATCH, "spot": BATCH,
}

def _profile_ladder() -> List[Tuple[str, int]]:
    """Slice profiles by ascending chip count, for the GPU-request →
    profile mapping (derived from the canonical table, not hand-pinned)."""
    from repro_torch.core.slices import PROFILES
    return sorted(((p.name, p.n_chips) for p in PROFILES),
                  key=lambda x: x[1])


def _csv_col(header: List[str], aliases: Tuple[str, ...],
             what: str) -> str:
    for name in header:
        if name.strip().lower() in aliases:
            return name
    raise ValueError(
        f"trace CSV is missing a {what} column (any of: "
        f"{', '.join(aliases)}); got header {header}")


def _profile_for_gpus(gpus: int) -> str:
    """Smallest slice profile with at least ``gpus`` chips. A request
    larger than the largest profile is a schema error, not something to
    silently clamp: a clamped job would replay on a quarter of the chips
    the trace says it used, skewing every throughput number downstream."""
    ladder = _profile_ladder()
    for name, chips in ladder:
        if chips >= gpus:
            return name
    raise ValueError(
        f"GPU request {gpus} exceeds the largest slice profile "
        f"({ladder[-1][0]}, {ladder[-1][1]} chips)")


def load_csv(path: str, *, default_kind: str = BATCH,
             requests_per_serving: int = 2, chip: str = "v5e") -> List[Job]:
    """Load a Philly/Alibaba-style public trace CSV into ``Job``s.

    The schema is the common denominator of the production GPU-cluster
    traces the scale benchmarks replay: one row per job with a **submit
    time** (seconds), a **duration** (seconds), a **GPU request** (chip
    count) and optionally a **job class**. Header names are matched
    case-insensitively against the usual aliases (``submitted_time`` /
    ``run_time`` / ``num_gpus`` à la Philly, ``gpu_num`` / ``plan_gpu``
    à la Alibaba, plus the obvious ``arrival_s``/``duration_s`` forms).

    Mapping onto the synthetic-trace vocabulary:

    * job class → ``serving`` / ``training`` / ``batch`` via the usual
      public-trace labels (``inference``→serving, ``production``→training,
      ``best_effort``/``spot``→batch, …); a missing class column assigns
      ``default_kind``. Priorities follow ``KIND_PRIORITY`` exactly as
      :func:`generate_trace` does.
    * GPU request → the smallest slice profile with that many chips,
      pinned via ``Job.profile``; a request beyond the largest profile
      (256 chips) raises rather than clamps.
    * duration → pinned wall-clock ``Job.duration_s`` (public traces
      record observed runtimes, not model steps), so a loaded trace
      replays deterministically under any policy.
    * arch → round-robin over the kind's arch pool by row order, so the
      resident-state pricing (checkpoint/migration bytes) varies across
      jobs the way the synthetic traces' does. The pool is restricted to
      archs whose workload actually fits the pinned profile (a 3.8B
      decode tenant cannot live on a 16-chip slice); if none fit, the
      profile escalates to the next size up — the request is a floor,
      never a reachability trap.

    Optional per-row columns override the defaults where present:
    ``job_id``, ``slo_factor``, ``u_compute``, ``arch``. Rows are sorted
    by (submit time, row order) — the scheduler consumes arrivals in
    order. Zero/negative durations, zero-GPU rows, oversized GPU
    requests and duplicate ``job_id``s are rejected.

    ``chip`` names the target chip family (``core.hw.CHIPS``) the
    arch-fit scoring runs against — an arch whose resident state fits a
    24 GiB-HBM mi300 slice may not fit the same slice on a 16 GiB v5e,
    so the fit must be chip-aware, not hard-wired to the default chip.
    Unknown names raise the registry's ``ValueError`` listing the valid
    family names."""
    with open(path, newline="") as fh:
        reader = csv.DictReader(fh)
        if reader.fieldnames is None:
            raise ValueError(f"trace CSV {path!r} is empty")
        header = list(reader.fieldnames)
        rows = list(reader)
    col_t = _csv_col(header, _CSV_ARRIVAL, "submit-time")
    col_d = _csv_col(header, _CSV_DURATION, "duration")
    col_g = _csv_col(header, _CSV_GPUS, "GPU-request")
    try:
        col_k: Optional[str] = _csv_col(header, _CSV_CLASS, "job-class")
    except ValueError:
        col_k = None
    lower = {name.strip().lower(): name for name in header}
    arch_pools: Dict[str, Tuple[str, ...]] = {
        SERVING: SERVING_ARCHS, TRAINING: TRAINING_ARCHS,
        BATCH: BATCH_ARCHS}
    parsed = []
    for i, row in enumerate(rows):
        arrival = float(row[col_t])
        duration = float(row[col_d])
        gpus = int(float(row[col_g]))
        if duration <= 0:
            raise ValueError(f"{path}:{i + 2}: non-positive duration "
                             f"{duration}")
        if gpus <= 0:
            raise ValueError(f"{path}:{i + 2}: non-positive GPU request "
                             f"{gpus}")
        if col_k is not None and row[col_k].strip():
            label = row[col_k].strip().lower()
            kind = _CSV_KINDS.get(label)
            if kind is None:
                raise ValueError(f"{path}:{i + 2}: unknown job class "
                                 f"{label!r} (known: "
                                 f"{', '.join(sorted(_CSV_KINDS))})")
        else:
            kind = default_kind
        parsed.append((arrival, i, duration, gpus, kind, row))

    def _opt(row, name: str) -> Optional[str]:
        col = lower.get(name)
        v = row.get(col) if col else None
        return v.strip() if v and v.strip() else None

    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.hw import get_chip
    from repro_torch.core.perfmodel import get_model
    perf = get_model(get_chip(chip))
    ladder = _profile_ladder()

    def _fit(kind: str, gpus: int, pinned_arch: Optional[str],
             i: int) -> Tuple[str, str]:
        """(profile, arch) honouring the GPU request as a floor: walk the
        profile ladder up from the request until an arch in the kind's
        pool (or the pinned arch) fits the slice."""
        from repro_torch.core.slices import get_profile
        shape = get_shape(KIND_SHAPE[kind])
        pool = (pinned_arch,) if pinned_arch else arch_pools[kind]
        floor = _profile_for_gpus(gpus)
        start = next(k for k, (name, _) in enumerate(ladder)
                     if name == floor)
        for name, _ in ladder[start:]:
            prof = get_profile(name)
            fits = [a for a in pool
                    if perf.score(get_config(a), shape, prof) is not None]
            if fits:
                return name, fits[i % len(fits)]
        raise ValueError(
            f"no arch in the {kind} pool fits any profile >= "
            f"{gpus} chips")

    jobs: List[Job] = []
    seen_ids: Dict[int, int] = {}
    for arrival, i, duration, gpus, kind, row in sorted(
            parsed, key=lambda p: (p[0], p[1])):
        jid = int(_opt(row, "job_id") or len(jobs))
        if jid in seen_ids:
            raise ValueError(
                f"{path}:{i + 2}: duplicate job_id {jid} (first seen at "
                f"row {seen_ids[jid] + 2}); the scheduler keys records "
                f"by job_id, so duplicates would silently merge jobs")
        seen_ids[jid] = i
        pinned_arch = _opt(row, "arch")
        if pinned_arch is not None:
            from repro_torch.configs import ALL_ARCHS
            if pinned_arch not in ALL_ARCHS:
                raise ValueError(
                    f"{path}:{i + 2}: unknown arch {pinned_arch!r} "
                    f"(known: {', '.join(sorted(ALL_ARCHS))})")
        profile, arch = _fit(kind, gpus, pinned_arch, i)
        slo = _opt(row, "slo_factor")
        u = _opt(row, "u_compute")
        jobs.append(Job(
            job_id=jid, kind=kind, arch=arch, shape=KIND_SHAPE[kind],
            arrival_s=arrival, steps=1,
            slo_factor=float(slo) if slo else 4.0,
            profile=profile, duration_s=duration,
            u_compute=float(u) if u else None,
            requests=requests_per_serving if kind == SERVING else 0,
            priority=KIND_PRIORITY[kind]))
    return jobs


def fragmentation_showcase(long_s: float = 10_000.0,
                           short_s: float = 100.0) -> List[Job]:
    """A deterministic single-pod stream where first-fit strands a large job.

    Timeline on one 16×16 pod:

    1. t=0: eight 4×4 jobs fill the top half (first-fit packs rows 0-7);
       alternating short/long durations.
    2. t=0: two 8×8 jobs fill the bottom half — one short, one long.
    3. t=``short_s``: the five short jobs finish → 128 chips free, but
       scattered as four 4×4 holes plus one 8×8 hole.
    4. t=``short_s``+1: an 8×16 job (exactly 128 chips) arrives. It fits
       by chip count and by *no* aligned rectangle — the arXiv 2512.16099
       stranding case. ``repack()`` compacts the five live slices into the
       top half and frees rows 8-15 for it; plain first-fit leaves it
       queued until the long jobs end at ``long_s`` (beyond the horizon
       the benchmark runs with).
    """
    jobs: List[Job] = []
    jid = 0
    for i in range(8):
        jobs.append(Job(
            job_id=jid, kind=BATCH, arch="gpt2-124m", shape="decode_32k",
            arrival_s=0.0, steps=1, profile="1s.16c",
            duration_s=(short_s if i % 2 == 0 else long_s),
            u_compute=0.1))
        jid += 1
    for i in range(2):
        jobs.append(Job(
            job_id=jid, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=0.0, steps=1, profile="4s.64c",
            duration_s=(short_s if i == 0 else long_s),
            u_compute=0.3))
        jid += 1
    jobs.append(Job(
        job_id=jid, kind=TRAINING, arch="qwen3-32b", shape="train_4k",
        arrival_s=short_s + 1.0, steps=1, profile="8s.128c",
        duration_s=short_s, u_compute=0.3))
    return jobs


def elastic_showcase(long_s: float = 10_000.0,
                     deadline_dur_s: float = 400.0) -> List[Job]:
    """A deterministic single-pod stream where only an elastic shrink saves
    a deadline job's SLO.

    Timeline on one 16×16 pod:

    1. t=0: a low-priority batch job (8×16) and a training job (8×16) fill
       the pod for ``long_s`` seconds each.
    2. t=10: a deadline training job arrives needing an 8×8 slice for
       ``deadline_dur_s`` seconds, with ``slo_factor=2`` — its deadline
       (arrival + 2×ideal) passes long before either holder finishes.

    Without elastic resizing the job queues until ``long_s`` and misses.
    With ``"shrink"`` in the ``PolicySpec`` allowlist (the deprecated
    ``elastic=True`` shim) the scheduler shrinks the batch
    job to the smallest profile its workload fits (priced as a repack-style
    migration over the pod's host links) and places the deadline job
    immediately — an SLO miss turned into an SLO hit on the same trace.
    """
    return [
        Job(job_id=0, kind=BATCH, arch="gpt2-124m", shape="decode_32k",
            arrival_s=0.0, steps=1, profile="8s.128c",
            duration_s=long_s, u_compute=0.05),
        Job(job_id=1, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=0.0, steps=1, profile="8s.128c",
            duration_s=long_s, u_compute=0.3),
        Job(job_id=2, kind=TRAINING, arch="qwen3-32b", shape="train_4k",
            arrival_s=10.0, steps=1, profile="4s.64c",
            duration_s=deadline_dur_s, u_compute=0.3, slo_factor=2.0),
    ]


def _steps_for(arch: str, shape: str, profile: str, nominal_s: float) -> int:
    """Step count whose modeled nominal duration on ``profile`` is closest
    to ``nominal_s`` — lets a crafted job be *progress-based* (so eviction
    can preserve its ``work_done``) while still lasting a chosen virtual
    time. Deterministic: the shared PerfModel is a pure function."""
    from repro_torch.core.perfmodel import get_model
    step = get_model().options(
        Job(job_id=-1, kind=BATCH, arch=arch, shape=shape, arrival_s=0.0,
            steps=1, profile=profile))[0].step_time
    return max(1, round(nominal_s / step))


def preemption_showcase(long_s: float = 10_000.0,
                        deadline_dur_s: float = 400.0) -> List[Job]:
    """A deterministic single-pod stream where only checkpoint-eviction
    saves a deadline job's SLO — shrinking cannot.

    Timeline on one 16×16 pod:

    1. t=0: a low-priority **progress-based** batch job (8×16, priority 0,
       ~``long_s`` nominal seconds of work) takes the top half; a
       priority-1 training job (8×16, pinned ``long_s``) takes the bottom.
    2. t=10: a priority-2 deadline training job arrives needing its own
       8×16 slice for ``deadline_dur_s`` seconds with ``slo_factor=2`` —
       its deadline passes long before either holder finishes.

    Shrinking cannot rescue it: a shrunk victim stays at its origin, so no
    aligned 8×16 rectangle is ever minted. With priorities enabled the
    scheduler checkpoint-evicts the batch job (suspend priced as the
    ``train/checkpoint.py`` save volume over the pod's host links), places
    the deadline job in its rectangle, and resumes the victim from its
    checkpoint once the rectangle frees — ``work_done`` preserved, the
    only loss being the priced save/restore delay.
    """
    return [
        Job(job_id=0, kind=BATCH, arch="gpt2-124m", shape="decode_32k",
            arrival_s=0.0, profile="8s.128c", u_compute=0.05, priority=0,
            steps=_steps_for("gpt2-124m", "decode_32k", "8s.128c", long_s)),
        Job(job_id=1, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=0.0, steps=1, profile="8s.128c",
            duration_s=long_s, u_compute=0.3, priority=1),
        Job(job_id=2, kind=TRAINING, arch="qwen3-32b", shape="train_4k",
            arrival_s=10.0, steps=1, profile="8s.128c",
            duration_s=deadline_dur_s, u_compute=0.3, slo_factor=2.0,
            priority=2),
    ]


def migration_showcase(long_s: float = 10_000.0,
                       deadline_dur_s: float = 400.0) -> List[Job]:
    """A deterministic load-imbalanced **two-pod** stream where only a
    cross-pod migration (``MigrateAcrossPods``, DCN-priced) saves a
    deadline job's SLO — every in-pod rescue is structurally or
    power-infeasible.

    Timeline on two 16×16 pods (fragmentation-aware placement):

    1. t=0: three long training holders arrive. Two *cold* ones
       (``u_compute=0.2``) fill pod 0 (8×16 each, job 0 top / job 2
       bottom); one *hot* one (``u_compute=1.0``, job 1) takes the top
       half of pod 1. Pod 0 is full-but-cool; pod 1 is half-empty-but-hot
       — the load imbalance.
    2. t=10: a priority-2 **hot** deadline training job (8×16,
       ``deadline_dur_s`` seconds, ``slo_factor=2``) arrives. The only
       free rectangle is pod 1's bottom half, but two full-power 128-chip
       tenants exceed the shared cap (throttle 0.786 < the 0.8 gate), so
       the placement is power-blocked. In-pod rescues all fail: every
       holder is a *training* job, and shrink/preempt only ever touch
       batch victims; repack has nothing to compact.
    3. With ``"migrate"`` in the ``PolicySpec`` allowlist the scheduler
       relocates the cold job 0 to pod 1 (cold next to hot stays under
       the cap), paying its resident bytes over the **DCN**
       (``PodSpec.dcn_bw``), and places the deadline job in the drained
       pod-0 rectangle next to the other cold holder — the cluster is
       re-balanced hot/cold per pod and the SLO flips from miss to hit.
    """
    return [
        Job(job_id=0, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=0.0, steps=1, profile="8s.128c",
            duration_s=long_s, u_compute=0.2, priority=1),
        Job(job_id=1, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=0.0, steps=1, profile="8s.128c",
            duration_s=long_s, u_compute=1.0, priority=1),
        Job(job_id=2, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=0.0, steps=1, profile="8s.128c",
            duration_s=long_s, u_compute=0.2, priority=1),
        Job(job_id=3, kind=TRAINING, arch="qwen3-32b", shape="train_4k",
            arrival_s=10.0, steps=1, profile="8s.128c",
            duration_s=deadline_dur_s, u_compute=1.0, slo_factor=2.0,
            priority=2),
    ]


def lookahead_showcase(long_s: float = 10_000.0,
                       deadline_dur_s: float = 400.0) -> List[Job]:
    """A deterministic single-pod stream where no *single* rescue action
    saves a deadline job, but the ``LookAheadPolicy``'s two-action chain
    (evict an enabler victim, then a second eviction places the job) does.

    Timeline on one 16×16 pod:

    1. t=0: two low-priority batch jobs (8×8 each, jobs 0-1) fill the top
       half side by side; a priority-1 training job (8×16, job 2) holds
       the bottom half. All run ``long_s`` seconds.
    2. t=10: a priority-2 deadline training job (8×16,
       ``deadline_dur_s`` seconds, ``slo_factor=2``) arrives. Evicting
       *either* batch job alone frees one 8×8 — no 8×16 origin is ever
       minted, so the greedy selector (one action per rescue) queues the
       job to an SLO miss. The look-ahead trial-applies the first
       eviction, re-probes, finds the second eviction now mints the
       origin, and commits the pair — both checkpoint drains are charged
       to the beneficiary's start delay.
    """
    return [
        Job(job_id=0, kind=BATCH, arch="gpt2-124m", shape="decode_32k",
            arrival_s=0.0, steps=1, profile="4s.64c",
            duration_s=long_s, u_compute=0.05, priority=0),
        Job(job_id=1, kind=BATCH, arch="gpt2-124m", shape="decode_32k",
            arrival_s=0.0, steps=1, profile="4s.64c",
            duration_s=long_s, u_compute=0.05, priority=0),
        Job(job_id=2, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=0.0, steps=1, profile="8s.128c",
            duration_s=long_s, u_compute=0.3, priority=1),
        Job(job_id=3, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=10.0, steps=1, profile="8s.128c",
            duration_s=deadline_dur_s, u_compute=0.3, slo_factor=2.0,
            priority=2),
    ]


def search_showcase(long_s: float = 10_000.0,
                    deadline_dur_s: float = 400.0) -> List[Job]:
    """A deterministic single-pod stream whose deadline job needs a
    *three*-action chain — beyond the two-step ``LookAheadPolicy``, found
    only by ``SearchPolicy(max_depth=3)``.

    Timeline on one 16×16 pod:

    1. t=0: two low-priority batch jobs (8×8, jobs 0-1) fill the top half
       and a third batch job (8×16, job 2) holds the bottom half — the
       pod is completely full. All run ``long_s`` seconds.
    2. t=10: a priority-2 deadline training job pinned to the **full
       pod** (16×16, ``deadline_dur_s`` seconds, ``slo_factor=2``)
       arrives. No single rescue mints a 16×16 origin (greedy queues it),
       and the look-ahead's one enabler plus one closer releases at most
       two of the three resident rectangles — its closer probe still
       finds no full-pod origin, so the chain never lands and the job
       misses. The search policy trial-applies two evictions (recorded,
       nested) and closes with a third, beneficiary-bound eviction whose
       probe now sees an empty grid: a cheapest three-eviction chain,
       every checkpoint drain charged to the beneficiary's start delay.
    """
    return [
        Job(job_id=0, kind=BATCH, arch="gpt2-124m", shape="decode_32k",
            arrival_s=0.0, steps=1, profile="4s.64c",
            duration_s=long_s, u_compute=0.05, priority=0),
        Job(job_id=1, kind=BATCH, arch="gpt2-124m", shape="decode_32k",
            arrival_s=0.0, steps=1, profile="4s.64c",
            duration_s=long_s, u_compute=0.05, priority=0),
        Job(job_id=2, kind=BATCH, arch="gpt2-124m", shape="decode_32k",
            arrival_s=0.0, steps=1, profile="8s.128c",
            duration_s=long_s, u_compute=0.05, priority=0),
        Job(job_id=3, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=10.0, steps=1, profile="16s.256c",
            duration_s=deadline_dur_s, u_compute=0.3, slo_factor=2.0,
            priority=2),
    ]


def grow_showcase(short_s: float = 50.0,
                  long_nominal_s: float = 2_000.0) -> List[Job]:
    """A deterministic single-pod stream where a running job absorbs freed
    neighbour chips via the partitioner's ``extend()`` primitive.

    Timeline on one 16×16 pod:

    1. t=0: a **progress-based** training job (8×8, ~``long_nominal_s``
       nominal seconds of work) and a short pinned batch job (8×8,
       ``short_s`` wall seconds) are placed side by side in the top half.
    2. t=``short_s``: the batch job completes and its rectangle frees.
       With ``"grow"`` in the ``PolicySpec`` allowlist (the deprecated
       ``grow=True`` shim) the training job extends its
       slice into the freed neighbours (priced as a host-link migration,
       symmetric to the elastic shrink), ``PodSimulator.resize`` re-bases
       its remaining work onto the faster step time, and its projected
       finish in ``PodSimulator.finish_times`` improves; with ``grow``
       left off it runs out its original 8×8 slice to a later finish.
    """
    return [
        Job(job_id=0, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=0.0, profile="4s.64c", priority=1,
            steps=_steps_for("llama3-8b", "train_4k", "4s.64c",
                             long_nominal_s)),
        Job(job_id=1, kind=BATCH, arch="gpt2-124m", shape="decode_32k",
            arrival_s=0.0, steps=1, profile="4s.64c",
            duration_s=short_s, u_compute=0.05, priority=0),
    ]


def reconfigure_showcase(long_s: float = 50_000.0,
                         deadline_nominal_s: float = 8_000.0) -> List[Job]:
    """A deterministic **two-pod mi300** stream where only a partition-mode
    reconfigure (``ReconfigurePartition``) saves a deadline job's SLO — no
    eviction chain can, because nothing about the *fixed-mode* hardware is
    fast enough.

    Timeline on two 16×16 mi300 pods booted in ``spx-nps1``
    (fragmentation-aware placement):

    1. t=0: two long priority-1 **training** holders (8×16 each,
       ``long_s`` pinned seconds) arrive; frag-aware placement puts one
       on each pod — 128 chips free per pod, no 256-chip rectangle
       anywhere.
    2. t=10: a priority-0 **batch** decode job pinned to a full pod
       (16s.256c, ~``deadline_nominal_s`` modeled seconds of work,
       ``slo_factor=0.9``) arrives. Decode at that scale is HBM-bound,
       so its deadline (arrival + 0.9 × the NPS1 ideal) is *sub-ideal*:
       no NPS1 placement — on these pods or an empty one — can meet it,
       which makes every eviction rescue structurally futile
       (``slo_profiles`` is empty), and the holders outrank it anyway
       (shrink/preempt/migrate victims need strictly lower priority).
    3. With ``"reconfigure"`` in the ``PolicySpec`` allowlist the
       scheduler drains pod 0's holder to pod 1 (the beneficiary-less
       DCN-priced ``MigrateTenant`` move), pays the fixed mode-switch
       downtime, flips pod 0 to ``cpx-nps4`` (NPS4 memory interleaving:
       1.3× effective HBM bandwidth), and places the job under the
       target mode's PerfModel — its bandwidth-bound step time drops
       ~1.3×, beating the 0.9 deadline with the drain + downtime charged
       to its start delay. ``cpx-nps1`` (compute-only uplift) is probed
       first in mode-name order and correctly rejected: the job is not
       FLOP-bound. Without ``"reconfigure"`` the job queues until a
       holder finishes at ``long_s`` and **misses** — the same trace
       flips miss → hit on the mode switch alone.
    """
    from repro_torch.core.hw import MI300X, get_mode
    from repro_torch.core.perfmodel import model_for_mode
    perf = model_for_mode(MI300X, get_mode(MI300X, "spx-nps1"))
    step = perf.options(
        Job(job_id=-1, kind=BATCH, arch="llama3-8b", shape="decode_32k",
            arrival_s=0.0, steps=1, profile="16s.256c"))[0].step_time
    return [
        Job(job_id=0, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=0.0, steps=1, profile="8s.128c",
            duration_s=long_s, u_compute=0.3, priority=1),
        Job(job_id=1, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=0.0, steps=1, profile="8s.128c",
            duration_s=long_s, u_compute=0.3, priority=1),
        Job(job_id=2, kind=BATCH, arch="llama3-8b", shape="decode_32k",
            arrival_s=10.0, profile="16s.256c", u_compute=0.3,
            steps=max(1, round(deadline_nominal_s / step)),
            slo_factor=0.9, priority=0),
    ]


def twin_showcase(long_s: float = 1_500.0,
                  steps: int = 1_000,
                  slo_factor: float = 25.0) -> List[Job]:
    """A deterministic single-pod stream where a deadline job is only
    rescuable by a **twin-offload shrink**: the pure elastic shrink
    misses the SLO and preemption is blocked by the priority discipline.

    Timeline on one 16×16 pod (completely full at t=0):

    1. t=0: three pinned **training** holders (8×16 at the bottom, 8×8
       and a 4×8) plus a low-utilisation pinned **batch** decode job on
       a 2s.32c slice (4×8) fill all 256 chips for ``long_s`` seconds.
       Training jobs refuse ``ignore_pin`` resizing, so the batch job is
       the only shrinkable victim — and shrinking it 2s.32c → 1s.16c
       mints exactly one 4×4 hole.
    2. t=10: an **unpinned** llama3-8b ``decode_32k`` serving job
       arrives with a deadline (``slo_factor`` × its ideal duration,
       which comes from the big clean profiles and is therefore
       identical whether or not twin pricing is enabled). Its KV cache
       does not fit a 16-chip slice: the plain ``1s.16c`` rung spills
       the KV tail over the host link and is ~5× too slow for the
       deadline, while every plain rung that *would* meet it needs at
       least a 4×8 rectangle — more than the shrink can mint.
    3. With ``ClusterScheduler(twin=True)`` the PerfModel also prices
       the ``1s.16c+cpu…`` twin rung — the spilled KV tail's gather
       runs host-side against DRAM instead of round-tripping the link —
       which meets the deadline on the 4×4 the shrink mints: the
       ``shrink`` action fires and the job **hits** its SLO. With twin
       pricing off there is no feasible rescue (preemption finds no
       strictly-lower-priority victim), the job waits for a holder to
       finish and **misses**. One flag, opposite verdicts.
    """
    return [
        Job(job_id=0, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=0.0, steps=1, profile="8s.128c",
            duration_s=long_s, u_compute=0.3, priority=0),
        Job(job_id=1, kind=TRAINING, arch="qwen3-32b", shape="train_4k",
            arrival_s=0.0, steps=1, profile="4s.64c",
            duration_s=long_s, u_compute=0.3, priority=0),
        Job(job_id=2, kind=BATCH, arch="gpt2-124m", shape="decode_32k",
            arrival_s=0.0, steps=1, profile="2s.32c",
            duration_s=long_s, u_compute=0.05, priority=0),
        Job(job_id=3, kind=TRAINING, arch="llama3-8b", shape="train_4k",
            arrival_s=0.0, steps=1, profile="2s.32c",
            duration_s=long_s, u_compute=0.3, priority=0),
        Job(job_id=4, kind=SERVING, arch="llama3-8b", shape="decode_32k",
            arrival_s=10.0, steps=steps, slo_factor=slo_factor,
            priority=0),
    ]
