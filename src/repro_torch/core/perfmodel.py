"""PerfModel + PodSimulator — the one performance engine under the planner,
the cluster scheduler, and the serving runtime.

Before this module existed, four consumers (cluster placement, the cluster
scheduler, ``core/cosched.py``, ``serving/runtime.py``) each glued
``WorkloadEstimate.roofline_on`` to ``core.power.throttle_factor`` by hand,
and the scheduler froze every job's duration at admission time. The paper's
§V-B point is exactly that this is wrong: static slices isolate compute and
memory but share the pod power cap, so a job's *effective* speed changes
every time the tenant mix changes. MISO (arXiv 2207.11428) re-probes
placements as load shifts, and online MIG scheduling (arXiv 2512.16099)
prices reconfiguration against current progress — both need a performance
model that can be re-solved mid-flight.

Two layers:

* ``PerfModel`` — memoized (config × shape × profile) scoring: offload plan
  for fit, roofline terms for speed, power-throttle/co-run wrappers for the
  shared-cap surface. Optionally calibrated by *measured* anchors from the
  dry-run HLO artifacts (``benchmarks/roofline.py`` reads the same files):
  an anchor's compiled per-chip FLOPs/bytes rescale the analytic compute and
  memory terms for that (arch, shape) at every profile.
* ``PodSimulator`` — a progress-based execution engine. Jobs carry
  ``work_done / work_total``; every admission, completion, resize, or delay
  re-solves the pod throttle for the new mix and re-projects every remaining
  finish time. ``frozen=True`` reproduces the legacy fixed-at-admission
  durations bit-for-bit (same float expressions, same summation order), so
  the fixed-duration scheduler timelines stay exactly reproducible.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSuite
from repro_torch.core.hw import ChipSpec, PodSpec, V5E, V5E_POD
from repro_torch.core.offload import OffloadPlan, TwinOffloadPlan, TwinSpec
from repro_torch.core.power import (InstanceLoad, co_run, pod_draw, serial_run,
                              throttle_factor)
from repro_torch.core.roofline import RooflineTerms
from repro_torch.core.slices import PROFILES, SliceProfile, get_profile
from repro_torch.core.workload import WorkloadEstimate


# ---------------------------------------------------------------------------
# measured anchors (dry-run HLO artifacts)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Anchor:
    """Measured-from-HLO per-chip counts for one compiled (arch, shape)."""
    arch: str
    shape: str
    n_chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    step_time_s: float

    @property
    def flops_global(self) -> float:
        return self.hlo_flops_per_chip * self.n_chips

    @property
    def bytes_global(self) -> float:
        return self.hlo_bytes_per_chip * self.n_chips


def load_anchors(artifact_dir: str, mesh: str = "single"
                 ) -> Dict[Tuple[str, str], Anchor]:
    """Read ``<artifact_dir>/<mesh>/arch__shape.json`` dry-run records (the
    files ``benchmarks/roofline.py`` tabulates) into calibration anchors.
    Missing directory → no anchors; skipped/failed cells are ignored."""
    d = os.path.join(artifact_dir, mesh)
    anchors: Dict[Tuple[str, str], Anchor] = {}
    if not os.path.isdir(d):
        return anchors
    for f in sorted(os.listdir(d)):
        if not f.endswith(".json") or f.count("__") != 1:
            continue
        with open(os.path.join(d, f)) as fh:
            rec = json.load(fh)
        if rec.get("skipped") or rec.get("error") or "roofline" not in rec:
            continue
        r = rec["roofline"]
        anchors[(rec["arch"], rec["shape"])] = Anchor(
            arch=rec["arch"], shape=rec["shape"],
            n_chips=int(r["n_chips"]),
            hlo_flops_per_chip=float(r["hlo_flops_per_chip"]),
            hlo_bytes_per_chip=float(r["hlo_bytes_per_chip"]),
            step_time_s=float(r["step_time_s"]))
    return anchors


# ---------------------------------------------------------------------------
# PerfModel
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PerfScore:
    """One scored (workload × profile) point — everything a consumer needs
    to place, admit, or account a job without re-touching the roofline."""
    profile: SliceProfile
    plan: OffloadPlan
    terms: RooflineTerms
    step_time: float
    u_compute: float           # compute share of the step (power-model util)
    perf_per_chip: float       # (1/step)/n_chips — the MISO ranking score
    calibrated: bool = False   # True when a measured anchor rescaled terms
    # twin-offload rung: the solved CPU co-execution split behind this
    # score's terms; None for every plain (GPU-only) score
    twin: Optional[TwinOffloadPlan] = None

    @property
    def rung(self) -> str:
        """Display/cache identity of this elastic rung: the profile name,
        suffixed with the CPU fraction for twin rungs (``4s.64c+cpu0.60``).
        Probe caches key on this instead of ``profile.name`` so a twin and a
        plain score on the same rectangle never collide."""
        if self.twin is None:
            return self.profile.name
        return f"{self.profile.name}+cpu{self.twin.cpu_fraction:.2f}"

    def load(self, steps: int = 1) -> InstanceLoad:
        return InstanceLoad(self.profile.n_chips, self.u_compute,
                            self.step_time, steps)


@dataclass(frozen=True)
class CheckpointCost:
    """Priced suspend/resume of one tenant's resident state.

    Models what ``train/checkpoint.py`` actually moves: ``save`` host-
    gathers every resident leaf over the slice's host links (device →
    host DRAM, then disk — the link is the bottleneck at PCIe-class
    bandwidth), ``restore`` streams the same bytes back and
    ``device_put``s them onto the resuming slice (possibly a different
    one — elastic restart). Units: ``bytes`` in bytes, ``save_s`` /
    ``restore_s`` in wall-clock seconds over the given link bandwidth."""
    bytes: int
    save_s: float
    restore_s: float

    @property
    def total_s(self) -> float:
        return self.save_s + self.restore_s


@dataclass(frozen=True)
class CoRunSummary:
    """Shared-power-cap account of one concurrent mix (paper Figs. 5-7)."""
    throttle: float
    throttled: bool
    makespan_s: float
    energy_J: float
    effective_times: Tuple[float, ...]


class PerfModel:
    """Memoized workload → profile → plan scoring over the analytic model,
    optionally calibrated by measured dry-run anchors."""

    _MAX_JOB_MEMO = 4096   # matches the old feasible_options lru_cache bound

    def __init__(self, chip: ChipSpec = V5E,
                 anchors: Optional[Dict[Tuple[str, str], Anchor]] = None,
                 twin: Optional[TwinSpec] = None,
                 profiles: Optional[Sequence[SliceProfile]] = None):
        self.chip = chip
        self.anchors = dict(anchors) if anchors else {}
        # default-off twin-offload rungs: a TwinSpec turns on CPU
        # co-execution scoring (score_twin / extra options rows)
        self.twin = twin
        # the slice ladder this model scores over — partition modes with a
        # granularity floor (MI300 SPX) pass a filtered ladder; the default
        # is the full table, and a full ladder is normalized back to the
        # module constant so the default identity (and every pin keyed on
        # it) is untouched
        self.profiles: Tuple[SliceProfile, ...] = (
            PROFILES if profiles is None or tuple(profiles) == PROFILES
            else tuple(profiles))
        # scoring-identity token: two models with the same chip and the
        # same anchor set price every (workload, profile) identically, so
        # probe caches keyed on this never leak scores across an
        # anchored/analytic (or cross-chip) model swap; twin enablement is
        # part of the identity for the same reason (same token as before
        # when twin is off, so existing pins are untouched). A gated
        # ladder is part of the identity too: two modes sharing a chip
        # name but differing in granularity floor must not share probes.
        self.profile_key: Tuple = (chip.name, tuple(sorted(self.anchors)))
        if self.profiles is not PROFILES:
            self.profile_key += (
                ("ladder",) + tuple(p.name for p in self.profiles),)
        if twin is not None:
            self.profile_key += (("twin", twin.host.name,
                                  twin.host.c2c_coherent, twin.min_speedup,
                                  twin.max_cpu_fraction),)
        self._workloads: Dict[tuple, WorkloadEstimate] = {}
        self._scores: Dict[tuple, Optional[PerfScore]] = {}
        self._options: Dict[tuple, Tuple[PerfScore, ...]] = {}
        self._slo: "OrderedDict[object, tuple]" = OrderedDict()

    @classmethod
    def from_artifacts(cls, artifact_dir: str, mesh: str = "single",
                       chip: ChipSpec = V5E) -> "PerfModel":
        return cls(chip=chip, anchors=load_anchors(artifact_dir, mesh))

    # -- workload layer -------------------------------------------------
    def workload(self, cfg: ModelConfig, shape: ShapeSuite) -> WorkloadEstimate:
        key = (cfg, shape)
        wl = self._workloads.get(key)
        if wl is None:
            wl = self._workloads[key] = WorkloadEstimate(cfg, shape)
        return wl

    # -- calibration ----------------------------------------------------
    def _calibration(self, wl: WorkloadEstimate) -> Tuple[float, float]:
        """(flops_scale, bytes_scale) from a measured anchor, or (1, 1).

        The anchor's compiled global FLOPs/bytes over the analytic ones —
        compile-time realities (remat recompute, padding, fused transposes)
        the closed forms can't see. The ratio is profile-independent, so one
        anchored mesh calibrates every slice size of that (arch, shape)."""
        a = self.anchors.get((wl.cfg.name, wl.shape.name))
        if a is None:
            return 1.0, 1.0
        flops = wl.flops()
        nbytes = wl.hbm_bytes()
        return (a.flops_global / flops if flops else 1.0,
                a.bytes_global / nbytes if nbytes else 1.0)

    # -- scoring layer --------------------------------------------------
    def score(self, cfg: ModelConfig, shape: ShapeSuite,
              profile: SliceProfile) -> Optional[PerfScore]:
        """Plan + (possibly anchor-calibrated) roofline terms for one
        workload on one profile; ``None`` when it cannot fit even with
        everything offloadable spilled. Memoized."""
        key = (cfg, shape, profile)
        if key in self._scores:
            return self._scores[key]
        wl = self.workload(cfg, shape)
        plan = wl.plan_for(profile, self.chip)
        if not plan.fits:
            self._scores[key] = None
            return None
        spilled = plan.offloaded or plan.partial
        terms = wl.roofline_on(profile, self.chip, plan if spilled else None)
        fs, bs = self._calibration(wl)
        calibrated = (fs, bs) != (1.0, 1.0)
        if calibrated:
            terms = replace(terms, t_compute=terms.t_compute * fs,
                            t_memory=terms.t_memory * bs,
                            hlo_flops=terms.hlo_flops * fs,
                            hlo_bytes=terms.hlo_bytes * bs)
        step = terms.step_time
        sc = PerfScore(
            profile=profile, plan=plan, terms=terms, step_time=step,
            u_compute=terms.t_compute / step if step else 0.0,
            perf_per_chip=(1.0 / step) / profile.n_chips if step else 0.0,
            calibrated=calibrated)
        self._scores[key] = sc
        return sc

    def score_twin(self, cfg: ModelConfig, shape: ShapeSuite,
                   profile: SliceProfile) -> Optional[PerfScore]:
        """Twin-offload rung for one workload on one profile: the same
        rectangle with part of the compute co-executed host-side.

        ``None`` unless this model was built with a ``TwinSpec``, the plain
        score exists, something compute-bearing actually spilled, and the
        solved split beats the plain step time by ``twin.min_speedup`` —
        rungs that don't pay for themselves are never emitted, so every
        downstream consumer (placement, shrink probes, the autoscaler) can
        treat a twin rung as strictly better perf-per-chip at equal chips.
        Memoized alongside ``score``."""
        if self.twin is None:
            return None
        key = (cfg, shape, profile, "twin")
        if key in self._scores:
            return self._scores[key]
        out: Optional[PerfScore] = None
        plain = self.score(cfg, shape, profile)
        if plain is not None:
            wl = self.workload(cfg, shape)
            tp = wl.twin_plan_for(profile, self.chip, self.twin.host,
                                  max_cpu_fraction=self.twin.max_cpu_fraction)
            if tp is not None and tp.shards:
                terms = wl.roofline_twin(profile, tp, self.chip)
                fs, bs = self._calibration(wl)
                calibrated = (fs, bs) != (1.0, 1.0)
                if calibrated:
                    terms = replace(terms, t_compute=terms.t_compute * fs,
                                    t_memory=terms.t_memory * bs,
                                    hlo_flops=terms.hlo_flops * fs,
                                    hlo_bytes=terms.hlo_bytes * bs)
                step = terms.step_time
                if step and plain.step_time / step >= self.twin.min_speedup:
                    out = PerfScore(
                        profile=profile, plan=tp.base, terms=terms,
                        step_time=step,
                        u_compute=terms.t_compute / step,
                        perf_per_chip=(1.0 / step) / profile.n_chips,
                        calibrated=calibrated, twin=tp)
        self._scores[key] = out
        return out

    def options(self, job, ignore_pin: bool = False) -> Tuple[PerfScore, ...]:
        """Every profile a trace job fits on (possibly only via offloading),
        smallest first. A pinned ``job.profile`` restricts the set unless
        ``ignore_pin`` (the elastic shrink/grow path scans the full table).
        With twin rungs enabled each profile may contribute a second row —
        plain first, then its (faster) twin rung, preserving the
        smallest-chips-first order. Memoized per job — the scheduler's
        placement retries are free."""
        key = (job, ignore_pin)
        if key in self._options:
            return self._options[key]
        if len(self._options) >= self._MAX_JOB_MEMO:
            # jobs are unique per trace; bound the only unbounded memo (the
            # cfg/shape/profile tables are naturally small)
            self._options.clear()
        cfg, shape = get_config(job.arch), get_shape(job.shape)
        if ignore_pin or not job.profile:
            profs: Tuple[SliceProfile, ...] = self.profiles
        else:
            pinned = get_profile(job.profile)
            # a pin below the mode's granularity floor is unschedulable on
            # this model — the ladder is the hardware's word, not a hint
            profs = (pinned,) if pinned in self.profiles else ()
        rows: List[PerfScore] = []
        for p in profs:
            sc = self.score(cfg, shape, p)
            if sc is None:
                continue
            rows.append(sc)
            tw = self.score_twin(cfg, shape, p)
            if tw is not None:
                rows.append(tw)
        out = tuple(rows)
        self._options[key] = out
        return out

    def score_many(self, cfgs: Iterable[ModelConfig],
                   shapes: Iterable[ShapeSuite],
                   profiles: Optional[Sequence[SliceProfile]] = None,
                   ) -> Dict[Tuple[str, str, str], Optional[PerfScore]]:
        """Batched scoring over the full cfg × shape × profile cross
        product in one call — each workload is materialized once and its
        whole profile row is filled before moving on, so a trace loader or
        benchmark can pre-warm the memo for every (arch, shape) it is
        about to replay instead of paying cold ``score`` misses scattered
        through the scheduler's hot path. Returns
        ``{(cfg.name, shape.name, profile.name): PerfScore | None}``;
        every entry also lands in the shared ``score`` memo."""
        if profiles is None:
            profiles = self.profiles   # this model's (possibly gated) ladder
        out: Dict[Tuple[str, str, str], Optional[PerfScore]] = {}
        for cfg in cfgs:
            for shape in shapes:
                self.workload(cfg, shape)   # one estimate per pair
                for p in profiles:
                    out[(cfg.name, shape.name, p.name)] = \
                        self.score(cfg, shape, p)
                    tw = self.score_twin(cfg, shape, p)
                    if tw is not None:
                        out[(cfg.name, shape.name, tw.rung)] = tw
        return out

    _MAX_SLO_MEMO = 4096

    def slo_table(self, job) -> Tuple[Tuple[PerfScore, float], ...]:
        """LRU of ``(score, unthrottled modeled duration)`` rows for one
        trace job, smallest profile first — the deadline filter in
        ``cluster.actions.slo_profiles`` becomes one comparison per row
        instead of a fresh options scan + duration multiply per probe.
        Keyed on the job itself (its tag/pin/steps are all hash inputs);
        throttle state is deliberately *not* in the key because the rows
        are unthrottled nominal durations — each probe re-checks its own
        start delay against the live pod via ``meets_after``."""
        hit = self._slo.get(job)
        if hit is not None:
            self._slo.move_to_end(job)
            return hit
        rows = tuple(
            (sc, job.duration_s if job.duration_s is not None
             else job.steps * sc.step_time)
            for sc in self.options(job))
        self._slo[job] = rows
        if len(self._slo) > self._MAX_SLO_MEMO:
            self._slo.popitem(last=False)
        return rows

    # -- power surface (paper §V-B) -------------------------------------
    def throttle(self, loads: Sequence[InstanceLoad],
                 pod: PodSpec = V5E_POD) -> float:
        """Shared-cap frequency-scale factor f ≤ 1 for a concurrent mix."""
        return throttle_factor(loads, pod)

    def draw(self, loads: Sequence[InstanceLoad], pod: PodSpec = V5E_POD,
             capped: bool = True) -> float:
        d = pod_draw(loads, pod)
        return min(d, pod.power_cap_watts) if capped else d

    def corun(self, loads: Sequence[InstanceLoad],
              pod: PodSpec = V5E_POD) -> CoRunSummary:
        """Concurrent-mix account: throttle, makespan, piecewise energy."""
        f = throttle_factor(loads, pod)
        makespan, energy, eff = co_run(loads, pod)
        return CoRunSummary(throttle=f, throttled=f < 1.0,
                            makespan_s=makespan, energy_J=energy,
                            effective_times=tuple(eff))

    # -- checkpoint pricing (preemption / resume) ------------------------
    def checkpoint_cost(self, resident_bytes: int,
                        host_link_bw: float) -> CheckpointCost:
        """Price a checkpoint-based suspend/resume of ``resident_bytes``
        (the tenant's device-resident state, bytes) over ``host_link_bw``
        (aggregate host-link bytes/s of the slice or pod involved).

        This is the cost model the cluster scheduler's preemption path
        uses: evicting a job pays ``save_s`` before the freed rectangle is
        usable (the ``train/checkpoint.py`` save volume: one host-gather
        of every resident leaf), and resuming pays ``restore_s`` before
        progress continues (the restore volume: the same leaves streamed
        back and re-placed — ``checkpoint.restore`` accepts a different
        slice's shardings, so the resuming slice need not be the one that
        saved). The cross-pod ``MigrateAcrossPods`` action prices the
        identical save/restore pair over the pod's DCN instead — pass
        ``PodSpec.dcn_bw`` (bytes/s) as the link bandwidth."""
        bw = max(host_link_bw, 1.0)
        seconds = resident_bytes / bw
        return CheckpointCost(bytes=int(resident_bytes),
                              save_s=seconds, restore_s=seconds)

    def serial_baseline(self, load: InstanceLoad, copies: int,
                        pod: PodSpec = V5E_POD) -> Tuple[float, float]:
        """Paper Fig. 5/6 serial full-pod baseline (makespan, energy)."""
        return serial_run(load, copies, pod)


_MODELS: Dict[tuple, PerfModel] = {}


def get_model(chip: ChipSpec = V5E,
              twin: Optional[TwinSpec] = None,
              profiles: Optional[Sequence[SliceProfile]] = None) -> PerfModel:
    """Process-wide shared PerfModel per (chip spec, twin spec, ladder), so
    the placement policies, the scheduler, cosched, and the serving runtime
    all hit one memo table. Twin-enabled models are separate instances — the
    default twin-off model (and every pin that depends on it) is untouched.
    A full (or omitted) ladder normalizes to the legacy two-tuple key, so
    pre-existing entries and identities are bit-identical. Anchored models
    are built explicitly and passed around."""
    if profiles is not None and tuple(profiles) == PROFILES:
        profiles = None
    key = ((chip, twin) if profiles is None
           else (chip, twin, tuple(profiles)))
    m = _MODELS.get(key)
    if m is None:
        m = _MODELS[key] = PerfModel(chip, twin=twin, profiles=profiles)
    return m


def model_for_mode(chip: ChipSpec, mode, twin: Optional[TwinSpec] = None
                   ) -> PerfModel:
    """The shared PerfModel of ``chip`` under partition mode ``mode`` — the
    mode's roofline deltas folded in via ``effective_chip`` and its
    granularity floor via the profile ladder. For an identity mode with the
    full ladder (v5e ``fixed``, mi300 ``spx-nps1`` compute side) this
    returns the *same object* as ``get_model(chip, twin)`` would for the
    effective chip, so fixed-mode pins are untouched."""
    from repro_torch.core.hw import effective_chip, ladder_for
    return get_model(effective_chip(chip, mode), twin=twin,
                     profiles=ladder_for(mode))


# ---------------------------------------------------------------------------
# PodSimulator
# ---------------------------------------------------------------------------
@dataclass
class SimJob:
    """Progress state of one instance on the simulated pod.

    ``fixed_s`` set → the duration is pinned (crafted job) or frozen at
    admission (compatibility mode): wall time only, never re-solved.
    Otherwise ``work_done/work_total`` are in *nominal unthrottled seconds*;
    the wall-time cost of one nominal second under throttle f is
    ``stretch(f) = u/f + (1 - u)`` (only the compute share scales)."""
    key: int
    n_chips: int
    u_compute: float
    step_time: float
    steps: int
    work_total: float = 0.0
    work_done: float = 0.0
    delay_s: float = 0.0        # pending wall delay (migration) before work
    fixed_s: Optional[float] = None   # remaining pinned/frozen wall duration
    pinned: bool = False        # fixed_s came from Job.duration_s, not frozen

    @property
    def progress(self) -> float:
        return self.work_done / self.work_total if self.work_total else 0.0

    def load(self) -> InstanceLoad:
        return InstanceLoad(self.n_chips, self.u_compute, self.step_time, 1)

    def stretch(self, f: float) -> float:
        return self.u_compute / f + (1.0 - self.u_compute)


class PodSimulator:
    """Progress-based execution engine for one pod's concurrent mix.

    The owner (``cluster.ClusterScheduler``) drives virtual time through
    ``advance`` between its events; every mutation (``admit`` / ``remove`` /
    ``resize`` / ``delay``) changes the mix, after which ``finish_times``
    re-solves the throttle and re-projects every live progress job. In
    ``frozen=True`` mode durations are fixed at admission with the exact
    legacy float expressions and ``finish_times`` projects nothing — the
    event stream is bit-identical to the fixed-duration scheduler."""

    def __init__(self, pod: PodSpec = V5E_POD, frozen: bool = False):
        self.pod = pod
        self.frozen = frozen
        self.now = 0.0
        self.jobs: Dict[int, SimJob] = {}
        self._gen = 0          # bumped on every mix mutation
        self._cache_gen = -1
        self._cache: dict = {}

    @property
    def generation(self) -> int:
        """Monotone mix-mutation counter (``admit``/``remove``/``resize``/
        rollback ``invalidate``). Equal generations mean an identical
        instance mix — and therefore identical throttle/draw solutions —
        which is what the scheduler's ``ProbeCache`` keys on. ``advance``
        and ``delay`` do not move it: progress and start-delay burn-down
        never change a structural probe's outcome."""
        return self._gen

    def invalidate(self) -> None:
        """Drop the cached throttle/draw solution after external mutation
        of ``jobs`` (transaction rollback swaps the dict wholesale)."""
        self._gen += 1

    def _mix_cache(self) -> dict:
        """Throttle and draw depend only on the instance mix, which is
        constant between mutations — one linear back-off solve per mix
        generation instead of one per event. Keyed probes (``throttle``
        with an ``extra`` load) share the same lifetime."""
        if self._cache_gen != self._gen:
            self._cache_gen = self._gen
            self._cache = {"throttle": None, "draw": None, "extra": {}}
        return self._cache

    # -- mix queries ----------------------------------------------------
    def loads(self, extra: Optional[InstanceLoad] = None) -> List[InstanceLoad]:
        out = [j.load() for j in self.jobs.values()]
        if extra is not None:
            out.append(extra)
        return out

    def throttle(self, extra: Optional[InstanceLoad] = None) -> float:
        cache = self._mix_cache()
        if extra is None:
            if cache["throttle"] is None:
                cache["throttle"] = throttle_factor(self.loads(), self.pod)
            return cache["throttle"]
        f = cache["extra"].get(extra)
        if f is None:
            f = throttle_factor(self.loads(extra), self.pod)
            cache["extra"][extra] = f
        return f

    def draw(self, capped: bool = True) -> float:
        cache = self._mix_cache()
        if cache["draw"] is None:
            cache["draw"] = pod_draw(self.loads(), self.pod)
        d = cache["draw"]
        return min(d, self.pod.power_cap_watts) if capped else d

    # -- time -----------------------------------------------------------
    def advance(self, t: float) -> None:
        """Accrue progress (and burn down delays) to virtual time ``t``;
        the mix must not have changed since the last mutation."""
        dt = t - self.now
        if dt <= 0:
            self.now = max(self.now, t)
            return
        f = self.throttle() if self.jobs else 1.0
        for j in self.jobs.values():
            take = min(dt, j.delay_s)
            j.delay_s -= take
            run = dt - take
            if run <= 0:
                continue
            if j.fixed_s is not None:
                j.fixed_s = max(0.0, j.fixed_s - run)
            else:
                j.work_done = min(j.work_total,
                                  j.work_done + run / j.stretch(f))
        self.now = t

    # -- mutations ------------------------------------------------------
    def admit(self, key: int, n_chips: int, u_compute: float,
              step_time: float, steps: int, t: float, *,
              duration_s: Optional[float] = None,
              start_delay: float = 0.0,
              work_done: float = 0.0,
              fixed_remaining: Optional[float] = None) -> float:
        """Add an instance at time ``t``; returns its projected finish.

        Pinned ``duration_s`` → wall-clock duration regardless of throttle
        (crafted traces stay exactly deterministic). Frozen mode computes
        the duration once, with the legacy expression, at the admission-time
        throttle of the mix *including* the new instance.

        The resume-from-checkpoint path re-admits a previously evicted
        instance with its progress preserved: ``work_done`` (nominal
        unthrottled seconds already completed, progress jobs) or
        ``fixed_remaining`` (remaining wall seconds, frozen-mode jobs —
        overrides the legacy admission-time expression). A resumed pinned
        job simply passes its remaining wall time as ``duration_s``."""
        assert key not in self.jobs
        job = SimJob(key=key, n_chips=n_chips, u_compute=u_compute,
                     step_time=step_time, steps=steps, delay_s=start_delay)
        if duration_s is not None:
            job.fixed_s = duration_s
            job.pinned = True
            finish = t + start_delay + duration_s
        elif fixed_remaining is not None:
            job.fixed_s = fixed_remaining
            finish = t + start_delay + fixed_remaining
        elif self.frozen:
            # legacy float arithmetic, term for term (bit-identity contract)
            f = throttle_factor(self.loads(job.load()), self.pod)
            t_comp = step_time * u_compute
            dur = steps * (t_comp / f + (step_time - t_comp))
            job.fixed_s = dur
            finish = t + start_delay + dur
        else:
            job.work_total = steps * step_time
            job.work_done = min(work_done, job.work_total)
            f = throttle_factor(self.loads(job.load()), self.pod)
            finish = t + start_delay \
                + (job.work_total - job.work_done) * job.stretch(f)
        self.jobs[key] = job
        self._gen += 1
        return finish

    def remove(self, key: int) -> SimJob:
        self._gen += 1
        return self.jobs.pop(key)

    def delay(self, key: int, extra_s: float) -> None:
        """Add wall delay (migration) to one instance."""
        self.jobs[key].delay_s += extra_s

    def resize(self, key: int, n_chips: int, u_compute: float,
               step_time: float) -> None:
        """Elastic shrink/grow: move an instance to a different profile,
        preserving its *fraction* of work done — remaining work is re-based
        onto the new step time. Pinned wall-clock durations stay pinned;
        a frozen (fixed-at-admission) duration has its remaining wall time
        scaled by the step-time ratio."""
        j = self.jobs[key]
        if j.pinned:
            pass   # Job.duration_s is a wall-clock contract, profile-free
        elif j.fixed_s is not None:
            j.fixed_s *= step_time / j.step_time
        else:
            frac = j.progress
            j.work_total = j.steps * step_time
            j.work_done = frac * j.work_total
        j.n_chips = n_chips
        j.u_compute = u_compute
        j.step_time = step_time
        self._gen += 1

    # -- projection -----------------------------------------------------
    def projected_finish(self, key: int, t: float) -> float:
        """Projected finish of one instance (fixed or progress) at ``t``."""
        j = self.jobs[key]
        if j.fixed_s is not None:
            return t + j.delay_s + j.fixed_s
        return t + j.delay_s + (j.work_total - j.work_done) \
            * j.stretch(self.throttle())
    def finish_times(self, t: float) -> Dict[int, float]:
        """Projected finish for every *progress* job under the current mix
        (fixed-duration jobs are event-driven by the owner and never
        re-projected — that is the frozen/pinned contract)."""
        live = [j for j in self.jobs.values() if j.fixed_s is None]
        if not live:
            return {}
        f = self.throttle()
        return {j.key: t + j.delay_s + (j.work_total - j.work_done)
                * j.stretch(f) for j in live}
