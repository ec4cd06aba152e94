"""Aggregate cluster metrics: the quantities §V of the paper argues a
slice-scheduler must win on — makespan, queueing delay, SLO attainment,
chip-hour utilization, fragmentation, energy.

``ClusterScheduler`` integrates the time-weighted quantities (busy
chip-seconds, fragmentation ratio, pod power draw via ``core.power``) over
its event timeline; ``summarize`` folds them with the per-job records into
one comparable row per policy run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Sequence

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.cluster.scheduler import JobRecord


@dataclass(frozen=True)
class ClusterMetrics:
    policy: str
    n_jobs: int
    placed: int
    completed: int
    left_queued: int            # never placed within the horizon
    still_running: int
    makespan_s: float           # last completion − first arrival
    mean_queue_delay_s: float
    p95_queue_delay_s: float
    slo_attainment: float       # completed-by-deadline / jobs (placed or not)
    chip_hour_utilization: float  # busy chip-s / (total chips × elapsed)
    frag_time_avg: float        # time-averaged fragmentation ratio
    energy_J: float             # modeled (synthetic power calibration, hw.py)
    energy_per_chip_hour_kJ: float
    repacks: int
    repack_failures: int
    shrinks: int                # elastic profile shrinks of running jobs
    grows: int                  # elastic extend()s of running jobs
    preemptions: int            # checkpoint evictions of running jobs
    resumes: int                # resumed-from-checkpoint placements
    wasted_checkpoint_chip_s: float  # chips × seconds spent on ckpt traffic
    migrated_bytes: int         # in-pod moves over the host links (bytes)
    migration_s: float
    migrations: int             # cross-pod relocations (MigrateAcrossPods)
    dcn_migrated_bytes: int     # resident state moved over the DCN (bytes)
    dcn_migration_s: float      # save+restore seconds paid over the DCN
    power_deferrals: int        # jobs deferred ≥ once by the power gate
    # -- partition-mode column (ReconfigurePartition commits) --
    reconfigs: int = 0          # committed pod partition-mode switches
    # -- probe-cache columns (cluster/actions.py ProbeCache) --
    rescue_probes_priced: int = 0   # structural cores actually evaluated
    probe_cache_hits: int = 0       # cores served from the ProbeCache
    # -- autoscale columns (all-zero unless an AutoscaleController ran) --
    serving_p50_s: float = 0.0          # modeled serving queue-wait p50
    serving_p99_s: float = 0.0          # modeled serving queue-wait p99
    serving_slo_hit_rate: float = 0.0   # tenant-intervals with p99 ≤ SLO
    serving_chip_hours: float = 0.0     # exact chips×time serving integral
    chip_hours_per_slo_hit: float = 0.0  # the headline efficiency number
    autoscale_resizes: int = 0          # committed grow/shrink/migrate

    def as_dict(self) -> Dict[str, object]:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


def summarize(policy: str, records: Sequence["JobRecord"], *,
              elapsed_s: float, total_chips: int, busy_chip_s: float,
              frag_time_avg: float, energy_J: float,
              repacks: int = 0, repack_failures: int = 0, shrinks: int = 0,
              grows: int = 0, preemptions: int = 0, resumes: int = 0,
              wasted_checkpoint_chip_s: float = 0.0,
              migrated_bytes: int = 0, migration_s: float = 0.0,
              migrations: int = 0, dcn_migrated_bytes: int = 0,
              dcn_migration_s: float = 0.0,
              power_deferrals: int = 0,
              reconfigs: int = 0,
              rescue_probes_priced: int = 0, probe_cache_hits: int = 0,
              serving_p50_s: float = 0.0, serving_p99_s: float = 0.0,
              serving_slo_hit_rate: float = 0.0,
              serving_chip_hours: float = 0.0,
              chip_hours_per_slo_hit: float = 0.0,
              autoscale_resizes: int = 0) -> ClusterMetrics:
    placed = [r for r in records if r.place_s is not None]
    completed = [r for r in placed if r.finished]
    delays = np.asarray([r.place_s - r.job.arrival_s for r in placed],
                        dtype=float)
    slo_ok = sum(1 for r in completed
                 if r.deadline_s is None or r.finish_s <= r.deadline_s)
    arrivals = [r.job.arrival_s for r in records]
    finishes = [r.finish_s for r in completed]
    makespan = (max(finishes) - min(arrivals)) if finishes else 0.0
    busy_frac = (busy_chip_s / (total_chips * elapsed_s)
                 if elapsed_s > 0 else 0.0)
    chip_hours = busy_chip_s / 3600.0
    return ClusterMetrics(
        policy=policy,
        n_jobs=len(records),
        placed=len(placed),
        completed=len(completed),
        left_queued=len(records) - len(placed),
        still_running=len(placed) - len(completed),
        makespan_s=makespan,
        mean_queue_delay_s=float(delays.mean()) if delays.size else 0.0,
        p95_queue_delay_s=(float(np.percentile(delays, 95))
                           if delays.size else 0.0),
        slo_attainment=slo_ok / len(records) if records else 0.0,
        chip_hour_utilization=busy_frac,
        frag_time_avg=frag_time_avg,
        energy_J=energy_J,
        energy_per_chip_hour_kJ=(energy_J / 1e3 / chip_hours
                                 if chip_hours else 0.0),
        repacks=repacks,
        repack_failures=repack_failures,
        shrinks=shrinks,
        grows=grows,
        preemptions=preemptions,
        resumes=resumes,
        wasted_checkpoint_chip_s=wasted_checkpoint_chip_s,
        migrated_bytes=migrated_bytes,
        migration_s=migration_s,
        migrations=migrations,
        dcn_migrated_bytes=dcn_migrated_bytes,
        dcn_migration_s=dcn_migration_s,
        power_deferrals=power_deferrals,
        reconfigs=reconfigs,
        rescue_probes_priced=rescue_probes_priced,
        probe_cache_hits=probe_cache_hits,
        serving_p50_s=serving_p50_s,
        serving_p99_s=serving_p99_s,
        serving_slo_hit_rate=serving_slo_hit_rate,
        serving_chip_hours=serving_chip_hours,
        chip_hours_per_slo_hit=chip_hours_per_slo_hit,
        autoscale_resizes=autoscale_resizes,
    )


# every count below renders with thousands separators: at 100k-job scale
# the bare-int forms ran six-plus digits together and the policy columns
# became unreadable (and misaligned against the already-separated floats)
_ROWS = (
    ("jobs placed/completed/queued", lambda m: (
        f"{m.placed:,}/{m.completed:,}/{m.left_queued:,}"
        + (f" (+{m.still_running:,} running at horizon)"
           if m.still_running else ""))),
    ("makespan", lambda m: f"{m.makespan_s:,.1f} s"),
    ("queue delay mean/p95", lambda m: (
        f"{m.mean_queue_delay_s:,.1f} / {m.p95_queue_delay_s:,.1f} s")),
    ("SLO attainment", lambda m: f"{m.slo_attainment:.1%}"),
    ("chip-hour utilization", lambda m: f"{m.chip_hour_utilization:.1%}"),
    ("fragmentation (time-avg)", lambda m: f"{m.frag_time_avg:.3f}"),
    ("energy (modeled)", lambda m: (
        f"{m.energy_J / 1e6:,.1f} MJ "
        f"({m.energy_per_chip_hour_kJ:,.0f} kJ/chip-hour)")),
    ("repacks (ok/failed)", lambda m: f"{m.repacks:,}/{m.repack_failures:,}"),
    ("elastic shrinks/grows", lambda m: f"{m.shrinks:,}/{m.grows:,}"),
    ("preemptions/resumes", lambda m: f"{m.preemptions:,}/{m.resumes:,}"),
    ("wasted checkpoint chip-s", lambda m: (
        f"{m.wasted_checkpoint_chip_s:,.1f}")),
    ("migration (in-pod)", lambda m: (
        f"{m.migrated_bytes / 2**30:,.1f} GiB, {m.migration_s:,.2f} s")),
    ("migration (cross-pod DCN)", lambda m: (
        f"{m.migrations:,} moves, {m.dcn_migrated_bytes / 2**30:,.1f} GiB, "
        f"{m.dcn_migration_s:,.2f} s")),
    ("power-deferred jobs", lambda m: f"{m.power_deferrals:,}"),
    ("partition reconfigures", lambda m: f"{m.reconfigs:,}"),
    ("rescue probes priced (cached)", lambda m: (
        f"{m.rescue_probes_priced:,} ({m.probe_cache_hits:,} hits)")),
    ("serving wait p50/p99", lambda m: (
        f"{m.serving_p50_s:,.1f} / {m.serving_p99_s:,.1f} s")),
    ("serving SLO hit rate", lambda m: f"{m.serving_slo_hit_rate:.1%}"),
    ("serving chip-hours (per SLO hit)", lambda m: (
        f"{m.serving_chip_hours:,.1f} ({m.chip_hours_per_slo_hit:,.3f})")),
    ("autoscale resizes", lambda m: f"{m.autoscale_resizes:,}"),
)


def format_metrics(metrics: Sequence[ClusterMetrics]) -> str:
    """Aligned comparison table, one column per policy run."""
    metrics = list(metrics)
    header = ["metric"] + [m.policy for m in metrics]
    rows: List[List[str]] = [header]
    for label, fmt in _ROWS:
        rows.append([label] + [fmt(m) for m in metrics])
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    lines = []
    for i, row in enumerate(rows):
        lines.append("  ".join(cell.ljust(w) for cell, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)
