"""Cluster scheduling demo — the fragmentation story, end to end.

Replays the crafted stranding trace from ``repro.cluster.trace`` under all
three placement policies on one 16×16 pod: ten small/medium jobs interleave
arrivals and completions until 128 chips are free but scattered; then an
8×16 job arrives that fits the pod's free chips and *no* aligned rectangle
(the arXiv 2512.16099 stranding case cited by ``StaticPartitioner.repack``).
First-fit leaves it queued past the horizon; the repack-enabled policy
compacts the five live slices — paying a modeled migration cost over the
pod's host links — and places it seconds later.

Next, the elastic-shrink story: a deadline job that would miss its SLO
behind two long slice holders is rescued by shrinking the low-priority
batch holder to a smaller profile (priced as a repack-style migration) —
the progress-based ``PodSimulator`` re-bases the victim's remaining work
onto the smaller slice.

Third, the preemption story: a deadline job arrives on a full pod where a
shrink cannot mint its rectangle — with priorities enabled the scheduler
checkpoint-evicts the low-priority batch holder (suspend priced as the
``train/checkpoint.py`` save volume over the pod's host links), the
deadline job hits its SLO, and the victim later resumes from its
checkpoint with ``work_done`` preserved.

Fourth, the grow story: when a short neighbour finishes, a running
training job absorbs the freed chips via the partitioner's transactional
``extend()`` and its projected finish improves.

Fifth, the cross-pod migration story (the Action API's
``MigrateAcrossPods``): on a load-imbalanced two-pod cluster every
in-pod rescue fails — the only free rectangle sits next to a full-power
holder and trips the shared power cap — so the scheduler relocates a
*cold* holder to the hot pod over the DCN (priced as checkpoint
save/restore over ``PodSpec.dcn_bw``) and places the hot deadline job in
the drained rectangle: global hot/cold balancing no single-pod move can
express.

Sixth, the look-ahead story: no *single* action mints the deadline job's
8×16 origin (each eviction frees one 8×8), so the greedy selector queues
it to a miss; ``LookAheadPolicy`` trial-applies the first eviction
(transactional ``apply``/``rollback``), sees the second now closes the
chain, and commits the pair.

Then a seeded mixed trace (serving + training + low-utilization batch jobs,
Poisson arrivals) is scheduled with serving jobs executing on **live**
``SliceRuntime`` tenants.

    PYTHONPATH=src python -m repro_torch.examples.cluster_sim [--device cpu]

The reference's example on the port's cluster scheduler. The six showcases
are pure Python (``showcases``); the mixed trace's serving jobs run as live
reduced tenants on the CUDA device, or on the CPU with ``--device cpu``
(``live_trace``).
"""
import argparse

from repro_torch.cluster import (ClusterScheduler, PolicySpec, TraceConfig,
                           elastic_showcase, format_metrics,
                           fragmentation_showcase, generate_trace,
                           grow_showcase, lookahead_showcase,
                           migration_showcase, preemption_showcase)
from repro_torch.cluster.placement import POLICY_NAMES

STRANDED = 10  # job_id of the 8×16 arrival in the showcase trace
DEADLINE = 2   # job_id of the SLO-critical arrival in the elastic trace
PREEMPT_DEADLINE = 2  # SLO-critical arrival in the preemption trace
VICTIM = 0     # low-priority batch holder / growing training job
MIGRATE_DEADLINE = 3  # SLO-critical arrival in the migration trace
LOOKAHEAD_DEADLINE = 3  # SLO-critical arrival in the look-ahead trace


def showcases() -> None:
    """The six scheduler stories on the modelled pods (no tensors)."""
    print("=== crafted stranding trace (one pod, horizon 3000 s) ===")
    jobs = fragmentation_showcase()
    results = []
    for policy in POLICY_NAMES:
        sched = ClusterScheduler(n_pods=1, policy=policy, horizon_s=3000.0)
        records, metrics = sched.run(jobs)
        results.append(metrics)
        big = next(r for r in records if r.job.job_id == STRANDED)
        print(f"  {policy:12s} 8x16 job: "
              + (f"placed at t={big.place_s:.0f}s on {big.profile_name} "
                 f"origin={big.origin}" if big.placed
                 else "QUEUED at horizon (stranded)"))
    print()
    print(format_metrics(results))

    print("\n=== elastic shrink: SLO miss -> hit (one pod) ===")
    for elastic in (False, True):
        sched = ClusterScheduler(
            n_pods=1, policy="frag_repack", horizon_s=3000.0,
            spec=PolicySpec(actions=("shrink",) if elastic else ()))
        records, metrics = sched.run(elastic_showcase())
        d = next(r for r in records if r.job.job_id == DEADLINE)
        verdict = ("SLO HIT" if d.finished and d.finish_s <= d.deadline_s
                   else "SLO MISS")
        print(f"  elastic={str(elastic):5s} deadline job: "
              + (f"placed t={d.place_s:.0f}s finish={d.finish_s:.0f}s "
                 f"deadline={d.deadline_s:.0f}s -> {verdict}"
                 if d.placed else f"never placed -> {verdict}")
              + f"  (shrinks={metrics.shrinks})")

    print("\n=== checkpoint preemption: SLO miss -> hit (one pod) ===")
    for priorities in (False, True):
        sched = ClusterScheduler(
            n_pods=1, policy="frag_repack",
            spec=PolicySpec(actions=("shrink", "preempt") if priorities
                            else ("shrink",)))
        records, metrics = sched.run(preemption_showcase())
        d = next(r for r in records if r.job.job_id == PREEMPT_DEADLINE)
        v = next(r for r in records if r.job.job_id == VICTIM)
        verdict = ("SLO HIT" if d.finished and d.finish_s <= d.deadline_s
                   else "SLO MISS")
        print(f"  priorities={str(priorities):5s} deadline job: "
              f"placed t={d.place_s:.0f}s finish={d.finish_s:.0f}s "
              f"deadline={d.deadline_s:.0f}s -> {verdict}")
        if priorities:
            print(f"    victim: evicted t={v.suspend_s:.0f}s, resumed "
                  f"t={v.resume_s:.0f}s, finished t={v.finish_s:.0f}s "
                  f"(checkpoint delay {v.checkpoint_delay_s:.2f}s, "
                  f"{v.checkpoint_bytes / 2**30:.0f} GiB saved+restored)")

    print("\n=== elastic grow: absorb freed neighbour chips (one pod) ===")
    for grow in (False, True):
        sched = ClusterScheduler(
            n_pods=1, policy="frag_repack",
            spec=PolicySpec(actions=("grow",) if grow else ()))
        records, metrics = sched.run(grow_showcase())
        g = next(r for r in records if r.job.job_id == VICTIM)
        print(f"  grow={str(grow):5s} training job: profile="
              f"{g.profile_name}{'+' if g.grown else ''} "
              f"finish={g.finish_s:.0f}s (grows={metrics.grows})")

    print("\n=== cross-pod migration: SLO miss -> hit (two pods, DCN) ===")
    for migrate in (False, True):
        sched = ClusterScheduler(
            n_pods=2, policy="frag_repack",
            spec=PolicySpec(actions=("shrink", "preempt", "migrate")
                            if migrate else ("shrink", "preempt")))
        records, metrics = sched.run(migration_showcase())
        d = next(r for r in records if r.job.job_id == MIGRATE_DEADLINE)
        v = next(r for r in records if r.job.job_id == VICTIM)
        verdict = ("SLO HIT" if d.finished and d.finish_s <= d.deadline_s
                   else "SLO MISS")
        print(f"  migrate={str(migrate):5s} deadline job: "
              f"placed t={d.place_s:.0f}s finish={d.finish_s:.0f}s "
              f"deadline={d.deadline_s:.0f}s -> {verdict}")
        if migrate:
            print(f"    victim: relocated pod0->pod{v.pod_idx} at "
                  f"t={v.migrate_s:.0f}s, kept running, finished "
                  f"t={v.finish_s:.0f}s ({v.dcn_bytes / 2**30:.0f} GiB "
                  f"over the DCN, {v.dcn_delay_s:.2f}s save+restore)")

    print("\n=== look-ahead: chained evictions rescue the SLO (one pod) ===")
    for selector in ("greedy", "lookahead"):
        sched = ClusterScheduler(
            n_pods=1, policy="frag_repack",
            spec=PolicySpec(selector=selector,
                            actions=("shrink", "preempt")))
        records, metrics = sched.run(lookahead_showcase())
        d = next(r for r in records if r.job.job_id == LOOKAHEAD_DEADLINE)
        verdict = ("SLO HIT" if d.finished and d.finish_s <= d.deadline_s
                   else "SLO MISS")
        print(f"  policy={selector:9s} deadline job: "
              + (f"placed t={d.place_s:.0f}s finish={d.finish_s:.0f}s "
                 f"deadline={d.deadline_s:.0f}s -> {verdict}"
                 if d.placed else f"never placed -> {verdict}")
              + f"  (preemptions={metrics.preemptions})")



def live_trace(device: str = "cuda") -> None:
    """A seeded mixed trace whose serving jobs run as live tenants."""
    print("\n=== seeded mixed trace, live serving tenants (two pods) ===")
    trace = generate_trace(TraceConfig(seed=0, n_jobs=12,
                                       mean_interarrival_s=45.0))
    sched = ClusterScheduler(n_pods=2, policy="frag_repack",
                             execute_serving=True, device=device)
    records, metrics = sched.run(trace)
    for r in sorted(records, key=lambda r: r.job.job_id):
        live = f" tokens={r.tokens_out}" if r.executed else ""
        print(f"  job{r.job.job_id:<3d} {r.job.kind:8s} {r.job.arch:15s} "
              f"-> pod{r.pod_idx} {r.profile_name}{live}")
    print()
    print(format_metrics([metrics]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the live tenants run: cuda (default) or cpu")
    args = ap.parse_args(argv)
    showcases()
    live_trace(args.device)


if __name__ == "__main__":
    main()
