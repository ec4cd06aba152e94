"""Cluster entry point: run a job trace through the ClusterScheduler.

    PYTHONPATH=src python -m repro_torch.launch.cluster --pods 2 --trace-seed 0

Generates a deterministic mixed trace (serving tenants, training runs,
low-utilization batch jobs — Poisson arrivals), schedules it onto N
statically partitioned pods under the chosen placement policy, and prints
the per-job placements plus the aggregate metrics table (utilization, SLO
attainment, fragmentation, modeled energy).

The elastic surface is the Action API: ``--actions`` is the
``PolicySpec`` allowlist (comma list from ``shrink``, ``preempt``,
``grow``, ``migrate``) and ``--policy {greedy,lookahead,search}`` picks
the ``SchedulerPolicy`` that selects among the allowed actions. The old
``--elastic/--priorities/--grow`` flags are still accepted as deprecated
aliases for ``--actions shrink/preempt/grow``. (``--placement`` chooses
the candidate-enumeration policy, previously called ``--policy``.)

Serving jobs execute through **real** ``SliceRuntime`` tenants on the exact
slice rectangle the scheduler chose, on the CUDA device unless ``--device
cpu`` is given: reduced-scale configs by default, the published widths and
depth in bf16 weights with ``--full-size``, and causal prefill through the
hand-written flash-attention kernel with ``--attn-impl pallas`` (as
``launch/serve.py``); pass ``--no-execute`` for a pure-model run. The
scheduler's decisions do not depend on the config a tenant runs, so the
timeline is the same at either size and on either device:

    PYTHONPATH=src python -m repro_torch.launch.cluster --showcase --device cpu
 The crafted
stories: ``--showcase`` (fragmentation stranding + repack),
``--elastic-showcase`` (a shrink rescues an SLO), ``--preemption-
showcase`` (checkpoint-eviction rescues an SLO a shrink cannot),
``--grow-showcase`` (a running job absorbs freed neighbour chips), and
``--migration-showcase`` (a load-imbalanced two-pod trace where only a
DCN-priced ``MigrateAcrossPods`` meets the deadline),
``--lookahead-showcase`` (no single action rescues the job; the
look-ahead's two-eviction chain does), ``--search-showcase``
(a three-eviction chain beyond the two-step look-ahead's depth; only
the budgeted best-first ``SearchPolicy`` finds it), and
``--reconfigure-showcase`` (a bandwidth-starved deadline job on mi300
pods that no eviction rescues — draining a pod and switching its
partition mode to NPS4 does).

Hardware is selectable: ``--chip {v5e,mi300}`` picks the chip family,
``--mode NAME`` boots every pod in a specific partition mode (default:
the chip's own default), and ``--modes`` prints the chip's partition-mode
table (per-mode FLOP/bandwidth/capacity deltas and slice-ladder floor)
and exits.
"""
from __future__ import annotations

import argparse
import functools
import warnings

from repro_torch.configs import tenant_config
from repro_torch.core.hw import CHIPS, PodSpec, get_chip, partition_modes
from repro_torch.cluster import (AutoscaleController, AutoscaleSpec,
                                 ClusterScheduler, PolicySpec, TraceConfig,
                                 elastic_showcase, format_metrics,
                                 fragmentation_showcase, generate_trace,
                                 grow_showcase, load_csv, lookahead_showcase,
                                 migration_showcase, parse_actions,
                                 preemption_showcase, reconfigure_showcase,
                                 search_showcase, serving_workload,
                                 twin_showcase, ACTION_KINDS, CURVE_NAMES,
                                 SCHEDULER_POLICY_NAMES)
from repro_torch.cluster.placement import POLICY_NAMES


def _mode_table(chip_name: str) -> str:
    """The partition-mode table ``--modes`` prints: one row per mode with
    its compute/memory split, resource deltas and slice-ladder floor."""
    chip = get_chip(chip_name)
    header = ("mode", "compute", "memory", "flops", "hbm bw", "capacity",
              "min slice", "switch")
    rows = [header]
    for name, m in sorted(partition_modes(chip).items()):
        rows.append((name, m.compute, m.memory,
                     f"x{m.flops_scale:.2f}", f"x{m.hbm_bw_scale:.2f}",
                     f"x{m.hbm_capacity_scale:.2f}",
                     f"{m.min_slice_chips} chips",
                     f"{m.switch_downtime_s:.0f} s"))
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    lines = [f"# partition modes for chip {chip.name!r}"]
    for i, row in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def _job_rows(records) -> str:
    header = ("job", "kind", "arch", "prio", "arrive", "profile", "pod",
              "origin", "queue_s", "finish", "slo", "ckpt", "mig", "tokens")
    rows = [header]
    for r in sorted(records, key=lambda r: r.job.job_id):
        j = r.job
        ckpt = (f"evict x{r.preemptions}" if r.preemptions and not r.resumes
                else f"resume x{r.resumes}" if r.resumes else "-")
        mig = f"dcn x{r.migrations}" if r.migrations else "-"
        if r.placed:
            slo = ("-" if r.deadline_s is None else
                   "miss" if not r.finished or r.finish_s > r.deadline_s
                   else "ok")
            rows.append((
                str(j.job_id), j.kind, j.arch, str(j.priority),
                f"{j.arrival_s:.0f}",
                (r.rung or r.profile_name) + ("*" if r.shrunk else "")
                + ("+" if r.grown else ""),
                str(r.pod_idx), str(r.origin),
                f"{r.place_s - j.arrival_s:.0f}",
                f"{r.finish_s:.0f}" if r.finished else
                ("suspended" if r.suspended is not None else "running"),
                slo, ckpt, mig, str(r.tokens_out) if r.executed else "-"))
        else:
            rows.append((str(j.job_id), j.kind, j.arch, str(j.priority),
                         f"{j.arrival_s:.0f}",
                         "-", "-", "-", "-", "QUEUED", "miss", ckpt, mig,
                         "-"))
    widths = [max(len(row[i]) for row in rows) for i in range(len(header))]
    return "\n".join("  ".join(c.ljust(w) for c, w in zip(row, widths))
                     for row in rows)


def add_policy_args(ap: argparse.ArgumentParser) -> None:
    """The Action-API flags, shared with ``benchmarks/bench_cluster.py``:
    ``--policy``/``--actions`` plus the deprecated boolean aliases."""
    ap.add_argument("--policy", default="greedy",
                    choices=SCHEDULER_POLICY_NAMES,
                    help="action-selection policy: greedy commits the "
                         "cheapest single rescue, lookahead may chain "
                         "two, search runs budgeted best-first over "
                         "deeper enabler chains (cheapest SLO-preserving "
                         "chain wins)")
    ap.add_argument("--actions", default=None,
                    help="comma-separated PolicySpec allowlist from "
                         f"{','.join(ACTION_KINDS)} (default: none)")
    ap.add_argument("--elastic", action="store_true",
                    help="DEPRECATED alias for --actions shrink")
    ap.add_argument("--priorities", action="store_true",
                    help="DEPRECATED alias for --actions preempt")
    ap.add_argument("--grow", action="store_true",
                    help="DEPRECATED alias for --actions grow")


def spec_from_args(args) -> PolicySpec:
    """Fold ``--policy``/``--actions`` (and the deprecated boolean
    aliases, with a DeprecationWarning) into one ``PolicySpec``."""
    actions = set(parse_actions(args.actions) if args.actions else ())
    if args.elastic:
        actions.add("shrink")
    if args.priorities:
        actions.add("preempt")
    if args.grow:
        actions.add("grow")
    if args.elastic or args.priorities or args.grow:
        warnings.warn(
            "--elastic/--priorities/--grow are deprecated; use "
            "--actions shrink,preempt,grow", DeprecationWarning,
            stacklevel=2)
    return PolicySpec(selector=args.policy, actions=tuple(actions))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--jobs", type=int, default=24)
    ap.add_argument("--placement", default="frag_repack",
                    choices=POLICY_NAMES,
                    help="placement (candidate-enumeration) policy")
    ap.add_argument("--chip", default="v5e", choices=sorted(CHIPS),
                    help="chip family the pods are built from "
                         "(core.hw.CHIPS)")
    ap.add_argument("--mode", default=None, metavar="NAME",
                    help="boot every pod in this partition mode (default: "
                         "the chip's default mode; see --modes)")
    ap.add_argument("--modes", action="store_true",
                    help="print the chip's partition-mode table and exit")
    ap.add_argument("--mean-interarrival", type=float, default=45.0)
    ap.add_argument("--horizon", type=float, default=None,
                    help="virtual-time cutoff (s); default: run to drain")
    ap.add_argument("--min-throttle", type=float, default=0.8)
    ap.add_argument("--requests", type=int, default=2,
                    help="live requests per serving job")
    ap.add_argument("--no-execute", action="store_true",
                    help="model serving jobs instead of running SliceRuntime")
    ap.add_argument("--device", default="cuda",
                    help="device the live serving tenants run on (cuda, or "
                         "cpu when asked)")
    ap.add_argument("--full-size", action="store_true",
                    help="live tenants at the published widths and depth in "
                         "bf16 weights (default: reduced configs)")
    ap.add_argument("--attn-impl", default=None, choices=("xla", "pallas"),
                    help="live tenants' causal prefill: pallas is the "
                         "hand-written flash-attention kernel")
    ap.add_argument("--trace-csv", default=None, metavar="PATH",
                    help="replay a public-trace CSV (Philly/Alibaba-style "
                         "schema: submit time, duration, GPU request, job "
                         "class) instead of generating a synthetic trace")
    ap.add_argument("--showcase", action="store_true",
                    help="replay the crafted fragmentation-stranding trace "
                         "(forces --pods 1, default horizon 3000 s)")
    ap.add_argument("--elastic-showcase", action="store_true",
                    help="replay the crafted SLO-rescue trace (forces "
                         "--pods 1 --actions shrink, default horizon 3000 s)")
    ap.add_argument("--preemption-showcase", action="store_true",
                    help="replay the crafted checkpoint-eviction trace "
                         "(forces --pods 1 --actions preempt)")
    ap.add_argument("--grow-showcase", action="store_true",
                    help="replay the crafted elastic-grow trace (forces "
                         "--pods 1 --actions grow)")
    ap.add_argument("--migration-showcase", action="store_true",
                    help="replay the crafted cross-pod migration trace "
                         "(forces --pods 2 --actions migrate): only a "
                         "DCN-priced MigrateAcrossPods meets the deadline")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the SLO-driven hysteresis autoscaler over a "
                         "day of seeded serving load (tenants start small "
                         "and are resized through the priced Action API); "
                         "implies --load-curve diurnal unless given")
    ap.add_argument("--load-curve", default=None, choices=CURVE_NAMES,
                    help="serving load shape for the day-in-the-life run; "
                         "without --autoscale the tenants are provisioned "
                         "fixed at peak size (the comparison baseline) and "
                         "the controller only observes")
    ap.add_argument("--tenants", type=int, default=2,
                    help="serving tenants in the autoscale/load-curve run")
    ap.add_argument("--day", type=float, default=86400.0,
                    help="virtual day length (s) for the autoscale run; "
                         "--horizon overrides")
    ap.add_argument("--lookahead-showcase", action="store_true",
                    help="replay the crafted two-eviction trace (forces "
                         "--pods 1 --policy lookahead --actions "
                         "shrink,preempt)")
    ap.add_argument("--search-showcase", action="store_true",
                    help="replay the crafted three-eviction trace (forces "
                         "--pods 1 --policy search --actions "
                         "shrink,preempt): the rescue chain is one action "
                         "deeper than the two-step look-ahead explores")
    ap.add_argument("--reconfigure-showcase", action="store_true",
                    help="replay the crafted partition-mode trace (forces "
                         "--pods 2 --chip mi300 --actions "
                         "migrate,reconfigure): no eviction rescues the "
                         "bandwidth-starved deadline job; draining a pod "
                         "and switching it to NPS4 does")
    ap.add_argument("--twin", action="store_true",
                    help="enable twin-offload co-execution pricing: the "
                         "PerfModel also emits '+cpuX.XX' rungs that run "
                         "the consumer of spilled state host-side "
                         "(default off; scores are bit-identical without)")
    ap.add_argument("--twin-showcase", action="store_true",
                    help="replay the crafted twin-offload trace (forces "
                         "--pods 1 --actions shrink,preempt): the deadline "
                         "job is only rescuable by shrinking onto a twin "
                         "rung — run with and without --twin to flip the "
                         "SLO verdict")
    add_policy_args(ap)
    ap.add_argument("--frozen-durations", action="store_true",
                    help="legacy mode: freeze durations at admission-time "
                         "throttle instead of re-solving on mix changes")
    args = ap.parse_args()

    if args.modes:
        print(_mode_table(args.chip))
        return

    spec = spec_from_args(args)
    autoscaler = None
    if args.autoscale or args.load_curve:
        # day-in-the-life serving run: the load curves are calibrated the
        # same whichever starting profile is used, so --autoscale (start
        # small, controller resizes) and the bare --load-curve baseline
        # (fixed peak-size slices, controller only observes) face
        # identical traffic. Analytic path: serving is modeled, not
        # executed (a modeled day is millions of requests).
        curve = args.load_curve or "diurnal"
        if args.horizon is None:
            args.horizon = args.day
        jobs, curves = serving_workload(
            n_tenants=args.tenants, curve=curve, horizon_s=args.horizon,
            seed=args.trace_seed,
            start_profile="1s.16c" if args.autoscale else "8s.128c")
        autoscaler = AutoscaleController(
            curves,
            AutoscaleSpec(mode="hysteresis" if args.autoscale
                          else "observe"),
            seed=args.trace_seed)
        args.no_execute = True
    elif args.showcase:
        jobs = fragmentation_showcase()
        args.pods = 1    # the stranding story is a single-pod timeline
        if args.horizon is None:
            args.horizon = 3000.0
    elif args.elastic_showcase:
        jobs = elastic_showcase()
        args.pods = 1
        spec = PolicySpec(selector=spec.selector,
                          actions=tuple(set(spec.actions) | {"shrink"}))
        if args.horizon is None:
            args.horizon = 3000.0
    elif args.preemption_showcase:
        jobs = preemption_showcase()
        args.pods = 1
        spec = PolicySpec(selector=spec.selector,
                          actions=tuple(set(spec.actions) | {"preempt"}))
    elif args.grow_showcase:
        jobs = grow_showcase()
        args.pods = 1
        spec = PolicySpec(selector=spec.selector,
                          actions=tuple(set(spec.actions) | {"grow"}))
    elif args.migration_showcase:
        jobs = migration_showcase()
        args.pods = 2
        spec = PolicySpec(selector=spec.selector,
                          actions=tuple(set(spec.actions) | {"migrate"}))
    elif args.lookahead_showcase:
        jobs = lookahead_showcase()
        args.pods = 1
        spec = PolicySpec(selector="lookahead",
                          actions=tuple(set(spec.actions)
                                        | {"shrink", "preempt"}))
    elif args.search_showcase:
        jobs = search_showcase()
        args.pods = 1
        spec = PolicySpec(selector="search",
                          actions=tuple(set(spec.actions)
                                        | {"shrink", "preempt"}))
    elif args.twin_showcase:
        jobs = twin_showcase()
        args.pods = 1
        spec = PolicySpec(selector=spec.selector,
                          actions=tuple(set(spec.actions)
                                        | {"shrink", "preempt"}))
    elif args.reconfigure_showcase:
        jobs = reconfigure_showcase()
        args.pods = 2
        args.chip = "mi300"
        args.no_execute = True
        spec = PolicySpec(selector=spec.selector,
                          actions=tuple(set(spec.actions)
                                        | {"migrate", "reconfigure"}))
    elif args.trace_csv:
        jobs = load_csv(args.trace_csv,
                        requests_per_serving=args.requests,
                        chip=args.chip)
    else:
        jobs = generate_trace(TraceConfig(
            seed=args.trace_seed, n_jobs=args.jobs,
            mean_interarrival_s=args.mean_interarrival,
            requests_per_serving=args.requests))
    sched = ClusterScheduler(
        n_pods=args.pods, policy=args.placement,
        pod=PodSpec(chip=get_chip(args.chip)),
        min_throttle=args.min_throttle, horizon_s=args.horizon,
        frozen_durations=args.frozen_durations, spec=spec,
        execute_serving=not args.no_execute, autoscaler=autoscaler,
        twin=args.twin, mode=args.mode, device=args.device,
        serving_config=functools.partial(tenant_config,
                                         full_size=args.full_size,
                                         attn_impl=args.attn_impl))
    records, metrics = sched.run(jobs)

    n_exec = sum(1 for r in records if r.executed)
    print(f"# placement={args.placement} policy={spec.selector} "
          f"actions={','.join(spec.actions) or '-'} pods={args.pods} "
          f"chip={args.chip} mode={sched.base_mode} "
          f"seed={args.trace_seed} jobs={len(jobs)} "
          f"live_serving_tenants={n_exec}")
    if metrics.reconfigs:
        modes = ",".join(p.mode for p in sched.pods)
        print(f"# pod modes after run: {modes}")
    print(_job_rows(records))
    print()
    print(format_metrics([metrics]))
    if autoscaler is not None and autoscaler.action_log:
        print()
        print("# autoscale actions (t, tenant, kind):")
        for t, jid, kind in autoscaler.action_log:
            print(f"#   {t:>10,.0f}s  tenant {jid}  {kind}")


if __name__ == "__main__":
    main()
