"""repro_torch.cluster — trace-driven multi-pod scheduling on static slices.

The layer above ``serving.SliceRuntime``: a ``ClusterScheduler`` owns N
statically partitioned pods and drives a mixed job stream (serving tenants,
training runs, low-utilization batch/analytics) through admit → place →
run → complete. Every state mutation is a first-class **Action**
(``Place`` / ``Repack`` / ``Shrink`` / ``Grow`` / ``Preempt`` /
``MigrateAcrossPods``) with a uniform ``probe → ActionOutcome`` (feasible?
priced cost? projected SLO effect?) and transactional
``apply()``/``rollback()``; a ``SchedulerPolicy``
(``GreedyCheapestRescue``, the chaining ``LookAheadPolicy``, or the
budgeted ``SearchPolicy`` of ``cluster/planner.py``) selects among the
actions a declarative ``PolicySpec`` allows. Placement scoring
stays MISO-style and fragmentation-aware; in-pod moves are priced over the
pod's host links, cross-pod migration over its DCN (``PodSpec.dcn_bw``).
"""
from repro_torch.cluster.trace import (Job, TraceConfig, elastic_showcase,
                                       fragmentation_showcase, generate_trace,
                                       grow_showcase, load_csv,
                                       lookahead_showcase, migration_showcase,
                                       preemption_showcase, reconfigure_showcase,
                                       search_showcase, twin_showcase)
from repro_torch.cluster.placement import (Candidate, FirstFitPolicy,
                                           FragAwarePolicy, PlacementPolicy,
                                           get_policy)
from repro_torch.cluster.actions import (Action, ActionOutcome, Grow,
                                         GreedyCheapestRescue, LookAheadPolicy,
                                         MigrateAcrossPods, Place, PolicySpec,
                                         Preempt, ProbeCache,
                                         ReconfigurePartition, Repack,
                                         SchedulerPolicy, Shrink,
                                         get_scheduler_policy,
                                         parse_actions, select_cheapest,
                                         ACTION_KINDS, SCHEDULER_POLICY_NAMES)
from repro_torch.cluster.planner import RebalanceController, SearchPolicy
from repro_torch.cluster.scheduler import (ClusterScheduler, JobRecord, PodState,
                                           SuspendSnapshot)
from repro_torch.cluster.metrics import ClusterMetrics, format_metrics, summarize
from repro_torch.cluster.loadgen import (BurstyCurve, ConstantCurve, DiurnalCurve,
                                         LoadCurve, arrival_counts, arrival_times,
                                         get_curve, service_rate, serving_workload,
                                         CURVE_NAMES)
from repro_torch.cluster.autoscale import (AutoscaleController, AutoscaleSpec,
                                           MigrateTenant, ShrinkTenant,
                                           TenantSignals)

__all__ = [
    # traces
    "Job", "TraceConfig", "generate_trace", "load_csv",
    "fragmentation_showcase",
    "elastic_showcase", "preemption_showcase", "grow_showcase",
    "migration_showcase", "lookahead_showcase", "search_showcase",
    "twin_showcase", "reconfigure_showcase",
    # placement (candidate enumeration)
    "Candidate", "PlacementPolicy", "FirstFitPolicy", "FragAwarePolicy",
    "get_policy",
    # the Action API + selection policies
    "Action", "ActionOutcome", "Place", "Repack", "Shrink", "Grow",
    "Preempt", "MigrateAcrossPods", "ReconfigurePartition", "PolicySpec",
    "SchedulerPolicy",
    "GreedyCheapestRescue", "LookAheadPolicy", "SearchPolicy",
    "RebalanceController", "ProbeCache", "get_scheduler_policy",
    "parse_actions", "select_cheapest", "ACTION_KINDS",
    "SCHEDULER_POLICY_NAMES",
    # scheduler + metrics
    "ClusterScheduler", "JobRecord", "PodState", "SuspendSnapshot",
    "ClusterMetrics", "summarize", "format_metrics",
    # load generation + the autoscale control loop
    "LoadCurve", "ConstantCurve", "DiurnalCurve", "BurstyCurve",
    "CURVE_NAMES", "get_curve", "arrival_counts", "arrival_times",
    "service_rate", "serving_workload",
    "AutoscaleController", "AutoscaleSpec", "TenantSignals",
    "ShrinkTenant", "MigrateTenant",
]
