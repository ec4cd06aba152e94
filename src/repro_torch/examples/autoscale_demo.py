"""Autoscale demo — a compressed serving day, fixed vs autoscaled.

Two tenants ride one seeded diurnal tide (phase-staggered, so their
peaks don't coincide) through an eight-hour virtual day. The same load
curves are run twice:

* **fixed** — both tenants provisioned at peak size (``8s.128c``) all
  day; the ``AutoscaleController`` rides along in ``observe`` mode so
  the latency accounting is identical, but it never acts;
* **autoscale** — tenants start at ``1s.16c`` and the hysteresis
  controller resizes them through the priced Action API: ``Grow`` as
  the tide comes in (falling back to ``MigrateTenant`` when the local
  pod has no rectangle to extend into), ``ShrinkTenant`` as it goes
  out — each action transactional, priced, and cooldown-gated.

The punchline printed at the end is the paper's economic claim in
miniature: the autoscaled day burns a fraction of the fixed day's
chip-hours at an equal-or-better p99 SLO hit rate.

    PYTHONPATH=src python -m repro_torch.examples.autoscale_demo

The reference's example on the port's cluster scheduler (pure Python: the
modelled pods, no tensors).
"""
from repro_torch.cluster import (AutoscaleController, AutoscaleSpec,
                           ClusterScheduler, format_metrics,
                           serving_workload)

DAY_S = 28800.0        # 8h virtual day (compressed for a quick demo)
INTERVAL_S = 300.0     # control period
COOLDOWN_S = 900.0     # min seconds between actions per tenant
TENANTS = 2
PODS = 2
SEED = 0


def run_day(mode: str):
    """One modeled serving day; ``mode`` is "fixed" or "autoscale"."""
    jobs, curves = serving_workload(
        n_tenants=TENANTS, curve="diurnal", horizon_s=DAY_S, seed=SEED,
        start_profile="1s.16c" if mode == "autoscale" else "8s.128c")
    spec = AutoscaleSpec(interval_s=INTERVAL_S, cooldown_s=COOLDOWN_S,
                         mode="hysteresis" if mode == "autoscale"
                         else "observe")
    ctrl = AutoscaleController(curves, spec, seed=SEED)
    sched = ClusterScheduler(n_pods=PODS, horizon_s=DAY_S, autoscaler=ctrl)
    _, metrics = sched.run(jobs)
    return metrics, ctrl


def main() -> None:
    print(f"=== fixed provisioning (8s.128c all day, {DAY_S / 3600:.0f}h "
          f"day, {TENANTS} tenants) ===")
    fixed_m, _ = run_day("fixed")
    print(format_metrics([fixed_m]))
    print()

    print("=== autoscaled (start 1s.16c, hysteresis controller) ===")
    auto_m, ctrl = run_day("autoscale")
    print(format_metrics([auto_m]))
    print()
    print("action log (t, tenant, kind):")
    for t, jid, kind in ctrl.action_log:
        print(f"  {t:>8,.0f}s  tenant {jid}  {kind}")
    print()

    saved = 100.0 * (1.0 - auto_m.serving_chip_hours
                     / fixed_m.serving_chip_hours)
    print(f"verdict: {auto_m.serving_chip_hours:,.1f} chip-hours vs "
          f"{fixed_m.serving_chip_hours:,.1f} fixed "
          f"({saved:.1f}% saved) at SLO hit rate "
          f"{auto_m.serving_slo_hit_rate:.1%} vs "
          f"{fixed_m.serving_slo_hit_rate:.1%}")
    assert auto_m.serving_chip_hours < fixed_m.serving_chip_hours
    assert auto_m.serving_slo_hit_rate >= fixed_m.serving_slo_hit_rate


if __name__ == "__main__":
    main()
