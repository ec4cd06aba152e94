"""The port's cluster scheduler against the reference's, on the same inputs.

Every case runs once in each package and must give the same timeline, bit
for bit: ``sha(records)`` of ``tests/test_timeline_pins.py`` and a wider
per-job tuple (profile, rung, origin, pod, deadline, elastic moves, tokens),
and equal ``ClusterMetrics`` fields and ``format_metrics`` text. The
crafted showcases are also held to their pinned hashes. The seeded trace0
runs are compared with the reference's live output, never with the pins:
those goldens are red on this jax (ROADMAP queue C, standing notes).

The live path runs on the CPU: serving jobs become real ``SliceRuntime``
tenants (reduced configs) in both packages, the port's at
``device="cpu"``."""
import dataclasses
import os

import pytest
import torch

import repro.cluster as ref_cl
import repro.core.hw as ref_hw
import repro_torch.cluster as port_cl
import repro_torch.core.hw as port_hw
from repro_torch.configs import tenant_config as port_tenant_config
from test_timeline_pins import SHOWCASE_PINS, sha

REF = (ref_cl, ref_hw)
PORT = (port_cl, port_hw)
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "philly_mini.csv")
DAY = 14400.0
TRACE0 = dict(seed=0, n_jobs=48, mean_interarrival_s=5.0)


def timeline(records):
    """Everything the scheduler decided about each job."""
    return [(r.job.job_id, r.place_s, r.finish_s, r.deadline_s,
             r.profile_name, r.rung, r.origin, r.pod_idx, r.shrunk, r.grown,
             r.preemptions, r.resumes, r.migrations, r.executed, r.tokens_out,
             r.finished)
            for r in records]


def _showcase(name):
    trace_fn, kwargs, _ = SHOWCASE_PINS[name]

    def run(cl, hw):
        kw = dict(kwargs,
                  spec=cl.PolicySpec(**dataclasses.asdict(kwargs["spec"])))
        if "pod" in kw:
            assert kw["pod"] is ref_hw.MI300_POD
            kw["pod"] = hw.MI300_POD
        sched = cl.ClusterScheduler(policy="frag_repack", **kw)
        return sched, sched.run(getattr(cl, trace_fn.__name__)())
    return run


def _trace0(**kw):
    def run(cl, hw):
        sched = cl.ClusterScheduler(n_pods=1, **kw)
        return sched, sched.run(cl.generate_trace(cl.TraceConfig(**TRACE0)))
    return run


def _frozen_golden(variant):
    def run(cl, hw):
        extra = {"defaults": {},
                 "flags_off": dict(priorities=False, grow=False),
                 "empty_spec": dict(spec=cl.PolicySpec())}[variant]
        sched = cl.ClusterScheduler(n_pods=1, policy="frag_repack",
                                    frozen_durations=True, **extra)
        return sched, sched.run(cl.generate_trace(cl.TraceConfig(**TRACE0)))
    return run


def _philly(chip):
    def run(cl, hw):
        sched = cl.ClusterScheduler(n_pods=1,
                                    pod=hw.PodSpec(chip=hw.get_chip(chip)))
        return sched, sched.run(cl.load_csv(FIXTURE, chip=chip))
    return run


def _autoscale(mode):
    def run(cl, hw):
        jobs, curves = cl.serving_workload(
            n_tenants=2, curve="diurnal", horizon_s=DAY, seed=0,
            start_profile="1s.16c" if mode == "hysteresis" else "8s.128c")
        ctrl = cl.AutoscaleController(
            curves, cl.AutoscaleSpec(interval_s=300.0, cooldown_s=900.0,
                                     mode=mode), seed=0)
        sched = cl.ClusterScheduler(n_pods=1, horizon_s=DAY, autoscaler=ctrl)
        return sched, sched.run(jobs)
    return run


def _twin(on):
    def run(cl, hw):
        sched = cl.ClusterScheduler(
            n_pods=1, policy="frag_repack", twin=on,
            spec=cl.PolicySpec(actions=("shrink", "preempt")))
        return sched, sched.run(cl.twin_showcase())
    return run


def _reconfigure(on):
    def run(cl, hw):
        sched = cl.ClusterScheduler(
            n_pods=2, pod=hw.MI300_POD, policy="frag_repack",
            spec=cl.PolicySpec(actions=("migrate", "reconfigure") if on
                               else ("migrate",)))
        return sched, sched.run(cl.reconfigure_showcase())
    return run


def _fleet(selector):
    """A seeded two-pod trace under every elastic action."""
    def run(cl, hw):
        sched = cl.ClusterScheduler(
            n_pods=2, spec=cl.PolicySpec(
                selector=selector,
                actions=("shrink", "preempt", "grow", "migrate")))
        return sched, sched.run(cl.generate_trace(cl.TraceConfig(
            seed=3, n_jobs=40, mean_interarrival_s=20.0)))
    return run


CASES = {
    **{f"showcase-{name}": _showcase(name) for name in SHOWCASE_PINS},
    "trace0-frozen": _trace0(frozen_durations=True),
    "trace0-progress": _trace0(frozen_durations=False),
    **{f"frozen-golden-{v}": _frozen_golden(v)
       for v in ("defaults", "flags_off", "empty_spec")},
    "philly-v5e": _philly("v5e"),
    "philly-mi300": _philly("mi300"),
    "autoscale-hysteresis": _autoscale("hysteresis"),
    "autoscale-observe": _autoscale("observe"),
    "twin-off": _twin(False),
    "twin-on": _twin(True),
    "mi300-reconfigure-off": _reconfigure(False),
    "mi300-reconfigure-on": _reconfigure(True),
    "fleet-greedy": _fleet("greedy"),
    "fleet-lookahead": _fleet("lookahead"),
    "fleet-search": _fleet("search"),
}


def _both(case):
    out = []
    for pkg in (REF, PORT):
        sched, (records, metrics) = CASES[case](*pkg)
        out.append((sched, records, metrics))
    return out


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("case", sorted(CASES))
def test_timeline_and_metrics_equal_reference(case):
    (rs, rrec, rm), (ps, prec, pm) = _both(case)
    assert sha(prec) == sha(rrec)
    assert timeline(prec) == timeline(rrec)
    assert dataclasses.asdict(pm) == dataclasses.asdict(rm)
    assert port_cl.format_metrics([pm]) == ref_cl.format_metrics([rm])
    assert [p.mode for p in ps.pods] == [p.mode for p in rs.pods]
    assert not ps._txns
    if ps.autoscaler is not None:
        assert ps.autoscaler.action_log == rs.autoscaler.action_log
    if case.startswith("showcase-"):
        assert sha(prec) == SHOWCASE_PINS[case[len("showcase-"):]][2]


def test_twin_and_reconfigure_flags_change_the_timelines():
    """The on/off pairs are different runs (so each pair above compares two
    timelines, not one twice)."""
    for on, off in (("twin-on", "twin-off"),
                    ("mi300-reconfigure-on", "mi300-reconfigure-off")):
        assert sha(CASES[on](*PORT)[1][0]) != sha(CASES[off](*PORT)[1][0])


def test_format_metrics_table_equals_reference():
    """A multi-row table, and the fleet-scale counters of
    ``test_cluster.py``'s format test, in both packages' ClusterMetrics."""
    fields = dict(
        policy="frag_repack", n_jobs=1_269_134, placed=1_234_567,
        completed=1_200_000, left_queued=34_567, still_running=34_567,
        makespan_s=1_196_063.29, mean_queue_delay_s=12.5,
        p95_queue_delay_s=99.9, slo_attainment=0.97,
        chip_hour_utilization=0.55, frag_time_avg=0.123,
        energy_J=4.2e12, energy_per_chip_hour_kJ=1234.5,
        repacks=1_000_001, repack_failures=7, shrinks=2_500_000,
        grows=1_000, preemptions=3_000_000, resumes=2_999_999,
        wasted_checkpoint_chip_s=1e7, migrated_bytes=5 * 2**40,
        migration_s=1e5, migrations=1_234_567,
        dcn_migrated_bytes=2**41, dcn_migration_s=2e5,
        power_deferrals=9_999_999)
    big = (port_cl.ClusterMetrics(**fields), ref_cl.ClusterMetrics(**fields))
    runs = [CASES[c](*pkg)[1][1] for c in ("trace0-progress", "fleet-greedy")
            for pkg in (PORT, REF)]
    port_table = port_cl.format_metrics([runs[0], runs[2], big[0]])
    assert port_table == ref_cl.format_metrics([runs[1], runs[3], big[1]])
    assert len({len(line) for line in port_table.splitlines()}) == 1


# ---------------------------------------------------------------------------
# live SliceRuntime execution on the CPU
# ---------------------------------------------------------------------------
def _live(cl, jobs, **kw):
    if cl is port_cl:
        kw.setdefault("device", "cpu")
    sched = cl.ClusterScheduler(n_pods=1, policy="frag_repack",
                                execute_serving=True, **kw)
    records, metrics = sched.run(jobs(cl))
    return sched, records, metrics


def _gpt2_and_batch(cl):
    """``test_cluster.py::test_serving_jobs_execute_on_live_runtime``'s
    trace."""
    return [cl.Job(0, "serving", "gpt2-124m", "decode_32k", 0.0, 50,
                   requests=2),
            cl.Job(1, "batch", "mamba2-130m", "decode_32k", 5.0, 50,
                   u_compute=0.1)]


def card_trace(cl):
    """The trace ``chip_smoke.py``'s cluster phase drives at full width: three
    serving tenants that overlap (gpt2, phi3-mini, llama3-8b) and a modelled
    batch job, then qwen3-32b alone after they finish."""
    return [cl.Job(0, "serving", "gpt2-124m", "decode_32k", 0.0, 50,
                   requests=2, duration_s=100.0),
            cl.Job(1, "serving", "phi3-mini-3.8b", "decode_32k", 5.0, 50,
                   requests=2, duration_s=100.0),
            cl.Job(2, "batch", "mamba2-130m", "decode_32k", 5.0, 50,
                   u_compute=0.1),
            cl.Job(3, "serving", "llama3-8b", "decode_32k", 10.0, 50,
                   requests=2, duration_s=100.0),
            cl.Job(4, "serving", "qwen3-32b", "decode_32k", 500.0, 50,
                   requests=2, duration_s=100.0)]


@pytest.mark.parametrize("trace", [_gpt2_and_batch, card_trace],
                         ids=["gpt2-and-batch", "card-trace"])
def test_live_serving_equals_reference(trace):
    ref, rrec, rm = _live(ref_cl, trace)
    port, prec, pm = _live(port_cl, trace)
    assert sha(prec) == sha(rrec)
    assert timeline(prec) == timeline(rrec)
    assert dataclasses.asdict(pm) == dataclasses.asdict(rm)
    serving = [r for r in prec if r.job.kind == "serving"]
    assert serving and all(r.executed for r in serving)
    assert all(r.tokens_out == r.job.requests * port.serving_max_new
               for r in serving)
    assert not any(r.executed for r in prec if r.job.kind != "serving")
    assert pm.completed == len(prec)
    pod = port.pods[0]
    assert not pod.runtime.tenants
    assert pod.partitioner.free_chips() == port.pod_spec.n_chips


def test_live_timeline_equals_modelled_timeline():
    """Executing the serving jobs changes no decision: the live run's
    timeline is the modelled run's."""
    live = _live(port_cl, card_trace)[1]
    modelled = port_cl.ClusterScheduler(n_pods=1, policy="frag_repack").run(
        card_trace(port_cl))[0]
    assert sha(live) == sha(modelled)


def test_live_flash_prefills_follow_the_formula(monkeypatch):
    """With ``attn_impl="pallas"`` every request's prefill reaches the flash
    kernel's wrapper once a layer: requests x layers a tenant, summed. On the
    card each call is one launch (``chip_smoke.py`` checks the count); on the
    CPU the wrapper takes its plain version, so the calls are counted here.
    The serving config changes no decision."""
    from repro_torch.kernels import ops as kops
    calls = []
    real = kops.flash_attention

    def counting(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)
    monkeypatch.setattr(kops, "flash_attention", counting)

    def cfg(arch):
        return port_tenant_config(arch).with_(attn_impl="pallas")
    sched, records, _ = _live(port_cl, card_trace, serving_config=cfg)
    want = sum(r.job.requests * cfg(r.job.arch).num_layers
               for r in records if r.job.kind == "serving")
    assert len(calls) == want
    assert all(s[1] <= sched.serving_max_seq for s in calls)
    plain = _live(port_cl, card_trace)[1]
    assert sha(records) == sha(plain)
    assert ([r.tokens_out for r in records] == [r.tokens_out for r in plain])


def test_default_serving_config_is_the_references_reduced_one():
    from repro.configs import get_config as ref_get_config
    assert port_cl.ClusterScheduler().serving_config is port_tenant_config
    for arch in port_cl.trace.SERVING_ARCHS:
        got = dataclasses.asdict(port_tenant_config(arch))
        want = dataclasses.asdict(
            ref_get_config(arch).reduced().with_(remat="none"))
        assert got == want, arch


def test_live_execution_defaults_to_cuda():
    """The live path runs on the card unless the caller asks for the CPU:
    without a card the default device raises, no CPU route is taken."""
    if torch.cuda.is_available():
        sched = port_cl.ClusterScheduler(n_pods=1, execute_serving=True)
        assert sched.pods[0].runtime.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cl.ClusterScheduler(n_pods=1, execute_serving=True)


@pytest.mark.parametrize("name", ["scheduling.md", "cluster.md",
                                  "autoscaling.md", "offloading.md",
                                  "hardware.md"])
def test_docs_worked_examples_run_on_the_port(name, monkeypatch):
    """The worked examples of ``docs/`` (the reference's, which
    ``tests/test_docs.py`` runs there) give the same printed results with
    every ``repro.`` import pointed at ``repro_torch.``."""
    import doctest
    import re
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    monkeypatch.chdir(repo)
    text = (repo / "docs" / name).read_text(encoding="utf-8")
    blocks = [b for b in re.findall(r"```python\n(.*?)```", text, re.S)
              if ">>>" in b]
    assert blocks
    parser = doctest.DocTestParser()
    runner = doctest.DocTestRunner(
        optionflags=doctest.NORMALIZE_WHITESPACE | doctest.ELLIPSIS)
    globs = {}
    for i, block in enumerate(blocks):
        block = re.sub(r"\brepro\.", "repro_torch.", block)
        assert "repro_torch." in block or "import" not in block
        test = parser.get_doctest(block, globs, f"{name}[{i}]", name, 0)
        runner.run(test, clear_globs=False)
        globs = test.globs
    assert runner.tries > 0 and runner.failures == 0
