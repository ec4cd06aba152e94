"""The port's multi-tenant layer against the reference's: performance, power
and workload models equal exactly for every arch x shape suite x profile;
partitioner sequences giving identical rectangles; the runtime tests of
tests/test_slice_runtime.py re-expressed; reports, tenant tokens (fp32) and
CLI placement lines equal to the reference runtime's.

The reference runs without a mesh here (placement is then a no-op, as the
port's is on the CPU). Reference weights are handed to the port by patching
``Model.init`` to return the reference's init for the same seed."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from port_parity import ENV, np_tree
from repro.configs import get_config as ref_get_config
from repro.configs.base import ModelConfig as RefModelConfig
from repro.core import offload as ref_off
from repro.core import perfmodel as ref_pm
from repro.core import power as ref_power
from repro.core.partitioner import StaticPartitioner as RefPartitioner
from repro.core.slices import PROFILES as REF_PROFILES
from repro.core.workload import WorkloadEstimate as RefWorkload
from repro.models.model_zoo import build_model as ref_build_model
from repro.serving import Request as RefRequest
from repro.serving import SliceRuntime as RefRuntime
from repro.serving import TenantSpec as RefSpec
from repro.launch.mesh import make_host_mesh
from repro.serving.kv_pool import KVPool as RefKVPool
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config
from repro_torch.core import offload as port_off
from repro_torch.core import perfmodel as port_pm
from repro_torch.core import power as port_power
from repro_torch.core import roofline as port_roofline
from repro_torch.core.hw import V5E_POD
from repro_torch.core.partitioner import StaticPartitioner
from repro_torch.core.slices import PROFILES, get_profile
from repro_torch.core.workload import WorkloadEstimate
from repro_torch.launch import serve as port_serve
from repro_torch.models import model_zoo as port_zoo
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import Request, ServingEngine, SliceRuntime, TenantSpec

asdict = dataclasses.asdict
PROFILE_NAMES = [p.name for p in PROFILES]


def _ref_cfg(cfg):
    """The reference's ModelConfig with the port config's fields."""
    return RefModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})


def _ref_shape(shape):
    from repro.configs import get_shape as ref_get_shape
    return ref_get_shape(shape.name)


def _ref_profile(name):
    return next(p for p in REF_PROFILES if p.name == name)


def _gpt2():
    return get_config("gpt2-124m").reduced().with_(remat="none")


# ---------------------------------------------------------------------------
# performance, workload and power models: exact equality
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_workload_and_scores_equal_reference(arch):
    cfg = get_config(arch)
    rcfg = _ref_cfg(cfg)
    port, ref = port_pm.PerfModel(), ref_pm.PerfModel()
    for shape in SHAPES:
        wl, rwl = WorkloadEstimate(cfg, shape), RefWorkload(rcfg, _ref_shape(shape))
        assert [asdict(t) for t in wl.inventory()] == [asdict(t) for t in rwl.inventory()]
        assert (wl.flops(), wl.hbm_bytes(), wl.footprint_bytes()) == \
            (rwl.flops(), rwl.hbm_bytes(), rwl.footprint_bytes())
        for name in PROFILE_NAMES:
            prof, rprof = get_profile(name), _ref_profile(name)
            assert asdict(wl.plan_for(prof)) == asdict(rwl.plan_for(rprof))
            assert wl.collective_bytes_per_chip(prof.n_chips) == \
                rwl.collective_bytes_per_chip(rprof.n_chips)
            sc, rsc = port.score(cfg, shape, prof), ref.score(rcfg, _ref_shape(shape), rprof)
            assert (sc is None) == (rsc is None)
            if sc is not None:
                assert asdict(sc) == asdict(rsc)
                assert sc.terms.as_dict() == rsc.terms.as_dict()
                assert asdict(sc.load(7)) == asdict(rsc.load(7))


def test_model_flops_and_analyze():
    from repro.core.roofline import model_flops_for as ref_model_flops
    for arch in ALL_ARCHS:
        for shape in SHAPES:
            assert port_roofline.model_flops_for(get_config(arch), shape) == \
                ref_model_flops(_ref_cfg(get_config(arch)), _ref_shape(shape))
    # analyze: the reference's terms from its HLO analysis of a compiled
    # program, the port's from a StepCost holding the same counts
    import jax.numpy as jnp
    from repro.core.hlo_analysis import analyze_hlo
    from repro.core.roofline import analyze as ref_analyze
    from repro_torch.core.step_analysis import StepCost
    hlo = jax.jit(lambda a, b: jnp.tanh(a @ b)).lower(
        jnp.zeros((64, 128)), jnp.zeros((128, 256))).compile().as_text()
    hc = analyze_hlo(hlo)
    cost = StepCost(flops=hc.flops, bytes_accessed=hc.bytes_accessed,
                    collective_bytes=dict(hc.collective_bytes),
                    collective_counts=dict(hc.collective_counts))
    assert hc.trip_counts == {}      # no loop: nothing for the port to scale
    for n_chips, host in ((1, 0.0), (16, 3e9)):
        want = ref_analyze({}, hlo, n_chips, 1e12, host_bytes_per_step=host)
        got = port_roofline.analyze(cost, n_chips, 1e12,
                                    host_bytes_per_step=host)
        assert got.as_dict() == want.as_dict()
        assert got.hlo_cost is cost


@pytest.mark.parametrize("archs", [("llama3-8b", "gpt2-124m"),
                                   ("qwen3-32b", "mamba2-130m", "phi3-mini-3.8b"),
                                   ("granite-moe-1b-a400m",) * 4])
def test_corun_and_power_equal_reference(archs):
    port, ref = port_pm.get_model(), ref_pm.get_model()
    loads, rloads = [], []
    for i, arch in enumerate(archs):
        name = PROFILE_NAMES[i % 3]
        for shape in SHAPES:   # the first shape suite that fits the slice
            sc = port.score(get_config(arch), shape, get_profile(name))
            rsc = ref.score(_ref_cfg(get_config(arch)), _ref_shape(shape),
                            _ref_profile(name))
            if sc is not None:
                loads.append(sc.load(100))
                rloads.append(rsc.load(100))
                break
    assert len(loads) == len(archs)
    assert asdict(port.corun(loads)) == asdict(ref.corun(rloads))
    assert port.throttle(loads) == ref.throttle(rloads)
    assert port.draw(loads, capped=False) == ref.draw(rloads, capped=False)
    assert port_power.co_run(loads) == ref_power.co_run(rloads)
    assert port_power.serial_run(loads[0], 3) == ref_power.serial_run(rloads[0], 3)
    assert port.serial_baseline(loads[-1], 2) == ref.serial_baseline(rloads[-1], 2)
    assert asdict(port.checkpoint_cost(10**9, 3e10)) == \
        asdict(ref.checkpoint_cost(10**9, 3e10))


def test_twin_scores_equal_reference():
    port = port_pm.get_model(twin=port_off.TwinSpec())
    ref = ref_pm.get_model(twin=ref_off.TwinSpec())
    assert port.profile_key == ref.profile_key
    n_twin = 0
    for arch in ALL_ARCHS:
        for shape in SHAPES:
            for name in PROFILE_NAMES:
                tw = port.score_twin(get_config(arch), shape, get_profile(name))
                rtw = ref.score_twin(_ref_cfg(get_config(arch)), _ref_shape(shape),
                                     _ref_profile(name))
                assert (tw is None) == (rtw is None)
                if tw is not None:
                    n_twin += 1
                    assert tw.rung == rtw.rung
                    assert asdict(tw) == asdict(rtw)
    assert n_twin > 0


def test_pod_simulator_equal_reference():
    for frozen in (False, True):
        sims = port_pm.PodSimulator(frozen=frozen), ref_pm.PodSimulator(frozen=frozen)
        trace = []
        for sim in sims:
            out = [sim.admit(0, 16, 0.9, 0.02, 500, 0.0),
                   sim.admit(1, 64, 0.7, 0.05, 300, 1.0, start_delay=0.5),
                   sim.admit(2, 32, 0.2, 0.01, 100, 1.5, duration_s=4.0)]
            sim.advance(2.0)
            sim.resize(1, 32, 0.8, 0.04)
            sim.delay(0, 0.25)
            out += [sim.throttle(), sim.draw(), sim.projected_finish(0, 2.0),
                    sorted(sim.finish_times(2.0).items())]
            sim.advance(3.0)
            sim.remove(2)
            out += [sim.generation, sorted(sim.finish_times(3.0).items())]
            trace.append(out)
        assert trace[0] == trace[1]


# ---------------------------------------------------------------------------
# partitioner: identical rectangles under the same operation sequences
# ---------------------------------------------------------------------------
def _state(part):
    return (part._grid.tolist(),
            sorted((sid, a.profile.name, a.origin, a.tag)
                   for sid, a in part.allocations.items()),
            part.free_chips(), part.utilization(), part.fragmentation_ratio(),
            getattr(part.largest_free_profile(), "name", None))


def _apply(part, op, profiles):
    kind, arg = op
    try:
        if kind == "alloc":
            a = part.allocate(profiles[arg[0]], tag=f"t{arg[0]}", origin=arg[1])
            return ("ok", a.slice_id, a.origin)
        if kind == "release":
            if arg not in part.allocations:
                return ("skip",)
            part.release(arg)
        elif kind == "repack":
            return ("ok", sorted(part.repack().items()))
        elif kind == "resize":
            sid, p = arg
            if sid not in part.allocations:
                return ("skip",)
            a = part.resize(sid, profiles[p])
            return ("ok", a.origin, a.profile.name)
        elif kind == "fail":
            return ("ok", sorted(part.fail_chips([arg])))
        elif kind == "best":
            return ("ok", part.best_origin_for(profiles[arg]),
                    part.origins_for(profiles[arg]))
        return ("ok",)
    except Exception as e:   # the same refusal on both sides
        return ("raise", type(e).__name__)


@pytest.mark.parametrize("seed", range(6))
def test_partitioner_sequences_give_identical_rectangles(seed):
    rng = np.random.default_rng(seed)
    port, ref = StaticPartitioner(), RefPartitioner()
    ops = []
    for _ in range(60):
        kind = rng.choice(["alloc", "alloc", "alloc", "release", "repack",
                           "resize", "fail", "best"], p=[.2, .15, .15, .15, .1, .1, .05, .1])
        p = int(rng.integers(0, 4))
        if kind == "alloc":
            origin = None
            if rng.random() < 0.3:
                prof = PROFILES[p]
                origin = (int(rng.integers(0, 16 // prof.rows)) * prof.rows,
                          int(rng.integers(0, 16 // prof.cols)) * prof.cols)
            ops.append((kind, (p, origin)))
        elif kind in ("release",):
            ops.append((kind, int(rng.integers(0, 20))))
        elif kind == "resize":
            ops.append((kind, (int(rng.integers(0, 20)), p)))
        elif kind == "fail":
            ops.append((kind, (int(rng.integers(0, 16)), int(rng.integers(0, 16)))))
        else:
            ops.append((kind, p))
    for op in ops:
        got = _apply(port, op, PROFILES)
        want = _apply(ref, op, REF_PROFILES)
        assert got == want, op
        assert _state(port) == _state(ref), op
        port.validate()


def test_slice_device_is_the_tenant_device():
    part = StaticPartitioner(devices=[torch.device("cpu")] * V5E_POD.n_chips)
    a = part.allocate(get_profile("1s.16c"))
    assert a.device() == torch.device("cpu")
    assert StaticPartitioner().allocate(get_profile("1s.16c")).devices is None


# ---------------------------------------------------------------------------
# tests/test_slice_runtime.py, re-expressed for the port
# ---------------------------------------------------------------------------
def test_packing_fails_loudly():
    rt = SliceRuntime(device="cpu")
    rt.add_tenant(TenantSpec("big", _gpt2(), profile="16s.256c", slots=1, max_seq=16))
    free_before = rt.partitioner.free_chips()
    with pytest.raises(RuntimeError, match="no room"):
        rt.add_tenant(TenantSpec("late", _gpt2(), profile="1s.16c", slots=1, max_seq=16))
    assert rt.partitioner.free_chips() == free_before
    assert "late" not in rt.tenants
    with pytest.raises(ValueError, match="duplicate"):
        rt.add_tenant(TenantSpec("big", _gpt2(), profile="1s.16c", slots=1, max_seq=16))


def test_resize_tenant_grow_shrink_roundtrip():
    rt = SliceRuntime(device="cpu")
    tenant = rt.add_tenant(TenantSpec("t", _gpt2(), profile="1s.16c", slots=1, max_seq=16))
    sid, origin = tenant.alloc.slice_id, tenant.alloc.origin
    free0 = rt.partitioner.free_chips()
    assert rt.resize_tenant("t", "4s.64c") is tenant and tenant.alloc.slice_id == sid
    assert tenant.alloc.profile.name == "4s.64c" and tenant.plan.fits
    assert rt.partitioner.free_chips() == free0 - (64 - 16)
    rt.partitioner.validate()
    back = rt.resize_tenant("t", "1s.16c")
    assert back.alloc.profile.name == "1s.16c" and back.alloc.origin == origin
    assert rt.partitioner.free_chips() == free0
    assert rt.resize_tenant("t", "1s.16c") is tenant


def test_resize_tenant_grow_conflict_is_transactional():
    rt = SliceRuntime(device="cpu")
    rt.add_tenant(TenantSpec("a", _gpt2(), profile="1s.16c", slots=1, max_seq=16))
    rt.add_tenant(TenantSpec("b", _gpt2(), profile="1s.16c", slots=1, max_seq=16,
                             origin=(0, 4)))
    a = rt.tenants["a"]
    plan_before, grid_before = a.plan, rt.partitioner._grid.copy()
    with pytest.raises(RuntimeError, match="extend failed"):
        rt.resize_tenant("a", "2s.32c")
    assert (rt.partitioner._grid == grid_before).all()
    assert a.alloc.profile.name == "1s.16c" and a.plan is plan_before


def test_resize_tenant_probe_rejects_unfit_profile(monkeypatch):
    rt = SliceRuntime(device="cpu")
    tenant = rt.add_tenant(TenantSpec("t", _gpt2(), profile="2s.32c", slots=1, max_seq=16))
    plan_before, grid_before = tenant.plan, rt.partitioner._grid.copy()
    import repro_torch.serving.runtime as runtime_mod
    unfit = dataclasses.replace(plan_before, fits=False)
    monkeypatch.setattr(runtime_mod, "plan_offload", lambda *a, **k: unfit)
    with pytest.raises(RuntimeError, match="does not fit"):
        rt.resize_tenant("t", "1s.16c")
    assert (rt.partitioner._grid == grid_before).all()
    assert tenant.alloc.profile.name == "2s.32c" and tenant.plan is plan_before


def test_partitioner_repack_and_pinned_origin():
    part = StaticPartitioner()
    p = get_profile("1s.16c")
    allocs = [part.allocate(p, tag=f"t{i}") for i in range(4)]
    part.release(allocs[0].slice_id)
    part.release(allocs[2].slice_id)
    moved = part.repack()
    part.validate()
    assert sorted(a.origin for a in part.allocations.values()) == [(0, 0), (0, 4)]
    assert set(moved) <= {a.slice_id for a in allocs}
    part2 = StaticPartitioner()
    assert part2.allocate(p, origin=(4, 8)).origin == (4, 8)
    with pytest.raises(RuntimeError, match="not free"):
        part2.allocate(p, origin=(4, 8))
    with pytest.raises(ValueError, match="not aligned"):
        part2.allocate(p, origin=(2, 8))
    part3 = StaticPartitioner()
    victim = part3.allocate(p, tag="victim")
    part3.fail_chips([(0, 0)])
    assert victim.slice_id not in part3.allocations
    b = part3.allocate(p, tag="evacuee")
    part3.repack()
    assert part3.allocations[b.slice_id].origin != (0, 0)


def test_tenant_plans_match_inventory():
    cfg = _gpt2()
    rt = SliceRuntime(device="cpu")
    fits = rt.add_tenant(TenantSpec("fits", cfg, profile="1s.16c", slots=2, max_seq=32))
    inv = fits.model.serving_inventory(fits.params, fits.model.cache_shapes(2, 32))
    total, names = sum(t.bytes for t in inv), {t.name for t in inv}
    spilled = rt.add_tenant(TenantSpec(
        "spilled", cfg, profile="1s.16c", slots=2, max_seq=32,
        hbm_budget=int(total * 0.8), spill_granule=1024))
    for t in (fits, spilled):
        assert t.plan.resident_bytes + t.plan.host_bytes == total == t.inventory_bytes
        assert set(t.plan.offloaded) <= names
        assert {n for n, _ in t.plan.partial} <= names
    assert fits.plan.host_bytes == 0 and not fits.plan.offloaded
    assert 0 < spilled.plan.host_bytes and spilled.plan.resident_bytes <= int(total * 0.8)
    pool = spilled.engine.pool
    assert pool.host_bytes + pool.device_bytes == fits.model.cache_bytes(2, 32)


def test_runtime_serves_tenants_concurrently():
    cfg = _gpt2()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=5).astype(np.int32)
               for _ in range(3)]
    rt = SliceRuntime(device="cpu")
    a = rt.add_tenant(TenantSpec("a", cfg, profile="1s.16c", slots=2, max_seq=32))
    rt.add_tenant(TenantSpec("b", cfg, profile="2s.32c", slots=2, max_seq=32, seed=1))
    want = ServingEngine(a.model, a.params, slots=2, max_seq=32).run(
        [Request(i, p, 4) for i, p in enumerate(prompts)])
    rt.submit("a", [Request(i, p, 4) for i, p in enumerate(prompts)])
    rt.submit("b", [Request(i, p, 4) for i, p in enumerate(prompts)])
    report = rt.run()
    assert rt.tenants["a"].engine.outputs == want, \
        "co-running another tenant must not change tenant a's tokens"
    for name in ("a", "b"):
        row = report["tenants"][name]
        assert row["tokens_out"] == 12 and row["completed"] == 3
        lat = row["latency"]
        assert set(lat) == {"queue_wait_p50", "queue_wait_p99", "e2e_p50", "e2e_p99"}
        assert lat["e2e_p99"] >= lat["e2e_p50"] > 0.0
    assert report["pod_utilization"] == pytest.approx(48 / 256)
    assert 0 < report["modeled"]["throttle"] <= 1.0
    rt.remove_tenant("a", repack=True)
    assert report["pod_utilization"] > rt.partitioner.utilization()


def test_report_twin_block_gated_on_perf_model():
    rt = SliceRuntime(device="cpu")
    rt.add_tenant(TenantSpec("t", _gpt2(), profile="1s.16c", slots=1, max_seq=16))
    assert "twin" not in rt.report()["tenants"]["t"]
    rt2 = SliceRuntime(device="cpu", perf=port_pm.get_model(twin=port_off.TwinSpec()))
    rt2.add_tenant(TenantSpec("t", _gpt2(), profile="1s.16c", slots=1, max_seq=16))
    tw = rt2.report()["tenants"]["t"]["twin"]
    assert tw is None or ("+cpu" in tw["rung"] and 0.0 < tw["cpu_fraction"] <= 1.0)


def test_runtime_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert SliceRuntime().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SliceRuntime()


# ---------------------------------------------------------------------------
# against the reference runtime: tokens, report, CLI lines
# ---------------------------------------------------------------------------
@pytest.fixture
def reference_weights(monkeypatch):
    """Make the port's ``Model.init`` return the reference's init for the
    generator's seed (the weights a reference tenant gets). The abstract
    tree the runtime plans on stays the port's (the same shapes); a
    placement is a no-op on the CPU these tests run on."""
    port_init = port_zoo.Model.init

    def init(self, generator=None, *, abstract=False, placement=None):
        if abstract:
            return port_init(self, abstract=True)
        rmodel = ref_build_model(_ref_cfg(self.cfg), ENV)
        rparams, rspecs = rmodel.init(jax.random.PRNGKey(generator.initial_seed()))
        return (params_from_numpy(np_tree(rparams), device=self.device,
                                  dtype=self.cfg.param_dtype), rspecs)
    monkeypatch.setattr(port_zoo.Model, "init", init)


def _specs(spec_cls, cfgs):
    (lcfg, gcfg) = cfgs
    return [spec_cls("llm", lcfg, profile="2s.32c", slots=2, max_seq=48,
                     hbm_budget=300_000, spill_granule=4096),
            spec_cls("gpt2", gcfg, profile="1s.16c", slots=2, max_seq=32, seed=1)]


def _requests(req_cls, cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [req_cls(i, rng.integers(0, cfg.vocab_size, size=int(rng.integers(3, 9)))
                    .astype(np.int32), 4) for i in range(n)]


def test_tokens_and_report_equal_reference_runtime(reference_weights):
    cfgs = [get_config(a).reduced().with_(remat="none", dtype="float32")
            for a in ("llama3-8b", "gpt2-124m")]
    rt, ref = SliceRuntime(device="cpu"), RefRuntime()
    for spec in _specs(TenantSpec, cfgs):
        rt.add_tenant(spec)
    for spec in _specs(RefSpec, [_ref_cfg(c) for c in cfgs]):
        ref.add_tenant(spec)
    # the budget spills the table, the KV pool and a stacked MLP matrix
    assert "params/layers/w_gate" in rt.tenants["llm"].plan.offloaded
    for name, cfg, n in (("llm", cfgs[0], 5), ("gpt2", cfgs[1], 3)):
        rt.submit(name, _requests(Request, cfg, n, seed=n))
        ref.submit(name, _requests(RefRequest, cfg, n, seed=n))
    got, want = rt.run(), ref.run()
    for name in ("llm", "gpt2"):
        assert rt.tenants[name].engine.outputs == ref.tenants[name].engine.outputs
        g, w = dict(got["tenants"][name]), dict(want["tenants"][name])
        assert g.pop("tok_per_s") > 0 and w.pop("tok_per_s") > 0
        # without a mesh the reference's pool ignores the plan; with one it
        # splits the pool as the port's does on any device
        rt_t, ref_t = rt.tenants[name], ref.tenants[name]
        rpool = RefKVPool(ref_t.model, ref_t.spec.slots, ref_t.spec.max_seq,
                          mesh=make_host_mesh(1, 1), plan=ref_t.plan)
        assert (g.pop("kv_device_bytes"), g.pop("kv_host_bytes")) == \
            (rpool.device_bytes, rpool.host_bytes)
        assert w.pop("kv_device_bytes") + w.pop("kv_host_bytes") == \
            rpool.device_bytes + rpool.host_bytes
        assert g == w
    got.pop("tenants")
    want.pop("tenants")
    assert got == want


def test_cli_placement_lines_equal_reference(capsys, monkeypatch):
    """``--tenants llama3-8b:2s.32c,gpt2-124m:1s.16c --hbm-budget 380000``,
    reduced: the port's CLI prints the reference's placement and plan lines
    and its token counts."""
    argv = ["serve", "--tenants", "llama3-8b:2s.32c,gpt2-124m:1s.16c",
            "--hbm-budget", "380000", "--device", "cpu", "--requests", "2",
            "--max-new", "3"]
    monkeypatch.setattr("sys.argv", argv)
    port_serve.main()
    lines = capsys.readouterr().out.strip().splitlines()
    ref = RefRuntime()
    want = []
    for i, arch in enumerate(("llama3-8b", "gpt2-124m")):
        cfg = ref_get_config(arch).reduced().with_(remat="none")
        t = ref.add_tenant(RefSpec(
            name=arch, cfg=cfg, profile="2s.32c" if i == 0 else "1s.16c",
            slots=4, max_seq=128, hbm_budget=380000 if i == 0 else None,
            spill_granule=4096 if i == 0 else None))
        want.append(f"tenant {t.name}: slice={t.alloc.profile.name} "
                    f"rect={t.alloc.rect} offloaded={list(t.plan.offloaded)} "
                    f"partial={[n for n, _ in t.plan.partial]}")
    assert lines[:2] == want
    assert lines[2].startswith("llama3-8b: profile=2s.32c tokens=6 ")
    assert lines[3].startswith("gpt2-124m: profile=1s.16c tokens=6 ")
    report = ref.report()
    assert lines[4] == (f"pod_utilization={report['pod_utilization']:.2f} "
                        f"throttle={report['modeled']['throttle']:.2f}")


@pytest.mark.parametrize("name", ["slice_runtime_demo"])
def test_examples_run_on_the_cpu(name, monkeypatch, capsys):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    monkeypatch.setattr("sys.argv", [name, "--device", "cpu"])
    mod.main()
    assert "pod utilization: 19%" in capsys.readouterr().out
