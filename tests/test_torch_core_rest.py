"""The port's ``core/{utilization,cosched,reward}.py`` against the
reference's: every report, sharing table, co-run and reward sweep equal
field by field (floats bit for bit) for every arch on every shape suite it
runs, and the paper-fidelity oracle of ``tests/test_reward_paper.py``
re-expressed on the port."""
import dataclasses

import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import get_shape as ref_get_shape
from repro.core import cosched as ref_cosched
from repro.core import reward as ref_reward
from repro.core import utilization as ref_util
from repro.core.hw import V5E as REF_V5E
from repro.core.slices import PROFILES as REF_PROFILES
from repro.core.workload import WorkloadEstimate as RefWorkload
from repro_torch import core as port_core
from repro_torch.configs import ALL_ARCHS, SHAPES, applicable, get_config, get_shape
from repro_torch.core import cosched, reward, utilization
from repro_torch.core.hw import GiB, V5E, V5E_POD
from repro_torch.core.power import InstanceLoad, throttle_factor
from repro_torch.core.slices import PROFILES, get_profile
from repro_torch.core.workload import WorkloadEstimate

ALPHAS = (0.0, 0.25, 0.5, 1.0)


def plain(x):
    """Dataclasses (of either package) as (class name, fields) tuples, all
    the way down, so reports of the two packages compare with ``==``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, plain(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def _pairs(arch):
    """(reference workload, port workload) on every shape suite the arch
    runs."""
    cfg = get_config(arch)
    out = []
    for shape in SHAPES:
        if applicable(cfg, shape)[0]:
            out.append((RefWorkload(ref_get_config(arch),
                                    ref_get_shape(shape.name)),
                        WorkloadEstimate(cfg, shape)))
    assert out
    return out


def _wl(arch, shape):
    return WorkloadEstimate(get_config(arch), get_shape(shape))


def test_core_exports_reward_as_the_reference():
    assert port_core.RewardPoint is reward.RewardPoint
    assert port_core.select is reward.select
    assert port_core.sweep is reward.sweep
    assert {"RewardPoint", "select", "sweep"} <= set(port_core.__all__)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_utilization_equals_reference(arch):
    for ref_wl, wl in _pairs(arch):
        for ref_prof, prof in zip(REF_PROFILES, PROFILES):
            assert (plain(utilization.utilization_on(wl, prof, V5E))
                    == plain(ref_util.utilization_on(ref_wl, ref_prof, REF_V5E)))
        assert (plain(utilization.scaling_curve(wl))
                == plain(ref_util.scaling_curve(ref_wl)))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_reward_sweep_and_select_equal_reference(arch):
    for ref_wl, wl in _pairs(arch):
        for alpha in ALPHAS:
            got = reward.sweep(wl, alpha=alpha)
            assert plain(got) == plain(ref_reward.sweep(ref_wl, alpha=alpha))
            assert ([p.label for p in got]
                    == [p.label for p in ref_reward.sweep(ref_wl, alpha=alpha)])
            assert (plain(reward.select(wl, alpha=alpha))
                    == plain(ref_reward.select(ref_wl, alpha=alpha)))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cosched_equals_reference(arch):
    for ref_wl, wl in _pairs(arch):
        assert (plain(cosched.sharing_table(wl))
                == plain(ref_cosched.sharing_table(ref_wl)))
        for ref_prof, prof in zip(REF_PROFILES, PROFILES):
            for copies in (1, 2, 16):
                assert (plain(cosched.corun_copies(wl, prof, copies, steps=37))
                        == plain(ref_cosched.corun_copies(ref_wl, ref_prof,
                                                          copies, steps=37)))


def test_mixed_tenancy_equals_reference():
    """``tests/test_system.py``'s multi-tenant flow: each tenant's reward
    pick, then the pod co-run of all three."""
    tags = {"llm-serve": ("llama3-8b", "decode_32k"),
            "ssm-serve": ("mamba2-130m", "decode_32k"),
            "moe-train": ("granite-moe-1b-a400m", "train_4k")}
    wls = {t: _wl(a, s) for t, (a, s) in tags.items()}
    ref_wls = {t: RefWorkload(ref_get_config(a), ref_get_shape(s))
               for t, (a, s) in tags.items()}
    placement = {t: reward.sweep(wl, alpha=0.0)[0].profile.name
                 for t, wl in wls.items()}
    assert placement == {t: ref_reward.sweep(wl, alpha=0.0)[0].profile.name
                         for t, wl in ref_wls.items()}
    got = cosched.mixed_tenancy(wls, placement)
    assert got == ref_cosched.mixed_tenancy(ref_wls, placement)
    assert got["pod_utilization"] <= 1.0 and got["makespan_s"] > 0


# ---------------------------------------------------------------------------
# the paper-fidelity oracle (tests/test_reward_paper.py) on the port
# ---------------------------------------------------------------------------
def test_alpha0_prefers_offload_when_footprint_slightly_exceeds():
    wl = _wl("llama3-8b", "decode_32k")
    assert 512 * GiB < wl.footprint_bytes() < 1024 * GiB
    best = reward.sweep(wl, alpha=0.0)[0]
    assert best.plan is not None and best.plan.host_bytes > 0
    assert best.profile.name == "2s.32c"


def test_alpha1_prefers_full_pod_for_good_scalers():
    best = reward.sweep(_wl("qwen2-vl-72b", "train_4k"), alpha=1.0)[0]
    assert best.profile.name == PROFILES[-1].name


def test_reward_monotone_in_alpha_for_perf():
    wl = _wl("llama3-8b", "decode_32k")
    chips = [reward.sweep(wl, alpha=a)[0].profile.n_chips
             for a in (0.0, 0.5, 1.0)]
    assert chips == sorted(chips)


def test_scaling_classes():
    big = utilization.scaling_curve(_wl("qwen2-vl-72b", "train_4k"))
    pts = [r for r in big if r["fits"]]
    assert pts[-1]["rel_perf"] > 0.8 * pts[-1]["ideal"]
    small = utilization.scaling_curve(_wl("mamba2-130m", "decode_32k"))
    pts = [r for r in small if r["fits"]]
    assert pts[-1]["rel_perf"] < 0.5 * pts[-1]["ideal"]


def test_corun_improves_throughput_for_underutilizing_workloads():
    r = cosched.corun_copies(_wl("mamba2-130m", "decode_32k"),
                             get_profile("1s.16c"), 16)
    assert r is not None and r.throughput_norm > 1.5


def test_corun_no_gain_for_compute_bound():
    r = cosched.corun_copies(_wl("qwen2-vl-72b", "train_4k"),
                             get_profile("4s.64c"), 4)
    if r is not None:
        assert r.throughput_norm < 1.2


def test_finest_sharing_lowest_energy():
    table = cosched.sharing_table(_wl("mamba2-130m", "decode_32k"))
    assert table, "no sharing configs fit"
    best = min(table, key=lambda r: r.energy_norm)
    assert best.config.endswith("1s.16c")
    assert best.energy_norm < 1.0


def test_shared_power_cap_throttles_concurrent_compute():
    hot = InstanceLoad(n_chips=16, u_compute=1.0, step_time=1.0)
    assert throttle_factor([hot]) == 1.0
    assert throttle_factor([hot] * 16) < 1.0


def test_corun_refuses_more_copies_than_the_pod_holds():
    prof = get_profile("8s.128c")
    wl = _wl("gpt2-124m", "decode_32k")
    assert cosched.corun_copies(wl, prof, prof.max_instances(V5E_POD) + 1) is None
