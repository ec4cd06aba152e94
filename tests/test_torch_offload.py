"""The port's offload planner against the reference's: the same inventory
gives plans equal field by field; inventories carry the same names and
bytes; placement maps plans onto the two tiers (both plain CPU memory here)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from port_parity import model_pair
from repro.core import offload as ref_off
from repro.core.hw import V5E as REF_V5E
from repro.core.slices import get_profile as ref_get_profile
from repro_torch.core import offload as port_off
from repro_torch.core.hw import V5E as PORT_V5E
from repro_torch.core.slices import get_profile as port_get_profile


def _inventories(arch="llama3-8b", slots=2, max_seq=48):
    rm, rp, pm, pp = model_pair(arch, perturb=False)
    rinv = rm.serving_inventory(
        rp, jax.eval_shape(lambda: rm.init_cache(slots, max_seq)))
    pinv = pm.serving_inventory(pp, pm.cache_shapes(slots, max_seq))
    return rm, pm, pp, rinv, pinv


@pytest.mark.parametrize("arch", ["llama3-8b", "gpt2-124m"])
def test_serving_inventory_names_and_bytes_equal(arch):
    rm, pm, _, rinv, pinv = _inventories(arch)
    assert [dataclasses.asdict(t) for t in rinv] == [dataclasses.asdict(t) for t in pinv]
    assert any(t.name == "kv/k" and t.divisible for t in pinv)
    assert pm.cache_bytes(2, 48) == rm.cache_bytes(2, 48)
    assert pm.cache_bytes(2, 48) == sum(t.bytes for t in pinv if t.name.startswith("kv/"))


@pytest.mark.parametrize("frac", [1.2, 0.97, 0.9, 0.8, 0.6, 0.3, 0.05])
@pytest.mark.parametrize("granule", [1024, 4096, None])
def test_plans_equal_field_by_field(frac, granule):
    _, _, _, rinv, pinv = _inventories()
    total = sum(t.bytes for t in rinv)
    kw = {} if granule is None else {"spill_granule": granule}
    for host_budget in (None, total // 3):
        rplan = ref_off.plan_offload(rinv, int(total * frac), host_budget, **kw)
        pplan = port_off.plan_offload(pinv, int(total * frac), host_budget, **kw)
        assert dataclasses.asdict(rplan) == dataclasses.asdict(pplan)
        assert rplan.total_bytes == pplan.total_bytes
        for name, _ in pplan.partial:
            assert rplan.spilled_fraction(name) == pplan.spilled_fraction(name)


def test_hand_built_inventory_and_groups():
    names = ["opt/mu/w", "opt/nu/w", "params/tok_embed", "params/layers/wq",
             "kv/k", "kv/v", "cache/ssm/state", "x/cross_k", "act/0"]
    for n in names:
        assert ref_off._group_for(n) == port_off._group_for(n)
    rng = np.random.default_rng(0)
    sizes = rng.integers(1 << 10, 1 << 20, size=len(names))
    rinv = [ref_off.TensorInfo(n, int(b), ref_off._group_for(n)[0], True, i % 2 == 0)
            for i, (n, b) in enumerate(zip(names, sizes))]
    pinv = [port_off.TensorInfo(n, int(b), port_off._group_for(n)[0], True, i % 2 == 0)
            for i, (n, b) in enumerate(zip(names, sizes))]
    total = int(sizes.sum())
    for frac in (0.9, 0.5, 0.1):
        assert (dataclasses.asdict(ref_off.plan_offload(rinv, int(total * frac), spill_granule=4096))
                == dataclasses.asdict(port_off.plan_offload(pinv, int(total * frac), spill_granule=4096)))
    assert ref_off.GROUP_TRAFFIC == port_off.GROUP_TRAFFIC
    assert ref_off.GROUP_PRIORITY == port_off.GROUP_PRIORITY
    assert ref_off.MIN_SPILL_BYTES == port_off.MIN_SPILL_BYTES


def test_step_time_models_equal():
    assert ref_off.overlap_step_time(1.0, 0.4, 0.7) == port_off.overlap_step_time(1.0, 0.4, 0.7)
    _, _, _, rinv, pinv = _inventories()
    total = sum(t.bytes for t in rinv)
    rplan = ref_off.plan_offload(rinv, int(total * 0.7), spill_granule=1024)
    pplan = port_off.plan_offload(pinv, int(total * 0.7), spill_granule=1024)
    want = ref_off.estimated_step_slowdown(rplan, 1e-3, ref_get_profile("1s.16c"), REF_V5E)
    got = port_off.estimated_step_slowdown(pplan, 1e-3, port_get_profile("1s.16c"), PORT_V5E)
    assert want == got
    assert dataclasses.asdict(REF_V5E) == dataclasses.asdict(PORT_V5E)
    rc = [ref_off.TwinShard("opt", "opt_state", 0.0, 1e9, 4e8, 1e6, 8e8)]
    pc = [port_off.TwinShard("opt", "opt_state", 0.0, 1e9, 4e8, 1e6, 8e8)]
    rt = ref_off.plan_twin(rplan, rc, gpu_floor_s=1e-3, link_bw=4e9)
    pt = port_off.plan_twin(pplan, pc, gpu_floor_s=1e-3, link_bw=4e9)
    assert (rt.t_cpu, rt.t_link, rt.step_time, rt.cpu_fraction) == \
           (pt.t_cpu, pt.t_link, pt.step_time, pt.cpu_fraction)


def test_flatten_paths_match_reference():
    tree = {"b": {"y": np.zeros(2), "x": np.zeros(3)}, "a": [np.zeros(1), np.zeros(4)]}
    want = [p for p, _ in ref_off._flatten_with_paths(tree)]
    got = [p for p, _ in port_off._flatten_with_paths(
        {"b": {"y": torch.zeros(2), "x": torch.zeros(3)},
         "a": [torch.zeros(1), torch.zeros(4)]})]
    assert got == want == ["a/0", "a/1", "b/x", "b/y"]


def test_place_tree_and_kinds_on_cpu():
    """On the CPU both tiers are plain CPU memory (the caller asked for the
    CPU); the plan-to-kind mapping still rounds partial spills by majority."""
    tree = {"a": torch.ones(25), "b": torch.ones(25), "c": torch.ones(25)}
    plan = port_off.OffloadPlan(offloaded=("a",), partial=(("b", 75), ("c", 25)),
                                resident_bytes=100, host_bytes=200,
                                host_traffic_per_step=0.0, fits=True)
    kinds = port_off.kinds_with_offload(tree, plan, "cuda")
    assert kinds == {"a": "pinned_host", "b": "pinned_host", "c": "device"}
    kinds = port_off.kinds_with_offload(tree, plan, "cpu")
    assert set(kinds.values()) == {"unpinned_host"}
    placed = port_off.place_tree(tree, plan, "cpu")
    assert all(torch.equal(placed[k], tree[k]) for k in tree)
    assert {port_off.memory_kind_of(t) for t in placed.values()} == {"unpinned_host"}
    assert port_off.host_memory_kind("cuda") == "pinned_host"
    assert port_off.device_memory_kind("cuda") == "device"
    nested = port_off.place_tree({"params": {"w": tree["a"]}}, port_off.OffloadPlan(
        ("params/w",), (), 0, 100, 0.0, True), "cpu")["params"]
    assert torch.equal(nested["w"], tree["a"])
