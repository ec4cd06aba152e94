"""Parameters drawn straight into the tiers of an offload plan (CPU).

``Model.init(placement=...)`` draws each leaf into the tier the plan names,
so a tenant larger than the card is never on it whole; ``SliceRuntime``
plans on ``Model.init(abstract=True)`` and then draws. Held here:

* the plan cut from the abstract inventory equals the plan cut from the
  drawn one, for every arch (reduced);
* at full size, qwen2-vl-72b's and phi3.5-moe-42b-a6.6b's plans at a
  72,000,000,000-byte budget equal the reference's ``plan_offload`` over the
  reference's own abstract inventory, field by field, and qwen2-vl-72b's is
  the 80-layer plan ``chip_smoke.py``'s ``vlm`` phase serves: the table, the
  KV pool and the two gate/input MLP stacks on the host, 82,686,509,056
  bytes; phi3.5-moe-42b-a6.6b's is the plan of the ``moe_full`` phase: the
  table, the KV pool and the gate expert stack, 28,179,955,712 bytes, drawn
  in an order whose device bytes never pass the resident bytes;
* ``init`` with a placement equals ``init`` bit for bit for every family
  (on the CPU both tiers are one memory: the placement changes nothing;
  the card's host route is held by ``test_torch_gpu.py``);
* a reduced ``SliceRuntime.add_tenant`` gives the parameters a plain
  ``init`` gives and the tokens an engine on them gives;
* a host-tier buffer's memory lives while any view of it does.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import ENV
from repro.configs import get_config as ref_get_config
from repro.core.offload import plan_offload as ref_plan_offload
from repro.models.model_zoo import build_model as ref_build_model
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import offload
from repro_torch.core.offload import (PINNED_HOST_KIND, UNPINNED_HOST_KIND,
                                      _flatten_with_paths, kinds_with_offload,
                                      param_placement, plan_offload)
from repro_torch.models.common import tree_leaves
from repro_torch.models.model_zoo import build_model
from repro_torch.serving import Request, SliceRuntime, TenantEngine, TenantSpec

FAMILY_ARCHS = {"dense": "llama3-8b", "moe": "granite-moe-1b-a400m",
                "ssm": "mamba2-130m", "hybrid": "zamba2-1.2b",
                "encdec": "whisper-large-v3", "vlm": "qwen2-vl-72b"}
SLOTS, MAX_SEQ = 2, 32
FULL_SLOTS, FULL_MAX_SEQ, FULL_BUDGET = 4, 2048, 72_000_000_000
QWEN_HOST = ("params/tok_embed", "kv/k", "kv/v", "params/layers/w_gate",
             "params/layers/w_in")
PHI35_HOST = ("params/tok_embed", "kv/k", "kv/v", "params/layers/w_gate")


def _reduced(arch):
    return get_config(arch).reduced().with_(remat="none")


def _draw(model, seed=0, placement=None):
    gen = torch.Generator().manual_seed(seed)
    return model.init(gen, placement=placement)[0]


def _spilling_plan(model, params):
    """A plan whose budget is half the footprint: whole leaves and a
    partial spill (a 4 KiB granule) on the host."""
    inv = model.serving_inventory(params, model.cache_shapes(SLOTS, MAX_SEQ))
    total = sum(t.bytes for t in inv)
    return plan_offload(inv, total // 2, spill_granule=4096)


def _assert_bitwise(a, b):
    la, lb = _flatten_with_paths(a), _flatten_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bfloat16
                           else x, y.view(torch.uint8)
                           if y.dtype == torch.bfloat16 else y), path


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_plan_equals_drawn_plan(arch):
    model = build_model(_reduced(arch), "cpu")
    shapes, _ = model.init(abstract=True)
    drawn = _draw(model)
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    plan_shapes = _spilling_plan(model, shapes)
    assert plan_shapes == _spilling_plan(model, drawn)
    assert plan_shapes.host_bytes > 0 and plan_shapes.fits


def _port_full_plan(arch):
    cfg = get_config(arch).with_(param_dtype="bfloat16")
    model = build_model(cfg, "cpu")
    inv = model.serving_inventory(model.init(abstract=True)[0],
                                  model.cache_shapes(FULL_SLOTS, FULL_MAX_SEQ))
    return plan_offload(inv, FULL_BUDGET), inv


def _ref_full_plan(arch):
    rcfg = ref_get_config(arch).with_(param_dtype="bfloat16")
    rmodel = ref_build_model(rcfg, ENV)
    shapes, _ = rmodel.init(None, abstract=True)
    cache = jax.eval_shape(
        lambda: rmodel.init_cache(FULL_SLOTS, FULL_MAX_SEQ, jnp.bfloat16))
    return ref_plan_offload(rmodel.serving_inventory(shapes, cache), FULL_BUDGET)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "phi3.5-moe-42b-a6.6b"])
def test_full_size_plan_equals_reference(arch):
    port, _ = _port_full_plan(arch)
    ref = _ref_full_plan(arch)
    for field in ("offloaded", "partial", "resident_bytes", "host_bytes",
                  "host_traffic_per_step", "fits", "partial_totals"):
        assert getattr(port, field) == getattr(ref, field), field


def test_qwen2_vl_full_plan_is_the_vlm_phase_plan():
    plan, inv = _port_full_plan("qwen2-vl-72b")
    sizes = {t.name: t.bytes for t in inv}
    assert sum(sizes.values()) == 148_095_123_456
    assert plan.fits and plan.partial == ()
    assert set(plan.offloaded) == set(QWEN_HOST)
    assert plan.host_bytes == sum(sizes[n] for n in QWEN_HOST) == 82_686_509_056
    assert sizes["params/layers/w_in"] == sizes["params/layers/w_gate"] \
        == 80 * 8192 * 29568 * 2
    assert plan.resident_bytes == 65_408_614_400
    # the same plan at any budget from the resident bytes to where the
    # second stack would stay on the card
    for budget in (plan.resident_bytes, 80_000_000_000,
                   plan.resident_bytes + sizes["params/layers/w_in"] - 1):
        assert plan_offload(inv, budget).offloaded == plan.offloaded


def _in_init_order(tree, prefix=""):
    """(path, leaf) in the order ``init`` draws them: the builder's dicts
    keep the order their leaves were added in."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _in_init_order(leaf, f"{prefix}{name}/")
        else:
            yield prefix + name, leaf


def test_phi35_moe_full_plan_is_the_moe_full_phase_plan():
    plan, inv = _port_full_plan("phi3.5-moe-42b-a6.6b")
    sizes = {t.name: t.bytes for t in inv}
    assert sum(sizes.values()) == 84_818_796_544
    stack = 32 * 16 * 4096 * 6400 * 2
    assert sizes["params/layers/w_gate"] == sizes["params/layers/w_in"] \
        == sizes["params/layers/w_out"] == stack
    assert plan.fits and plan.partial == ()
    assert set(plan.offloaded) == set(PHI35_HOST)
    assert plan.host_bytes == sum(sizes[n] for n in PHI35_HOST) == 28_179_955_712
    assert plan.resident_bytes == 56_638_840_832
    # the same plan at any budget from the resident bytes to where the
    # stack would stay on the card, the card's ~76 GB among them
    for budget in (plan.resident_bytes, 80_000_000_000,
                   plan.resident_bytes + stack - 1):
        again = plan_offload(inv, budget)
        assert (again.offloaded, again.partial, again.host_bytes) == (
            plan.offloaded, (), plan.host_bytes), budget
    assert plan_offload(inv, plan.resident_bytes + stack).offloaded == \
        ("params/tok_embed", "kv/k", "kv/v")
    # drawn in init's order, a host leaf on the card until it is copied
    # out: w_gate is drawn after w_in and before w_out, its equal, so the
    # device holds at most the resident bytes
    model = build_model(get_config("phi3.5-moe-42b-a6.6b").with_(
        param_dtype="bfloat16"), "cpu")
    shapes, _ = model.init(abstract=True)
    placement = param_placement(shapes, plan, "cuda")
    order = [p for p, _ in _in_init_order(shapes)]
    assert order.index("layers/w_in") < order.index("layers/w_gate") \
        < order.index("layers/w_out")
    held = peak = 0
    for path, leaf in _in_init_order(shapes):
        nbytes = leaf.numel() * leaf.element_size()
        if placement[path] == PINNED_HOST_KIND:
            peak = max(peak, held + nbytes)
        else:
            held += nbytes
            peak = max(peak, held)
    assert held == peak == plan.resident_bytes


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_placed_init_equals_init(family):
    model = build_model(_reduced(FAMILY_ARCHS[family]), "cpu")
    shapes, _ = model.init(abstract=True)
    plan = _spilling_plan(model, shapes)
    # the kinds a CUDA engine would place (computing them needs no card)
    placement = param_placement(shapes, plan, "cuda")
    assert set(placement) == {p for p, _ in _flatten_with_paths(shapes)}
    assert PINNED_HOST_KIND in placement.values()
    _assert_bitwise(_draw(model, 5, placement), _draw(model, 5))
    cpu_placement = param_placement(shapes, plan, "cpu")
    assert set(cpu_placement.values()) == {UNPINNED_HOST_KIND}
    _assert_bitwise(_draw(model, 5, cpu_placement), _draw(model, 5))


def test_placement_must_name_every_leaf():
    model = build_model(_reduced("llama3-8b"), "cpu")
    shapes, _ = model.init(abstract=True)
    placement = param_placement(shapes, _spilling_plan(model, shapes), "cuda")
    del placement["layers/w_out"]
    with pytest.raises(KeyError, match="layers/w_out"):
        _draw(model, 0, placement)


def test_param_placement_is_place_trees_kinds():
    model = build_model(_reduced("gpt2-124m"), "cpu")
    shapes, _ = model.init(abstract=True)
    plan = _spilling_plan(model, shapes)
    kinds = kinds_with_offload({"params": shapes}, plan, "cuda")
    placement = param_placement(shapes, plan, "cuda")
    assert {f"params/{p}": k for p, k in placement.items()} == kinds
    host = {p for p, k in placement.items() if k == PINNED_HOST_KIND}
    assert host == {n[len("params/"):] for n in plan.offloaded
                    if n.startswith("params/")} | {
        n[len("params/"):] for n, b in plan.partial if n.startswith("params/")
        and b / dict(plan.partial_totals)[n] >= 0.5}


def _requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=int(rng.integers(3, 9))).astype(np.int32), 4)
            for i in range(n)]


@pytest.mark.parametrize("arch", ["llama3-8b", "granite-moe-1b-a400m"])
def test_runtime_tenant_params_and_tokens_unchanged(arch):
    cfg = _reduced(arch).with_(dtype="float32")
    rt = SliceRuntime(device="cpu")
    tenant = rt.add_tenant(TenantSpec("t", cfg, profile="2s.32c", slots=SLOTS,
                                      max_seq=MAX_SEQ, hbm_budget=300_000,
                                      spill_granule=4096, seed=7))
    assert tenant.plan.host_bytes > 0
    model = build_model(cfg, "cpu")
    params = _draw(model, 7)
    _assert_bitwise(tenant.params, params)
    assert tenant.inventory_bytes == (
        sum(t.numel() * t.element_size() for t in tree_leaves(params))
        + model.cache_bytes(SLOTS, MAX_SEQ))
    rt.submit("t", _requests(cfg, 3, 1))
    rt.run()
    lone = TenantEngine(model, params, slots=SLOTS, max_seq=MAX_SEQ,
                        plan=tenant.plan)
    assert lone.run(_requests(cfg, 3, 1)) == tenant.engine.outputs


def test_host_buffer_lives_while_a_view_does():
    freed = []
    buf = offload._mapped(3 * 4096 + 10, freed.append)
    assert buf.numel() == 3 * 4096 + 10 and buf.data_ptr() % 4096 == 0
    address = buf.data_ptr()
    layer = buf[:3 * 4096].view(torch.bfloat16).view(3, 2048)[1]
    layer.fill_(2)
    del buf
    gc.collect()
    assert freed == []
    assert float(layer.float().sum()) == 4096.0
    del layer
    gc.collect()
    assert freed == [address]


def test_empty_host_on_the_cpu_is_plain_memory():
    t = offload.empty_host((3, 5), torch.bfloat16, "cpu")
    assert t.shape == (3, 5) and t.dtype == torch.bfloat16
    assert not t.is_pinned()
