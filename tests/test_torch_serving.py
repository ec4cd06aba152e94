"""Serving engine of the port: the five tests of tests/test_serving.py
re-expressed, generated tokens equal to the reference engine (fp32, offload
off), and plan-split / fully offloaded pools equal to the device pool.

Token-exact comparisons run in fp32 with random weights, where the top two
logits never tie, so ``torch.argmax`` and ``jnp.argmax`` agree. The
reference's own offloaded run is not used as an oracle."""
import numpy as np
import pytest
import torch

from port_parity import model_pair
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefServingEngine
from repro_torch.core.offload import plan_offload
from repro_torch.serving import KVPool, Request, ServingEngine, TenantEngine


def _pair(arch="llama3-8b", **kw):
    return model_pair(arch, dtype="float32", **kw)


def _port(arch="llama3-8b"):
    _, _, pm, pp = _pair(arch)
    return pm.cfg, pm, pp


def _reference_decode(model, params, prompt, n_new, max_seq=64):
    """Single-request greedy decode, step by step, scalar cache positions."""
    cache = model.init_cache(1, max_seq)
    _, _, pc = model.forward(params, {"tokens": torch.as_tensor(prompt).long()[None, :]},
                             return_cache=True)
    L = len(prompt)
    for name in cache:
        cache[name][:, :, :L] = pc[name].to(cache[name].dtype)
    out, tok, pos = [], int(prompt[-1]), L
    for _ in range(n_new):
        logits, cache = model.decode(params, cache, {
            "tokens": torch.tensor([[tok]]), "pos": torch.tensor(pos)})
        tok = int(torch.argmax(logits[0]))
        out.append(tok)
        pos += 1
    return out


def test_engine_matches_reference_single():
    cfg, model, params = _port()
    prompt = np.arange(1, 9, dtype=np.int32) % cfg.vocab_size
    want = _reference_decode(model, params, prompt, 6)
    eng = ServingEngine(model, params, slots=1, max_seq=64)
    out = eng.run([Request(0, prompt, 6)])
    assert out[0] == want


def test_engine_concurrent_requests_match_reference():
    cfg, model, params = _port()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 7)]
    want = [_reference_decode(model, params, p, 5) for p in prompts]
    eng = ServingEngine(model, params, slots=2, max_seq=64)
    out = eng.run([Request(i, p, 5) for i, p in enumerate(prompts)])
    for i in range(3):
        assert out[i] == want[i], f"request {i}"


def test_offloaded_kv_same_tokens():
    """KV pool in the host tier must not change results."""
    cfg, model, params = _port()
    prompt = np.arange(2, 10, dtype=np.int32)
    base = ServingEngine(model, params, slots=1, max_seq=64)
    off = ServingEngine(model, params, slots=1, max_seq=64, offload_kv=True)
    assert off.pool.host_bytes == model.cache_bytes(1, 64) and off.pool.device_bytes == 0
    assert base.pool.host_bytes == 0
    assert off.pool.memory_kinds() == {"unpinned_host"}   # a CPU engine
    out_a = base.run([Request(0, prompt, 5)])
    out_b = off.run([Request(0, prompt, 5)])
    assert out_a[0] == out_b[0]
    assert off.pool.d2h_bytes > 0 and off.pool.h2d_bytes > 0


def test_slots_are_recycled():
    cfg, model, params = _port("gpt2-124m")
    rng = np.random.default_rng(2)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=4).astype(np.int32), 3)
            for i in range(5)]
    eng = ServingEngine(model, params, slots=2, max_seq=32)
    out = eng.run(reqs)
    assert len(out) == 5
    assert all(len(v) == 3 for v in out.values())


def test_latency_stamps_under_queue_backlog():
    cfg, model, params = _port("gpt2-124m")
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=3)
                    .astype(np.int32), 2) for i in range(3)]
    eng = ServingEngine(model, params, slots=1, max_seq=32)
    for r in reqs:
        assert eng.submit(r)
    while not eng.idle:
        eng.tick()
    assert [r.submit_tick for r in reqs] == [0, 0, 0]
    assert [r.admit_tick for r in reqs] == [0, 2, 4]
    assert [r.finish_tick for r in reqs] == [2, 4, 6]
    assert eng.stats.queue_wait_ticks == [0, 2, 4]
    assert eng.stats.e2e_ticks == [2, 4, 6]
    pct = eng.stats.latency_percentiles()
    assert pct["queue_wait_p50"] == 2.0
    assert pct["e2e_p50"] == 4.0
    assert pct["e2e_p99"] == pytest.approx(5.96)
    empty = ServingEngine(model, params, slots=1, max_seq=32)
    assert all(v == 0.0 for v in empty.stats.latency_percentiles().values())


# ---------------------------------------------------------------------------
# port vs the reference engine (offload off, fp32)
# ---------------------------------------------------------------------------
def _requests(cls, cfg, lens, max_new, seed=5):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), max_new)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch,attn_impl", [("llama3-8b", "xla"),
                                            ("llama3-8b", "pallas"),
                                            ("gpt2-124m", "xla")])
def test_tokens_equal_reference_engine(arch, attn_impl):
    rm, rp, pm, pp = _pair(arch, attn_impl=attn_impl)
    lens = (5, 9, 7)       # three requests over two slots: one waits its turn
    ref_eng = RefServingEngine(rm, rp, slots=2, max_seq=48)
    want = ref_eng.run(_requests(RefRequest, rm.cfg, lens, 4))
    eng = ServingEngine(pm, pp, slots=2, max_seq=48)
    got = eng.run(_requests(Request, pm.cfg, lens, 4))
    assert got == want
    assert eng.ticks == ref_eng.ticks
    for f in ("tokens_out", "prefill_tokens", "admitted", "completed",
              "truncated", "rejected", "queue_wait_ticks", "e2e_ticks"):
        assert getattr(eng.stats, f) == getattr(ref_eng.stats, f), f


def test_truncation_and_rejection_match_reference():
    rm, rp, pm, pp = _pair("gpt2-124m")
    lens = (4, 20, 6)          # 20 > max_seq-1: rejected; others evicted early
    ref_eng = RefServingEngine(rm, rp, slots=2, max_seq=12)
    want = ref_eng.run(_requests(RefRequest, rm.cfg, lens, 16))
    eng = ServingEngine(pm, pp, slots=2, max_seq=12)
    reqs = _requests(Request, pm.cfg, lens, 16)
    got = eng.run(reqs)
    assert got == want
    assert got[1] == [] and reqs[1].truncated
    assert eng.stats.truncated == ref_eng.stats.truncated == 2
    assert eng.stats.rejected == ref_eng.stats.rejected == 1
    with pytest.raises(ValueError, match="exceeds max_seq-1"):
        eng.prefill(Request(9, np.zeros(12, np.int32), 1))
    bounded = TenantEngine(pm, pp, slots=1, max_seq=12, max_queue=1)
    assert bounded.submit(Request(0, np.zeros(3, np.int32), 1))
    assert not bounded.submit(Request(1, np.zeros(3, np.int32), 1))
    assert bounded.stats.rejected == 1


# ---------------------------------------------------------------------------
# port offload on vs port offload off
# ---------------------------------------------------------------------------
def _partial_kv_plan(model, params, slots, max_seq):
    inv = model.serving_inventory(params, model.cache_shapes(slots, max_seq))
    total = sum(t.bytes for t in inv)
    embed = sum(t.bytes for t in inv if t.group == "embed")
    kv = sum(t.bytes for t in inv if t.group == "kv_cache")
    plan = plan_offload(inv, total - embed - kv // 4, spill_granule=1024)
    assert plan.partial, "test setup: expected a partial spill"
    return plan


@pytest.mark.parametrize("arch", ["llama3-8b", "gpt2-124m"])
def test_engine_equivalence_offload_on_off(arch):
    cfg, model, params = _port(arch)
    lens = (5, 30, 7, 18)
    base = TenantEngine(model, params, slots=2, max_seq=48).run(
        _requests(Request, cfg, lens, 8))
    plan = _partial_kv_plan(model, params, 2, 48)
    split = TenantEngine(model, params, slots=2, max_seq=48, plan=plan)
    assert split.pool.split_leaves, "partial plan must split a kv leaf"
    assert all(0 < n < 48 for n in split.pool.split_leaves.values())
    assert split.pool.host_bytes > 0 and split.pool.device_bytes > 0
    assert split.pool.host_bytes + split.pool.device_bytes == model.cache_bytes(2, 48)
    assert base == split.run(_requests(Request, cfg, lens, 8))
    full = TenantEngine(model, params, slots=2, max_seq=48, offload_kv=True)
    assert base == full.run(_requests(Request, cfg, lens, 8))


def test_pool_split_matches_reference_pool_decision():
    """Same plan -> same hot prefix lengths and byte split as the
    reference's KVPool (its placement needs a mesh)."""
    from repro.launch.mesh import make_host_mesh
    from repro.serving.kv_pool import KVPool as RefKVPool
    from repro.core.offload import plan_offload as ref_plan_offload
    import jax
    rm, rp, pm, pp = _pair()
    rinv = rm.serving_inventory(rp, jax.eval_shape(lambda: rm.init_cache(2, 48)))
    total = sum(t.bytes for t in rinv)
    embed = sum(t.bytes for t in rinv if t.group == "embed")
    kv = sum(t.bytes for t in rinv if t.group == "kv_cache")
    for cut in (kv // 4, kv // 2, kv // 8):
        rplan = ref_plan_offload(rinv, total - embed - cut, spill_granule=1024)
        pplan = plan_offload(pm.serving_inventory(pp, pm.cache_shapes(2, 48)),
                             total - embed - cut, spill_granule=1024)
        rpool = RefKVPool(rm, 2, 48, mesh=make_host_mesh(1, 1), plan=rplan)
        ppool = KVPool(pm, 2, 48, plan=pplan)
        assert ppool.split_leaves == rpool.split_leaves
        assert ppool.host_bytes == rpool.host_bytes
        assert ppool.device_bytes == rpool.device_bytes


def test_pool_paste_materialize_update_roundtrip():
    """paste writes each tier's rows in place; materialize/update round-trip
    through the same host buffers; values are rounded to the pool's bf16."""
    cfg, model, params = _port()
    plan = _partial_kv_plan(model, params, 2, 48)
    pools = [KVPool(model, 2, 48), KVPool(model, 2, 48, plan=plan),
             KVPool(model, 2, 48, offload_all=True)]
    hot_len = next(iter(pools[1].split_leaves.values()))
    plen = hot_len + 5                       # the prefix crosses the cut
    rng = np.random.default_rng(0)
    shape = (cfg.num_layers, 1, plen, cfg.num_kv_heads, cfg.head_dim)
    pref = {n: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for n in ("k", "v")}
    trees = []
    for pool in pools:
        assert pool.materialize()["k"].dtype == torch.bfloat16
        host_ptrs = [t.data_ptr() for t in pool.host_tensors()]
        slot = pool.alloc_slot()
        pool.paste(slot, pref, plen)
        assert pool.positions[slot] == plen
        tree = pool.materialize()
        tree["k"][:, slot, plen] = 1.0       # an in-place decode write
        pool.update(tree)
        assert [t.data_ptr() for t in pool.host_tensors()] == host_ptrs
        trees.append(pool.materialize())
        pool.free_slot(slot)
        assert pool.positions[slot] == 0 and pool.free_slots == 2
    for tree in trees[1:]:
        for n in ("k", "v"):
            assert torch.equal(tree[n], trees[0][n])
    assert torch.equal(trees[0]["v"][:, 1, :plen], pref["v"][:, 0].bfloat16())
    assert float(trees[0]["k"][:, 1, plen].float().sum()) == trees[0]["k"][:, 1, plen].numel()


def test_a_ticks_materialized_cache_dies_with_the_tick(monkeypatch):
    """With the garbage collector off, the device copies ``materialize``
    makes of host-tier leaves are freed as soon as the tick drops them: no
    reference cycle holds them (on the card each leaked tick kept the whole
    KV pool, 2.7 GB for qwen2-vl-72b, until a collection)."""
    import gc
    import weakref
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_unflatten
    from repro_torch.models.model_zoo import build_model
    model = build_model(get_config("llama3-8b").reduced(), "cpu")
    pool = KVPool(model, 2, 16, offload_all=True)
    copies = []

    def to_device(host):          # a distinct tensor, as on the card
        t = host.clone()
        copies.append(weakref.ref(t))
        return t

    monkeypatch.setattr(pool, "_to_device", to_device)
    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        cache = pool.materialize()
        assert len(copies) == 2 and all(c() is not None for c in copies)
        pool.update(cache)
        del cache
        assert all(c() is None for c in copies)
        tree = tree_unflatten({"a": None, "b": [0]}, [leaf])
        del tree, leaf
        assert ref() is None
    finally:
        if was_enabled:
            gc.enable()
