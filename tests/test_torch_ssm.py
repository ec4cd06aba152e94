"""SSM and hybrid families of the port against the reference, on the same
numpy inputs and weights (CPU, reduced configs): the SSD scan (the kernel's
plain version, the model's ``ssd_chunked``, the oracle), the Mamba2 layer,
mamba2-130m and zamba2-1.2b whole (logits, cache tree, decode, prefill ->
decode against forward, engine tokens), and the tree helpers that carry an
``SSMCache`` (plan names, conversion, pool dtypes).

Tolerances: fp32 1e-4 relative, the reference's for the SSD
(tests/test_kernels.py) and for whole models. The reference's kernel runs as ``repro.kernels.ops.ssd`` (interpret mode on
the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import model_pair, np_tree, rel_err, to_jax, to_np, to_torch
from repro.core.offload import _flatten_with_paths as ref_flat
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import ssm as ref_ssm
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefServingEngine
from repro_torch.core.offload import _flatten_with_paths as port_flat
from repro_torch.core.offload import place_tree, plan_offload
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import ssd_scan as port_ssd
from repro_torch.models import ssm as port_ssm
from repro_torch.models.convert import cache_from_numpy
from repro_torch.serving import KVPool, Request, ServingEngine, TenantEngine

_PAIRS = {}


def _pair(arch, **over):
    """``model_pair`` in fp32, built once per (arch, overrides) for the file:
    no test changes the weights."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _PAIRS:
        _PAIRS[key] = model_pair(arch, dtype="float32", **over)
    return _PAIRS[key]


SSM_ARCHS = [("mamba2-130m", {}), ("zamba2-1.2b", {}),
             ("zamba2-1.2b", {"num_layers": 5})]   # 5 layers: a tail group
ARCH_IDS = ["mamba2", "zamba2", "zamba2_tail"]


def _ssd_inputs(B, S, nh, hp, N, seed, zero_x=False):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = (0 if zero_x else 0.5) * rng.standard_normal((B, S, nh, hp))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh))))
    A = -np.exp(0.3 * rng.standard_normal(nh))
    B_ = 0.3 * rng.standard_normal((B, S, N))
    C_ = 0.3 * rng.standard_normal((B, S, N))
    return [a.astype(np.float32) for a in (x, dt, A, B_, C_)]


def _both(arrays):
    return [to_jax(a) for a in arrays], [to_torch(a) for a in arrays]


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,nh,hp,N,chunk,nhb", [
    (1, 128, 4, 32, 64, 64, 4),
    (2, 256, 8, 32, 64, 128, 4),
    (1, 128, 2, 64, 128, 32, 2),
])
def test_ssd_matches_reference_kernel_and_oracle(B, S, nh, hp, N, chunk, nhb):
    """The port's ``ops.ssd`` (on the CPU: the kernel's plain version) and
    ``ssd_ref`` against the reference's Pallas kernel and oracle."""
    j, t = _both(_ssd_inputs(B, S, nh, hp, N, seed=S + nh))
    want_kernel = ref_ops.ssd(*j, chunk=chunk, nh_block=nhb)
    want_ref = ref_ref.ssd_ref(*j)
    got = port_ops.ssd(*t, chunk=chunk, nh_block=nhb)
    got_ref = port_ref.ssd_ref(*t)
    assert got.shape == (B, S, nh, hp) and got.dtype == torch.float32
    assert rel_err(to_np(got), to_np(want_kernel)) < 1e-4
    assert rel_err(to_np(got_ref), to_np(want_ref)) < 1e-4
    assert rel_err(to_np(got), to_np(want_ref)) < 1e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssd_zero_input_is_zero(seed):
    x, dt, A, B_, _ = _ssd_inputs(1, 64, 2, 32, 64, seed, zero_x=True)
    out = port_ops.ssd(*(to_torch(a) for a in (x, dt, A, B_, B_)), chunk=32)
    assert np.allclose(to_np(out), 0.0, atol=1e-6)


@pytest.mark.parametrize("S,chunk", [(100, 32), (128, 64), (7, 128)])
def test_ssd_chunked_and_kernel_plain_match_reference_with_state(S, chunk):
    """``ssd_chunked``'s contract, which the kernel also fulfils: a ragged S
    (padded with dt = 0), a nonzero ``init_state``, (y, final_state)."""
    B, nh, hp, N = 2, 4, 16, 32
    arrays = _ssd_inputs(B, S, nh, hp, N, seed=S)
    s0 = (0.5 * np.random.default_rng(9).standard_normal((B, nh, hp, N))
          ).astype(np.float32)
    j, t = _both(arrays)
    want_y, want_s = jax.jit(ref_ssm.ssd_chunked, static_argnums=5)(
        *j, chunk, to_jax(s0))
    y, s = port_ssm.ssd_chunked(*t, chunk, init_state=to_torch(s0))
    ky, ks = port_ops.ssd(*t, chunk=chunk, init_state=to_torch(s0),
                          return_state=True)
    for got_y, got_s in ((y, s), (ky, ks)):
        assert got_y.shape == (B, S, nh, hp) and got_s.dtype == torch.float32
        assert rel_err(to_np(got_y), to_np(want_y)) < 1e-4
        assert rel_err(to_np(got_s), to_np(want_s)) < 1e-4
    # the state carries: two halves with the state handed over equal one scan
    h = S // 2
    y1, s1 = port_ops.ssd(*(a[:, :h] for a in t[:2]), t[2], t[3][:, :h],
                          t[4][:, :h], chunk=chunk, init_state=to_torch(s0),
                          return_state=True)
    y2, s2 = port_ops.ssd(*(a[:, h:] for a in t[:2]), t[2], t[3][:, h:],
                          t[4][:, h:], chunk=chunk, init_state=s1,
                          return_state=True)
    assert rel_err(to_np(torch.cat([y1, y2], 1)), to_np(want_y)) < 1e-4
    assert rel_err(to_np(s2), to_np(want_s)) < 1e-4


@pytest.mark.parametrize("B,S,nh,hp,N", [(1, 128, 4, 32, 64), (2, 256, 2, 16, 32)])
def test_chunk_parallel_steps_match_reference_kernel(B, S, nh, hp, N):
    """The kernels' decomposition in plain PyTorch (chunk states, the serial
    pass over chunks, chunk outputs), composed at their 64-token chunk,
    against the reference's Pallas kernel in interpret mode (S a multiple of
    its chunk, zero initial state)."""
    j, t = _both(_ssd_inputs(B, S, nh, hp, N, seed=7 * S + nh))
    want = ref_ops.ssd(*j, chunk=64, nh_block=2)
    x, dt, A, B_, C_ = t
    S_c, last = port_ssd.chunk_states(x, dt, A, B_)
    h_in, _ = port_ssd.pass_states(S_c, last)
    assert torch.equal(h_in[:, 0], torch.zeros_like(h_in[:, 0]))
    y = port_ssd.chunk_outputs(x, dt, A, B_, C_, h_in)
    assert y.shape == (B, S, nh, hp)
    assert rel_err(to_np(y), to_np(want)) < 1e-4


@pytest.mark.parametrize("S", [100, 65, 7, 192])
def test_chunk_parallel_steps_match_ssd_chunked_with_state(S):
    """The same steps at a ragged S (rows past S read as zero with dt = 0)
    from a nonzero initial state, against the reference's ``ssd_chunked``:
    y, the final state, and the state entering each chunk, which equals the
    reference's final state over the tokens before that chunk."""
    B, nh, hp, N = 2, 4, 16, 32
    arrays = _ssd_inputs(B, S, nh, hp, N, seed=S + 11)
    s0 = (0.5 * np.random.default_rng(10).standard_normal((B, nh, hp, N))
          ).astype(np.float32)
    j, t = _both(arrays)
    ref_scan = jax.jit(ref_ssm.ssd_chunked, static_argnums=5)
    want_y, want_s = ref_scan(*j, 64, to_jax(s0))
    x, dt, A, B_, C_ = t
    S_c, last = port_ssd.chunk_states(x, dt, A, B_)
    h_in, state = port_ssd.pass_states(S_c, last, to_torch(s0))
    y = port_ssd.chunk_outputs(x, dt, A, B_, C_, h_in)
    assert rel_err(to_np(y), to_np(want_y)) < 1e-4
    assert rel_err(to_np(state), to_np(want_s)) < 1e-4
    assert rel_err(to_np(h_in[:, 0]), s0) == 0.0
    for c in range(1, h_in.shape[1]):
        _, before = ref_scan(*(a[:, :64 * c] for a in j[:2]), j[2],
                             *(a[:, :64 * c] for a in j[3:]), 64, to_jax(s0))
        assert rel_err(to_np(h_in[:, c]), to_np(before)) < 1e-4
    gy, gs = port_ssd.ssd_scan_plain(x, dt, A, B_, C_, init_state=to_torch(s0),
                                     return_state=True)
    assert torch.equal(gy, y) and torch.equal(gs, state)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(3)
    B, nh, hp, N = 2, 4, 16, 32
    state = rng.standard_normal((B, nh, hp, N)).astype(np.float32)
    x = rng.standard_normal((B, nh, hp)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, nh))).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh)).astype(np.float32)
    Bt, Ct = (rng.standard_normal((B, N)).astype(np.float32) for _ in range(2))
    args = (state, x, dt, A, Bt, Ct)
    ws, wy = ref_ssm.ssd_decode_step(*(to_jax(a) for a in args))
    gs, gy = port_ssm.ssd_decode_step(*(to_torch(a) for a in args))
    assert rel_err(to_np(gs), to_np(ws)) < 1e-5
    assert rel_err(to_np(gy), to_np(wy)) < 1e-5


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_matches_reference(with_cache):
    rm, rp, pm, pp = _pair("mamba2-130m")
    cfg = rm.cfg
    C = cfg.d_inner + 2 * cfg.ssm_state
    rng = np.random.default_rng(4)
    S = 1 if with_cache else 9
    xbc = rng.standard_normal((2, S, C)).astype(np.float32)
    cache = rng.standard_normal((2, cfg.conv_width - 1, C)).astype(np.float32)
    rl = jax.tree_util.tree_map(lambda a: a[0], rp["layers"])
    pl = {k: v[0] for k, v in pp["layers"].items()}
    wo, wc = ref_ssm._causal_conv(cfg, rl, to_jax(xbc),
                                  to_jax(cache) if with_cache else None)
    go, gc = port_ssm._causal_conv(pm.cfg, pl, to_torch(xbc),
                                   to_torch(cache) if with_cache else None)
    assert rel_err(to_np(go), to_np(wo)) < 2e-5
    assert np.array_equal(to_np(gc), to_np(wc))


def test_apply_ssm_prefill_and_decode_on_reference_weights():
    rm, rp, pm, pp = _pair("mamba2-130m")
    cfg = rm.cfg
    rl = jax.tree_util.tree_map(lambda a: a[1], rp["layers"])
    pl = {k: v[1] for k, v in pp["layers"].items()}
    rng = np.random.default_rng(5)
    u = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    u1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    # prefill with a fresh cache (the state starts at zero: the same y as
    # without a cache)
    ref_apply = jax.jit(ref_ssm.apply_ssm, static_argnums=0)
    wy, wc = ref_apply(cfg, rl, to_jax(u),
                       ref_ssm.init_ssm_cache(cfg, 2, jnp.float32))
    gy, gc = port_ssm.apply_ssm(pm.cfg, pl, to_torch(u),
                                port_ssm.init_ssm_cache(pm.cfg, 2, torch.float32))
    assert rel_err(to_np(gy), to_np(wy)) < 1e-4
    gy0, none = port_ssm.apply_ssm(pm.cfg, pl, to_torch(u))
    assert none is None and torch.equal(gy0, gy)
    assert rel_err(to_np(gc.state), to_np(wc.state)) < 1e-4
    assert rel_err(to_np(gc.conv), to_np(wc.conv)) < 1e-5
    # decode from that cache: the port writes into the cache it is given
    wy1, wc1 = ref_apply(cfg, rl, to_jax(u1), wc)
    conv_ptr = gc.conv.data_ptr()
    gy1, gc1 = port_ssm.apply_ssm(pm.cfg, pl, to_torch(u1), gc)
    assert gc1 is gc and gc.conv.data_ptr() == conv_ptr
    assert rel_err(to_np(gy1), to_np(wy1)) < 1e-4
    assert rel_err(to_np(gc.state), to_np(wc1.state)) < 1e-4
    assert rel_err(to_np(gc.conv), to_np(wc1.conv)) < 1e-5


def test_ssd_route_raises_under_autograd():
    """The prefill SSD under autograd (it raised before SSM training was
    ported): one Mamba2 layer's gradients, of its weights and its input,
    equal the reference's ``jax.grad`` through its ``ssd_chunked`` (fp32,
    1e-4 of each leaf's largest value)."""
    rm, rp, pm, pp = _pair("mamba2-130m")
    cfg = rm.cfg
    rl = jax.tree_util.tree_map(lambda a: a[0], rp["layers"])
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)

    def ref_loss(lp, u):
        return jnp.sum(ref_ssm.apply_ssm(cfg, lp, u)[0] * to_jax(r))
    want_p, want_u = jax.grad(ref_loss, argnums=(0, 1))(rl, to_jax(u))
    # the layer's own weights (the block's pre-norm is the stack's)
    pl = {k: v[0].clone().requires_grad_() for k, v in pp["layers"].items()
          if k != "norm1_scale"}
    ut = to_torch(u).requires_grad_()
    y, _ = port_ssm.apply_ssm(pm.cfg, pl, ut)
    names = sorted(pl)
    grads = torch.autograd.grad((y * to_torch(r)).sum(), [ut] + [pl[n] for n in names])
    for got, want in zip(grads, [want_u] + [want_p[n] for n in names]):
        got, want = to_np(got), to_np(want)
        assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want)) + 1e-6


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
def _leaf_desc(flat):
    return [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in flat]


S_P, S_MAX, B = 96, 128, 2
_REF_RUNS = {}


def _ref_run(arch, over):
    """The reference's side of the whole-model rows, run once per arch:
    tokens (B, S_P + 1); the forward over the first S_P with its cache; that
    cache pasted into an fp32 pool of S_MAX; one decode of token S_P."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _REF_RUNS:
        rm, rp, _, _ = _pair(arch, **over)
        toks = np.random.default_rng(11).integers(0, rm.cfg.vocab_size,
                                                  size=(B, S_P + 1))
        # jitted: one compile is cheaper than jax's eager dispatch here
        forward = jax.jit(lambda p, b: rm.forward(p, b, return_cache=True))
        logits, _, cache = forward(rp, {"tokens": to_jax(toks[:, :S_P])})
        big = jax.tree_util.tree_map(
            lambda d, s: d.at[:, :, :S_P].set(s) if d.shape[2] == S_MAX else s,
            rm.init_cache(B, S_MAX, jnp.float32), cache)
        dec, new = jax.jit(rm.decode)(rp, big, {
            "tokens": to_jax(toks[:, S_P:]), "pos": jnp.asarray(S_P, jnp.int32)})
        _REF_RUNS[key] = (toks, logits, cache, big, dec, new)
    return _REF_RUNS[key]


@pytest.mark.parametrize("arch,over", SSM_ARCHS, ids=ARCH_IDS)
def test_model_logits_cache_tree_and_decode(arch, over):
    """Logits and the prefill cache tree (reference paths such as
    ``ssm/.conv``, shapes, dtypes, values), then one decode step from the
    reference's own cache carried across: logits and the updated cache."""
    _, _, pm, pp = _pair(arch, **over)
    toks, want, wcache, rbig, wdec, wnew = _ref_run(arch, over)
    got, aux, gcache = pm.forward(pp, {"tokens": to_torch(toks[:, :S_P])},
                                  return_cache=True)
    assert float(aux) == 0.0 and torch.isfinite(got).all()
    assert rel_err(to_np(got), to_np(want)) < 1e-4
    rflat, pflat = ref_flat(wcache), port_flat(gcache)
    assert _leaf_desc(pflat) == _leaf_desc(rflat)
    assert isinstance(gcache["ssm"], port_ssm.SSMCache)
    assert gcache["ssm"].state.dtype == torch.float32
    for (path, a), (_, b) in zip(rflat, pflat):
        assert rel_err(to_np(b), to_np(a)) < 1e-4, path
    pc = cache_from_numpy(np_tree(rbig), device="cpu")
    gdec, gnew = pm.decode(pp, pc, {"tokens": to_torch(toks[:, S_P:]),
                                    "pos": torch.tensor(S_P)})
    assert gnew is pc, "the port updates the cache in place"
    assert rel_err(to_np(gdec), to_np(wdec)) < 1e-4
    for (path, a), (_, b) in zip(ref_flat(wnew), port_flat(gnew)):
        assert rel_err(to_np(b), to_np(a)) < 1e-4, path


@pytest.mark.parametrize("arch,over", SSM_ARCHS, ids=ARCH_IDS)
def test_prefill_decode_matches_forward(arch, over):
    """The recipe of test_cache_equivalence in fp32 (model and pool):
    prefill S_P tokens, paste the port's cache into a pool of S_MAX, decode
    token S_P; equal to the reference's decode (same weights, its own pasted
    cache) and to the port's full forward over S_P + 1 tokens."""
    _, _, pm, pp = _pair(arch, **over)
    toks, _, _, _, rdec, _ = _ref_run(arch, over)
    want_full = to_np(pm.forward(pp, {"tokens": to_torch(toks)})[0][:, -1])
    _, _, pcache = pm.forward(pp, {"tokens": to_torch(toks[:, :S_P])},
                              return_cache=True)
    pbig = pm.init_cache(B, S_MAX, torch.float32)
    for (_, d), (_, s) in zip(port_flat(pbig), port_flat(pcache)):
        if d.shape[2] == S_MAX:
            d[:, :, :S_P] = s
        else:
            d.copy_(s)
    pdec, _ = pm.decode(pp, pbig, {"tokens": to_torch(toks[:, S_P:]),
                                   "pos": torch.tensor(S_P)})
    assert rel_err(to_np(pdec), to_np(rdec)) < 1e-4
    assert rel_err(to_np(pdec), want_full) < 1e-4


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _requests(cls, cfg, lens, max_new, seed=5):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), max_new)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_engine_tokens_equal_reference_engine(arch):
    """fp32, offload off; max_seq (48) differs from the SSM head count (8),
    so no state leaf reads as a sequence leaf."""
    rm, rp, pm, pp = _pair(arch)
    lens = (6, 6, 6)       # one prefill shape; the third request waits a slot
    ref_eng = RefServingEngine(rm, rp, slots=2, max_seq=48)
    want = ref_eng.run(_requests(RefRequest, rm.cfg, lens, 3))
    eng = ServingEngine(pm, pp, slots=2, max_seq=48)
    assert eng.run(_requests(Request, pm.cfg, lens, 3)) == want
    assert eng.ticks == ref_eng.ticks
    assert eng.stats.e2e_ticks == ref_eng.stats.e2e_ticks


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_split_and_pinned_pools_equal_device_pool(arch):
    _, _, pm, pp = _pair(arch)
    cfg = pm.cfg
    lens = (5, 30, 7, 18)
    base = TenantEngine(pm, pp, slots=2, max_seq=48).run(
        _requests(Request, cfg, lens, 6))
    inv = pm.serving_inventory(pp, pm.cache_shapes(2, 48))
    total = sum(t.bytes for t in inv)
    embed = sum(t.bytes for t in inv if t.group == "embed")
    kv = sum(t.bytes for t in inv if t.group == "kv_cache")
    plan = plan_offload(inv, total - embed - kv // 2, spill_granule=256)
    split = TenantEngine(pm, pp, slots=2, max_seq=48, plan=plan)
    assert split.pool.host_bytes > 0
    assert split.pool.host_bytes + split.pool.device_bytes == pm.cache_bytes(2, 48)
    assert split.run(_requests(Request, cfg, lens, 6)) == base
    full = TenantEngine(pm, pp, slots=2, max_seq=48, offload_kv=True)
    assert full.run(_requests(Request, cfg, lens, 6)) == base
    state = dict(port_flat(full.pool.materialize()))["ssm/.state"]
    assert state.dtype == torch.float32


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_serving_inventory_names_and_bytes_equal_reference(arch):
    """Plan names of an SSM cache are the reference's (``kv/ssm/.conv``,
    ``kv/ssm/.state``), bytes at each leaf's dtype (the state fp32)."""
    rm, rp, pm, pp = _pair(arch)
    rinv = rm.serving_inventory(rp, jax.eval_shape(lambda: rm.init_cache(2, 48)))
    pinv = pm.serving_inventory(pp, pm.cache_shapes(2, 48))
    assert [(t.name, t.bytes, t.group) for t in pinv] == \
        [(t.name, t.bytes, t.group) for t in rinv]
    names = {t.name for t in pinv}
    assert {"kv/ssm/.conv", "kv/ssm/.state"} <= names
    assert pm.cache_bytes(2, 48) == rm.cache_bytes(2, 48)


def test_pool_pastes_whole_state_when_heads_equal_max_seq():
    """A pool whose ``max_seq`` equals the SSM head count (8 reduced): the
    state ``(L, slots, heads, hp, N)`` has ``max_seq`` in its sequence
    position, yet only ``k``/``v`` carry a sequence axis, so a prefill
    overwrites the slot's whole state. Two requests of different lengths
    through one slot give the tokens a fresh engine gives each alone. The
    reference classifies by shape and would paste only the first ``plen``
    heads (leaving the previous request's state in the rest), so the port is
    held to itself here."""
    _, _, pm, pp = _pair("mamba2-130m")
    max_seq = pm.cfg.ssm_heads
    assert tuple(pm.cache_shapes(1, max_seq)["ssm"].state.shape)[2] == max_seq
    reqs = _requests(Request, pm.cfg, (5, 3), 2)
    shared = ServingEngine(pm, pp, slots=1, max_seq=max_seq).run(reqs)
    for r in _requests(Request, pm.cfg, (5, 3), 2):
        alone = ServingEngine(pm, pp, slots=1, max_seq=max_seq).run([r])
        assert shared[r.rid] == alone[r.rid], r.rid


def test_cache_from_numpy_gives_the_ports_ssm_cache():
    rm, rp, _, _ = _pair("zamba2-1.2b")
    ref_cache = rm.init_cache(2, 16)
    assert type(ref_cache["ssm"]).__name__ == "SSMCache"
    got = cache_from_numpy(np_tree(ref_cache), device="cpu")
    assert isinstance(got["ssm"], port_ssm.SSMCache)
    assert tuple(got["ssm"].state.shape) == tuple(ref_cache["ssm"].state.shape)
    assert got["ssm"].state.dtype == torch.float32


def test_bf16_pool_keeps_state_fp32_and_pastes_whole_slots():
    _, _, pm, pp = _pair("mamba2-130m")
    pool = KVPool(pm, 2, 48, dtype=torch.bfloat16)
    tree = pool.materialize()
    assert isinstance(tree["ssm"], port_ssm.SSMCache)
    assert tree["ssm"].state.dtype == torch.float32
    assert tree["ssm"].conv.dtype == torch.bfloat16
    # a prefill state with more precision than bf16 keeps it in the pool
    _, _, pc = pm.forward(pp, {"tokens": torch.arange(1, 10)[None]},
                          return_cache=True)
    slot = pool.alloc_slot()
    pool.paste(slot, pc, 9)
    got = pool.materialize()["ssm"]
    assert torch.equal(got.state[:, slot:slot + 1], pc["ssm"].state)
    assert torch.equal(got.conv[:, slot:slot + 1], pc["ssm"].conv.bfloat16())
    assert float(got.state[:, 1 - slot].abs().sum()) == 0.0
    assert pm.cache_bytes(2, 48) == sum(
        t.numel() * t.element_size() for _, t in port_flat(tree))


def test_place_tree_keeps_ssm_cache_and_names_its_fields():
    """place_tree walks NamedTuples by field (``.state``) and rebuilds them."""
    _, _, pm, _ = _pair("mamba2-130m")
    cache = pm.init_cache(1, 8)
    inv = pm.serving_inventory({}, cache)
    plan = plan_offload(inv, 0)
    assert "kv/ssm/.state" in plan.offloaded
    placed = place_tree({"kv": cache}, plan, "cpu")["kv"]
    assert isinstance(placed["ssm"], port_ssm.SSMCache)
    assert [p for p, _ in port_flat(placed)] == ["ssm/.conv", "ssm/.state"]
