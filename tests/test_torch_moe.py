"""MoE family of the port against the reference, on the same numpy inputs and
weights (CPU, reduced granite-moe-1b-a400m and phi3.5-moe-42b-a6.6b, fp32):
the grouped matmul (the kernel's plain version and ``gmm_ref`` against the
reference's Pallas kernel in interpret mode), routing, capacity dispatch
with drops, the group-split rule, the MoE layer, whole models (logits, aux
loss, prefill -> decode, engine tokens) and the loss with its gradients.

Tolerances: the reference's own (tests/test_kernels.py, tests/test_train.py)
— grouped matmul fp32 1e-5, whole models and gradients 1e-4 relative to the
largest value. Dispatch decisions (expert ids, slots, the token of each
capacity slot) must match exactly; the inputs are seeded draws with no
near-ties among the router's top-k. A ``SliceRuntime`` tenant of reduced
phi3.5-moe whose plan spills the table, the KV pool and the gate expert
stack (the plan the card's ``moe_full`` phase serves at full size) gives
the reference engine's tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import model_pair, np_tree, rel_err, to_jax, to_np, to_torch
from repro.core.offload import _flatten_with_paths as ref_flat
from repro.data import pipeline as ref_pipeline
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import moe as ref_moe
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefServingEngine
from repro_torch.core.offload import _flatten_with_paths as port_flat
from repro_torch.kernels import grouped_matmul as port_gmm
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref
from repro_torch.models import moe as port_moe
from repro_torch.models.common import weight_matmul
from repro_torch.models import model_zoo as port_zoo
from repro_torch.models.convert import cache_from_numpy
from repro_torch.serving import Request, SliceRuntime, TenantEngine, TenantSpec
from repro_torch.train.train_step import _accumulate_grads

ARCHS = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"]
_PAIRS = {}


def _pair(arch, **over):
    """``model_pair`` in fp32, built once per (arch, overrides) for the file:
    no test changes the weights."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _PAIRS:
        _PAIRS[key] = model_pair(arch, dtype="float32", **over)
    return _PAIRS[key]


def _layer(rp, pp, i=0):
    return ({k: v[i] for k, v in rp["layers"].items()},
            {k: v[i] for k, v in pp["layers"].items()})


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the kernel's function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("E,C,d,f", [(2, 128, 128, 128), (4, 256, 128, 384),
                                     (1, 128, 256, 128)])
def test_gmm_matches_reference_kernel(E, C, d, f):
    """The shapes of tests/test_kernels.py::test_gmm_matches_ref: the
    reference's Pallas kernel (interpret mode) against ``gmm_ref`` and the
    wrapper on CPU tensors (its plain version; no launch)."""
    x, w = _x((E, C, d), 4), _x((E, d, f), 5)
    want = ref_ops.grouped_matmul(to_jax(x), to_jax(w))
    assert rel_err(to_np(ref_ref.gmm_ref(to_jax(x), to_jax(w))), to_np(want)) < 1e-5
    assert rel_err(to_np(port_ref.gmm_ref(to_torch(x), to_torch(w))), to_np(want)) < 1e-5
    launches = port_gmm.grouped_matmul.launches
    got = port_ops.grouped_matmul(to_torch(x), to_torch(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (E, C, f)
    assert rel_err(to_np(got), to_np(want)) < 1e-5
    assert port_gmm.grouped_matmul.launches == launches


def test_gmm_shared_x_ragged_and_checks():
    """An x shared by every expert (expert stride 0, the decode path) and
    ragged sizes give the per-expert product; bad inputs raise."""
    x, w = _x((1, 5, 33), 6), _x((3, 33, 7), 7)
    xs = to_torch(x).expand(3, 5, 33)
    assert xs.stride(0) == 0
    want = np.einsum("cd,edf->ecf", x[0], w)
    assert rel_err(to_np(port_ops.grouped_matmul(xs, to_torch(w))), want) < 1e-6
    assert rel_err(to_np(weight_matmul(xs, to_torch(w))), want) < 1e-6
    with pytest.raises(ValueError):
        port_ops.grouped_matmul(to_torch(x), to_torch(w))           # E differs
    with pytest.raises(ValueError):
        port_ops.grouped_matmul(xs[..., :32], to_torch(w))          # d differs
    with pytest.raises(TypeError):
        port_ops.grouped_matmul(xs.half(), to_torch(w))


@pytest.mark.parametrize("E,K,block_k,want", [
    (32, 1024, 2048, (2, 1024)), (32, 512, 2048, (4, 512)),
    (16, 4096, 2048, (1, 2048)), (3, 700, 2048, (2, 700)), (2, 10, 100, (2, 10))])
def test_streamed_panel_shape(E, K, block_k, want):
    """A pinned stack streams as many whole experts a panel as fit
    ``block_k`` rows, else ``block_k`` rows of one expert."""
    assert port_gmm.panel_shape(E, K, block_k) == want


_BF, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("case,want", [
    # granite-moe's decode (one shared x) and w_out: 64 x 64 wgmma tiles
    (dict(E=32, M=4, K=1024, N=512, xs=(0, 1024), ws=(524288, 512)),
     ("wgmma", 64, 64, 0, 0)),
    (dict(E=32, M=4, K=512, N=1024, xs=(2048, 512), ws=(524288, 1024)),
     ("wgmma", 64, 64, 0, 0)),
    (dict(E=32, M=64, K=512, N=1024, xs=(32768, 512), ws=(524288, 1024)),
     ("wgmma", 64, 64, 0, 0)),
    # its 1024-token prefill (capacity 320): 128 x 128 tiles
    (dict(E=32, M=320, K=1024, N=512, xs=(327680, 1024), ws=(524288, 512)),
     ("wgmma", 128, 128, 0, 0)),
    (dict(E=1, M=65, K=64, N=8, xs=(4160, 64), ws=(512, 8)),
     ("wgmma", 128, 128, 0, 0)),
    # "nk": w's row stride is K
    (dict(E=4, M=8, K=64, N=100, xs=(512, 64), ws=(6400, 64), nk=True),
     ("wgmma", 64, 64, 0, 0)),
    # strides TMA cannot take (not multiples of 8 elements), a misaligned
    # base, a w in fp32: mma.sync
    (dict(E=5, M=77, K=100, N=96, xs=(7700, 100), ws=(9600, 96)),
     ("mma_sync", 0, 0, 0, 0)),
    (dict(E=5, M=77, K=200, N=96, xs=(15400, 200), ws=(19200, 100)),
     ("mma_sync", 0, 0, 0, 0)),
    (dict(E=3, M=33, K=72, N=56, xs=(0, 72), ws=(4032, 56), aligned=False),
     ("mma_sync", 0, 0, 0, 0)),
    (dict(E=2, M=4, K=64, N=64, xs=(256, 64), ws=(4096, 64), wdt=_F32),
     ("mma_sync", 0, 0, 0, 0)),
    # fp32 x: exact FMA, whatever the strides
    (dict(E=2, M=4, K=63, N=64, xs=(252, 63), ws=(4032, 64), xdt=_F32),
     ("fma", 0, 0, 0, 0)),
    # pinned w: read from the dense ring slot, so w's own strides do not
    # matter, the slot's do; panels of whole experts, or of block_k rows
    (dict(E=32, M=4, K=1024, N=512, xs=(0, 1024), ws=(7, 9), host=True),
     ("wgmma", 64, 64, 8, 1024)),
    (dict(E=32, M=4, K=1024, N=512, xs=(0, 1024), ws=(7, 9), host=True,
          block_k=1024), ("wgmma", 64, 64, 1, 1024)),
    (dict(E=2, M=4, K=200, N=96, xs=(800, 200), ws=(7, 9), host=True,
          block_k=64), ("wgmma", 64, 64, 1, 64)),
    (dict(E=2, M=4, K=200, N=96, xs=(800, 200), ws=(7, 9), host=True,
          block_k=60), ("mma_sync", 0, 0, 1, 60)),
    (dict(E=2, M=4, K=200, N=100, xs=(800, 200), ws=(7, 9), host=True),
     ("mma_sync", 0, 0, 2, 200)),
    (dict(E=2, M=4, K=200, N=100, xs=(800, 200), ws=(7, 9), host=True,
          nk=True), ("wgmma", 64, 64, 2, 200)),
    (dict(E=2, M=4, K=204, N=96, xs=(816, 204), ws=(7, 9), host=True,
          nk=True, xdt=_F32), ("fma", 0, 0, 2, 204)),
])
def test_plan_routes_by_shape_and_alignment(case, want):
    """The wrapper's choice of kernel, tile and panel for a call, made before
    launch by a stated rule: bf16 operands that a TMA descriptor can take
    (16-byte-aligned bases, strides in multiples of 8 elements) take wgmma
    on 64 x 64 tiles up to 64 rows and 128 x 128 above; other bf16 x takes
    mma.sync, fp32 x the FMA kernel; a pinned w streams in the panels of
    ``panel_shape``."""
    c = {**dict(nk=False, aligned=True, host=False, xdt=_BF, wdt=_BF,
                block_k=port_gmm.BLOCK_K), **case}
    got = port_gmm.plan(c["E"], c["M"], c["K"], c["N"], c["xdt"], c["wdt"],
                        c["xs"], c["ws"], c["nk"], c["aligned"], c["host"],
                        c["block_k"])
    assert tuple(got) == want
    assert got.route in port_gmm.ROUTES
    if c["host"]:
        assert (got.panel_experts, got.panel_k) == port_gmm.panel_shape(
            c["E"], c["K"], c["block_k"])


@pytest.mark.parametrize("case,want", [
    # granite-moe's dw at 8 x 1024 tokens: x^T of the (32, 2560, 1024) buffer
    (dict(M=1024, K=2560, N=512, xs=(2621440, 1024), ws=(1310720, 512)),
     ("wgmma", 128, 128, 0, 0)),
    (dict(M=64, K=77, N=96, xs=(4928, 64), ws=(7392, 96)),
     ("wgmma", 64, 64, 0, 0)),
    # what the transposed A cannot take: fp32, "nk" w, a shared x, strides
    # that are not multiples of 8, a misaligned base, a pinned w
    (dict(M=64, K=64, N=64, xs=(4096, 64), ws=(4096, 64), xdt=_F32), None),
    (dict(M=64, K=64, N=64, xs=(4096, 64), ws=(4096, 64), nk=True), None),
    (dict(M=64, K=64, N=64, xs=(0, 64), ws=(4096, 64)), None),
    (dict(M=64, K=77, N=96, xs=(4928, 77), ws=(7392, 96)), None),
    (dict(M=64, K=64, N=64, xs=(4096, 64), ws=(4096, 64), aligned=False), None),
    (dict(M=64, K=64, N=64, xs=(4096, 64), ws=(7, 9), host=True), None),
])
def test_plan_routes_transposed_x(case, want):
    """An x given as its transpose (the backward's x^T, M contiguous) takes
    the wgmma route with A's transpose bit, on the usual tiles, when the
    operands are bf16, w is "kn" on the card and TMA can describe both;
    ``plan`` raises otherwise, and ``takes_transposed_x`` says so before
    (``transposed_x`` then copies x dense)."""
    c = {**dict(E=4, nk=False, aligned=True, host=False, xdt=_BF, wdt=_BF),
         **case}
    args = (c["xdt"], c["wdt"], c["xs"], c["ws"], c["nk"], c["aligned"],
            c["host"])
    assert port_gmm.takes_transposed_x(*args) == (want is not None)
    call = lambda: port_gmm.plan(c["E"], c["M"], c["K"], c["N"], c["xdt"],
                                 c["wdt"], c["xs"], c["ws"], c["nk"],
                                 c["aligned"], c["host"], port_gmm.BLOCK_K,
                                 x_t=True)
    if want is None:
        with pytest.raises(ValueError, match="transposed x"):
            call()
    else:
        assert tuple(call()) == want


def test_x_layout_and_transposed_x_on_cpu():
    """x's layout by strides: a unit last-dim stride, or (x_t) a unit stride
    along M; on the CPU ``transposed_x`` is the view, for the plain
    product."""
    x = torch.randn(3, 5, 8)
    assert port_gmm._x_layout(x) == (40, 8, 0)
    xt = port_gmm.transposed_x(x, torch.randn(3, 5, 2))
    assert xt.data_ptr() == x.data_ptr() and port_gmm._x_layout(xt) == (40, 8, 1)
    with pytest.raises(ValueError, match="unit stride"):
        port_gmm._x_layout(torch.randn(3, 8, 10)[:, ::2, ::2])


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    rm, rp, pm, pp = _pair(arch)
    rl, pl = _layer(rp, pp, 1)
    x = _x((2, 24, pm.cfg.d_model), 8)
    rw, re_ = ref_moe.route(rm.cfg, rl, to_jax(x))
    pw, pe = port_moe.route(pm.cfg, pl, to_torch(x))
    assert pw.dtype == torch.float32
    assert np.array_equal(to_np(pe), np.asarray(re_))
    assert rel_err(to_np(pw), to_np(rw)) < 1e-5
    assert np.allclose(to_np(pw).sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_dispatch_group_matches_reference_slot_for_slot(arch, capacity_factor):
    """A capacity factor of 0.5 drops a share of the assignments; every
    output of the per-group dispatch equals the reference's exactly."""
    rm, rp, pm, pp = _pair(arch)
    rcfg = rm.cfg.with_(capacity_factor=capacity_factor)
    pcfg = pm.cfg.with_(capacity_factor=capacity_factor)
    rl, pl = _layer(rp, pp)
    S = 40
    x = _x((S, pm.cfg.d_model), 9)
    rw, re_ = ref_moe.route(rcfg, rl, to_jax(x))
    C = ref_moe.capacity(rcfg, S)
    assert port_moe.capacity(pcfg, S) == C
    want = ref_moe._dispatch_group(rcfg, to_jax(x), rw, re_, C)
    got = port_moe._dispatch_group(pcfg, to_torch(x), to_torch(to_np(rw)),
                                   to_torch(np.asarray(re_)).long(), C)
    gathered, slot_token, keep_w, slot = (to_np(t) for t in got)
    assert np.array_equal(gathered, to_np(want[0]))
    assert np.array_equal(slot_token, np.asarray(want[1]))
    assert np.array_equal(keep_w, to_np(want[2]))
    assert np.array_equal(slot, np.asarray(want[3]))
    dropped = int((slot == pcfg.num_experts * C).sum())
    assert (dropped > 0) == (capacity_factor < 1), dropped
    assert np.all(keep_w[slot == pcfg.num_experts * C] == 0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,gs", [(32, 8), (24, 16), (16, 16), (1, 4)],
                         ids=["split", "no_split_ragged", "equal", "decode"])
def test_apply_moe_group_split_rule(arch, S, gs):
    """``apply_moe`` at a small ``moe_group_size``: S > gs with S % gs == 0
    routes each gs-slice as its own group (own capacity); a ragged or equal S
    stays one group; S == 1 takes the dense decode path. Drops included.
    The routing each path returns gives the aux loss of routing anew."""
    rm, rp, pm, pp = _pair(arch)
    rl, pl = _layer(rp, pp)
    rcfg, pcfg = rm.cfg.with_(moe_group_size=gs), pm.cfg.with_(moe_group_size=gs)
    x = _x((2, S, pm.cfg.d_model), 10 + S)
    want = jax.jit(lambda p, x: ref_moe.apply_moe(rcfg, p, x))(rl, to_jax(x))
    got, probs, top_e = port_moe.apply_moe(pcfg, pl, to_torch(x))
    assert rel_err(to_np(got), to_np(want)) < 1e-5
    aux = float(port_moe.load_balance_loss(pcfg, pl, to_torch(x)))
    assert abs(float(port_moe.balance_loss(pcfg, probs, top_e)) - aux) < 1e-6
    whole = port_moe._apply_moe_grouped(pcfg, pl, to_torch(x))[0] if S > 1 else None
    if S > gs and S % gs == 0:     # the split changes capacities and drops
        assert rel_err(to_np(whole), to_np(want)) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_load_balance_loss_matches_reference(arch):
    rm, rp, pm, pp = _pair(arch)
    rl, pl = _layer(rp, pp)
    x = _x((2, 24, pm.cfg.d_model), 11)
    want = float(ref_moe.load_balance_loss(rm.cfg, rl, to_jax(x)))
    got = float(port_moe.load_balance_loss(pm.cfg, pl, to_torch(x)))
    assert abs(got - want) <= 1e-5 * abs(want)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
S_P, S_MAX, B = 48, 64, 2
_REF_RUNS = {}


def _ref_run(arch, over):
    """The reference's side, run once per (arch, overrides): tokens
    (B, S_P + 1); the forward over the first S_P with its aux and cache; that
    cache pasted into an fp32 pool of S_MAX; one decode of token S_P."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _REF_RUNS:
        rm, rp, _, _ = _pair(arch, **over)
        toks = np.random.default_rng(12).integers(0, rm.cfg.vocab_size,
                                                  size=(B, S_P + 1))
        forward = jax.jit(lambda p, b: rm.forward(p, b, return_cache=True))
        logits, aux, cache = forward(rp, {"tokens": to_jax(toks[:, :S_P])})
        big = jax.tree_util.tree_map(
            lambda d, s: d.at[:, :, :S_P].set(s),
            rm.init_cache(B, S_MAX, jnp.float32), cache)
        dec, new = jax.jit(rm.decode)(rp, big, {
            "tokens": to_jax(toks[:, S_P:]), "pos": jnp.asarray(S_P, jnp.int32)})
        _REF_RUNS[key] = (toks, logits, aux, cache, big, dec, new)
    return _REF_RUNS[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_aux_cache_and_decode(arch):
    """At the configs' own capacity factor (1.25, so prefill drops tokens):
    logits, the aux loss summed over layers, the cache tree (reference paths,
    shapes, values), then one decode step from the reference's own cache."""
    _, _, pm, pp = _pair(arch)
    toks, want, waux, wcache, rbig, wdec, wnew = _ref_run(arch, {})
    got, aux, gcache = pm.forward(pp, {"tokens": to_torch(toks[:, :S_P])},
                                  return_cache=True)
    assert rel_err(to_np(got), to_np(want)) < 1e-4
    assert float(waux) > 0 and abs(float(aux) - float(waux)) <= 1e-5 * float(waux)
    rflat, pflat = ref_flat(wcache), port_flat(gcache)
    assert [(p, tuple(x.shape)) for p, x in pflat] == \
        [(p, tuple(x.shape)) for p, x in rflat]
    for (path, a), (_, b) in zip(rflat, pflat):
        assert rel_err(to_np(b), to_np(a)) < 1e-4, path
    pc = cache_from_numpy(np_tree(rbig), device="cpu")
    gdec, gnew = pm.decode(pp, pc, {"tokens": to_torch(toks[:, S_P:]),
                                    "pos": torch.tensor(S_P)})
    assert gnew is pc, "the port updates the cache in place"
    assert rel_err(to_np(gdec), to_np(wdec)) < 1e-4
    for (path, a), (_, b) in zip(ref_flat(wnew), port_flat(gnew)):
        assert rel_err(to_np(b), to_np(a)) < 1e-4, path


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The recipe of test_cache_equivalence (``capacity_factor=8.0``, so no
    token is dropped and the dense decode equals the dispatched forward):
    prefill S_P, paste into a pool of S_MAX, decode token S_P; equal to the
    reference's decode and to the port's full forward over S_P + 1."""
    over = {"capacity_factor": 8.0}
    _, _, pm, pp = _pair(arch, **over)
    toks, _, _, _, _, rdec, _ = _ref_run(arch, over)
    want_full = to_np(pm.forward(pp, {"tokens": to_torch(toks)})[0][:, -1])
    _, _, pcache = pm.forward(pp, {"tokens": to_torch(toks[:, :S_P])},
                              return_cache=True)
    pbig = pm.init_cache(B, S_MAX, torch.float32)
    for name in ("k", "v"):
        pbig[name][:, :, :S_P] = pcache[name]
    pdec, _ = pm.decode(pp, pbig, {"tokens": to_torch(toks[:, S_P:]),
                                   "pos": torch.tensor(S_P)})
    assert rel_err(to_np(pdec), to_np(rdec)) < 1e-4
    assert rel_err(to_np(pdec), want_full) < 1e-4


def _requests(cls, cfg, lens, max_new, seed=5):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), max_new)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_reference_engine(arch):
    """fp32, offload off, at the configs' capacity factor (1.25)."""
    rm, rp, pm, pp = _pair(arch)
    lens = (12, 12, 12)    # one prefill shape; the third request waits a slot
    ref_eng = RefServingEngine(rm, rp, slots=2, max_seq=40)
    want = ref_eng.run(_requests(RefRequest, rm.cfg, lens, 3))
    eng = TenantEngine(pm, pp, slots=2, max_seq=40)
    assert eng.run(_requests(Request, pm.cfg, lens, 3)) == want
    assert eng.ticks == ref_eng.ticks
    assert eng.stats.e2e_ticks == ref_eng.stats.e2e_ticks


def test_runtime_tenant_spilling_the_gate_stack_equals_reference_engine(
        monkeypatch):
    """Reduced phi3.5-moe through ``SliceRuntime.add_tenant`` (fp32, the
    reference's weights) under a budget of its resident bytes: the plan is
    the full-size one's, the table, the KV pool and ``layers/w_gate`` on the
    host, and the tokens and ticks are the reference ``ServingEngine``'s."""
    rm, rp, pm, pp = _pair("phi3.5-moe-42b-a6.6b")
    port_init = port_zoo.Model.init

    def init(self, generator=None, *, abstract=False, placement=None):
        if abstract:
            return port_init(self, abstract=True)
        return pp, {}
    monkeypatch.setattr(port_zoo.Model, "init", init)
    slots, max_seq, lens = 2, 40, (12, 12, 12)
    inv = pm.serving_inventory(pp, pm.cache_shapes(slots, max_seq))
    sizes = {t.name: t.bytes for t in inv}
    host = ("params/tok_embed", "kv/k", "kv/v", "params/layers/w_gate")
    rt = SliceRuntime(device="cpu")
    tenant = rt.add_tenant(TenantSpec(
        "moe", pm.cfg, profile="1s.16c", slots=slots, max_seq=max_seq,
        hbm_budget=sum(sizes.values()) - sum(sizes[n] for n in host)))
    assert set(tenant.plan.offloaded) == set(host) and tenant.plan.partial == ()
    assert tenant.params is pp
    rt.submit("moe", _requests(Request, pm.cfg, lens, 3))
    rt.run()
    ref_eng = RefServingEngine(rm, rp, slots=slots, max_seq=max_seq)
    assert tenant.engine.outputs == ref_eng.run(
        _requests(RefRequest, rm.cfg, lens, 3))
    assert tenant.engine.ticks == ref_eng.ticks


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Model.loss_fn (cross-entropy + 0.01 x the summed aux loss) and every
    gradient leaf on the plain route, against jax.value_and_grad."""
    rm, rp, pm, pp = _pair(arch)
    arr = ref_pipeline.SyntheticSource(rm.cfg.vocab_size, seed=13).batch(0, 2, 33)
    batch = {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
    r_loss, r_grads = jax.jit(jax.value_and_grad(rm.loss_fn))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _accumulate_grads(pm, pp, {k: to_torch(v) for k, v in batch.items()}, 1)
    assert abs(float(loss) - float(r_loss)) <= 1e-5 * abs(float(r_loss))
    want = dict(ref_flat(np_tree(r_grads)))
    got = dict(port_flat(grads))
    assert sorted(got) == sorted(want)
    assert {"layers/router", "layers/w_in", "layers/w_gate", "layers/w_out"} <= set(got)
    for name in want:
        g, w = to_np(got[name]), to_np(want[name])
        assert np.max(np.abs(g - w)) <= 1e-4 * np.max(np.abs(w)) + 1e-6, name


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_inventory_and_cache_equal_reference(arch):
    """Plan names, bytes and groups of params and the dense KV cache are the
    reference's; the expert stacks are plain ``param`` leaves."""
    rm, rp, pm, pp = _pair(arch)
    rinv = rm.serving_inventory(rp, jax.eval_shape(lambda: rm.init_cache(2, 48)))
    pinv = pm.serving_inventory(pp, pm.cache_shapes(2, 48))
    assert [(t.name, t.bytes, t.group) for t in pinv] == \
        [(t.name, t.bytes, t.group) for t in rinv]
    groups = {t.name: t.group for t in pinv}
    assert groups["params/layers/w_gate"] == "param"
    assert {n for n, g in groups.items() if g == "kv_cache"} == {"kv/k", "kv/v"}
    assert pm.cache_bytes(2, 48) == rm.cache_bytes(2, 48)
