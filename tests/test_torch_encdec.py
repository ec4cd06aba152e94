"""The encoder-decoder family of the port (whisper-large-v3, reduced) against
the reference on the same numpy inputs and weights (CPU).

Tolerances, the repo's: fp32 1e-4 relative for whole models and stacks of
layers, 1e-5 for single layer functions; bf16 2e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import (ENV, model_pair, np_tree, rel_err, to_jax, to_np,
                         to_torch)
from repro.models import attention as ref_attn
from repro.models import encdec as ref_encdec
from repro_torch.models import attention as port_attn
from repro_torch.models import encdec as port_encdec
from repro_torch.models.convert import cache_from_numpy

ARCH = "whisper-large-v3"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S = 2, 24


def _batch(cfg, seed, S=S, B=B):
    rng = np.random.default_rng(seed)
    return {"frames": (0.02 * rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, size=(B, S))}


def _ref(batch):
    return {k: to_jax(v) for k, v in batch.items()}


def _port(batch):
    return {k: to_torch(v) for k, v in batch.items()}


def _layer0(rp, pp, child):
    return (jax.tree_util.tree_map(lambda a: a[0], rp[child]),
            {k: w[0] for k, w in pp[child].items()})


# ---------------------------------------------------------------------------
# the encoder and the decoder layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(TOL))
def test_encode_matches_reference(dtype):
    rm, rp, pm, pp = model_pair(ARCH, dtype=dtype)
    frames = _batch(rm.cfg, 0)["frames"]
    want = ref_encdec.encode(rm.cfg, rp, to_jax(frames), rm.env, rm.pol)
    got = port_encdec.encode(pm.cfg, pp, to_torch(frames))
    assert got.shape == (B, rm.cfg.encoder_seq, rm.cfg.d_model)
    assert str(got.dtype) == f"torch.{dtype}"
    assert rel_err(to_np(got), to_np(want)) < TOL[dtype]


def _dec_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((B, cfg.encoder_seq, cfg.num_kv_heads,
                               cfg.head_dim)).astype(np.float32)
          for _ in range(2)]
    return x, kv


def test_cross_attention_matches_reference():
    rm, rp, pm, pp = model_pair(ARCH, dtype="float32")
    rl, pl = _layer0(rp, pp, "decoder")
    x, (ek, ev) = _dec_inputs(rm.cfg, 1)
    want = ref_attn.cross_attention(rm.cfg, rl, to_jax(x), to_jax(ek), to_jax(ev))
    got = port_attn.cross_attention(pm.cfg, pl, to_torch(x), to_torch(ek),
                                    to_torch(ev))
    assert rel_err(to_np(got), to_np(want)) < 1e-5
    # one query row (the decode's shape) takes the single-pass route
    want1 = ref_attn.cross_attention(rm.cfg, rl, to_jax(x[:, :1]), to_jax(ek),
                                     to_jax(ev))
    got1 = port_attn.cross_attention(pm.cfg, pl, to_torch(x[:, :1]),
                                     to_torch(ek), to_torch(ev))
    assert rel_err(to_np(got1), to_np(want1)) < 1e-5


def test_dec_layer_matches_reference():
    rm, rp, pm, pp = model_pair(ARCH, dtype="float32")
    rl, pl = _layer0(rp, pp, "decoder")
    x, (ek, ev) = _dec_inputs(rm.cfg, 2)
    positions = np.arange(S)[None, :]
    want, (wk, wv) = ref_encdec._dec_layer(rm.cfg, rl, to_jax(x),
                                           to_jax(positions), to_jax(ek),
                                           to_jax(ev))
    got, (gk, gv) = port_encdec._dec_layer(pm.cfg, pl, to_torch(x),
                                           to_torch(positions), to_torch(ek),
                                           to_torch(ev))
    assert rel_err(to_np(got), to_np(want)) < 1e-5
    assert rel_err(to_np(gk), to_np(wk)) < 1e-5
    assert rel_err(to_np(gv), to_np(wv)) < 1e-5


# ---------------------------------------------------------------------------
# whole model: forward, decode, loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_forward_logits_and_cache(attn_impl, dtype):
    rm, rp, pm, pp = model_pair(ARCH, dtype=dtype, attn_impl=attn_impl)
    batch = _batch(rm.cfg, 3)
    want, _, wcache = rm.forward(rp, _ref(batch), return_cache=True)
    got, aux, gcache = pm.forward(pp, _port(batch), return_cache=True)
    assert got.shape == (B, S, rm.cfg.vocab_size) and float(aux) == 0.0
    assert torch.isfinite(got.float()).all()
    assert rel_err(to_np(got), to_np(want)) < TOL[dtype]
    assert list(gcache) == ["k", "v", "cross_k", "cross_v"]
    for name in gcache:
        assert tuple(gcache[name].shape) == tuple(wcache[name].shape), name
        assert rel_err(to_np(gcache[name]), to_np(wcache[name])) < TOL[dtype], name
    assert gcache["cross_k"].shape[2] == rm.cfg.encoder_seq
    last, _, none = pm.forward(pp, _port(batch), last_token_only=True)
    assert none is None and last.shape == (B, 1, rm.cfg.vocab_size)
    assert rel_err(to_np(last[:, 0]), to_np(want[:, -1])) < TOL[dtype]


def test_decode_matches_reference_on_the_same_pasted_cache():
    """The reference's prefill cache pasted into its bf16 pool of S_MAX, the
    same pool carried across: one decode step gives the reference's logits
    and self-attention cache, writes the self cache in place and leaves the
    cross leaves as they were."""
    S_P, S_MAX = S, 40
    rm, rp, pm, pp = model_pair(ARCH, dtype="float32", seed=4)
    batch = _batch(rm.cfg, 5, S=S_P + 1)
    pre = {"frames": batch["frames"], "tokens": batch["tokens"][:, :S_P]}
    _, _, rc = rm.forward(rp, _ref(pre), return_cache=True)
    big = rm.init_cache(B, S_MAX)
    big = jax.tree_util.tree_map(
        lambda d, s: (d.at[:, :, :S_P].set(s.astype(d.dtype))
                      if d.shape[2] == S_MAX else s.astype(d.dtype)), big, rc)
    pcache = cache_from_numpy(np_tree(big), device="cpu", dtype="bfloat16")
    cross_before = pcache["cross_k"].clone()
    nxt = batch["tokens"][:, S_P:S_P + 1]
    want, wnew = rm.decode(rp, big, {"tokens": to_jax(nxt),
                                     "pos": jnp.asarray(S_P, jnp.int32)})
    got, gnew = pm.decode(pp, pcache, {"tokens": to_torch(nxt),
                                       "pos": torch.tensor(S_P)})
    assert gnew["k"] is pcache["k"], "the port updates the cache in place"
    assert rel_err(to_np(got), to_np(want)) < 1e-4
    for name in ("k", "v"):
        assert rel_err(to_np(gnew[name]), to_np(wnew[name])) < 1e-4
    assert torch.equal(gnew["cross_k"], cross_before)
    # and the port's own full forward over S_P + 1 tokens
    full, _, _ = pm.forward(pp, _port(batch))
    assert rel_err(to_np(got), to_np(full[:, -1])) < 2e-2


def test_loss_matches_reference_and_reaches_the_encoder():
    rm, rp, pm, pp = model_pair(ARCH, dtype="float32", seed=6)
    batch = _batch(rm.cfg, 7)
    batch["labels"] = np.random.default_rng(8).integers(
        0, rm.cfg.vocab_size, size=(B, S))
    want = float(rm.loss_fn(rp, _ref(batch)))
    for leaf in (pp["encoder"]["wq"], pp["decoder"]["cross_wk"]):
        leaf.requires_grad_(True)
    got = pm.loss_fn(pp, _port(batch))
    assert got.requires_grad
    assert abs(got.item() - want) <= 1e-4 * abs(want)
    got.backward()
    for leaf in (pp["encoder"]["wq"], pp["decoder"]["cross_wk"]):
        assert leaf.grad is not None and float(leaf.grad.abs().sum()) > 0


def test_loss_and_grads_match_reference():
    """Model.loss_fn and every gradient leaf, encoder, cross attention and
    decoder, against jax.value_and_grad (fp32, 1e-4 of each leaf's largest
    value plus 1e-6, the atol of the key biases whose gradient is zero in
    exact arithmetic)."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.train_step import _accumulate_grads
    rm, rp, pm, pp = model_pair(ARCH, dtype="float32", seed=6)
    batch = _batch(rm.cfg, 7)
    batch["labels"] = np.random.default_rng(8).integers(
        0, rm.cfg.vocab_size, size=(B, S))
    want_loss, want = jax.value_and_grad(rm.loss_fn)(rp, _ref(batch))
    loss, grads = _accumulate_grads(pm, pp, _port(batch), 1)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = list(tree_leaves(grads))
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g, w = to_np(g), to_np(w)
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) <= 1e-4 * np.max(np.abs(w)) + 1e-6


# ---------------------------------------------------------------------------
# the pool and the init tree
# ---------------------------------------------------------------------------
def test_kv_pool_pastes_cross_leaves_whole():
    """With ``max_seq`` other than ``encoder_seq`` the pool keeps the cross
    leaves whole: a pasted request's cross K/V hold all encoder frames, its
    self K/V the prompt's rows; decoding two requests of different lengths
    together (per-row ``pos``) gives each one's decode alone."""
    from repro_torch.serving.kv_pool import KVPool
    _, _, pm, pp = model_pair(ARCH, dtype="float32", seed=9)
    cfg = pm.cfg
    max_seq = cfg.encoder_seq + 16
    pool = KVPool(pm, 2, max_seq, dtype=torch.float32)
    assert dict(zip(pool._paths, pool._seq)) == {
        "cross_k": False, "cross_v": False, "k": True, "v": True}
    lens = [5, 17]
    batch = _batch(cfg, 10, S=max(lens) + 1)
    by_slot = {}
    for row, n in enumerate(lens):
        one = {"frames": batch["frames"][row:row + 1],
               "tokens": batch["tokens"][row:row + 1, :n]}
        _, _, pc = pm.forward(pp, _port(one), return_cache=True)
        slot = pool.alloc_slot()
        pool.paste(slot, pc, n)
        cache = pool.materialize()
        for name in ("cross_k", "cross_v"):
            assert torch.equal(cache[name][:, slot:slot + 1], pc[name])
        assert torch.equal(cache["k"][:, slot:slot + 1, :n], pc["k"])
        assert float(cache["k"][:, slot, n:].abs().sum()) == 0
        tok = batch["tokens"][row:row + 1, n:n + 1]
        alone = pm.init_cache(1, max_seq, torch.float32)
        for name in alone:
            alone[name][:, :, :pc[name].shape[2]] = pc[name]
        by_slot[slot] = (tok, pm.decode(pp, alone, {"tokens": to_torch(tok),
                                                    "pos": torch.tensor(n)})[0])
    toks = np.concatenate([by_slot[s][0] for s in range(2)])
    logits, _ = pm.decode(pp, pool.materialize(), {
        "tokens": to_torch(toks), "pos": torch.as_tensor(pool.positions)})
    for s in range(2):
        assert rel_err(to_np(logits[s]), to_np(by_slot[s][1][0])) < 1e-5


def test_kv_pool_keeps_cross_leaves_whole_when_max_seq_is_encoder_seq():
    """A pool whose ``max_seq`` equals ``encoder_seq`` still takes only the
    self K/V for sequence leaves: every cross frame survives ``paste``, and
    the first decode step equals the one from a pool of another ``max_seq``
    (1e-5, fp32)."""
    from repro_torch.serving.kv_pool import KVPool
    _, _, pm, pp = model_pair(ARCH, dtype="float32", seed=12)
    cfg = pm.cfg
    n = 5
    batch = _batch(cfg, 13, S=n + 1, B=1)
    _, _, pc = pm.forward(pp, _port({"frames": batch["frames"],
                                     "tokens": batch["tokens"][:, :n]}),
                          return_cache=True)
    firsts = []
    for max_seq in (cfg.encoder_seq, cfg.encoder_seq + 16):
        pool = KVPool(pm, 2, max_seq, dtype=torch.float32)
        assert dict(zip(pool._paths, pool._seq)) == {
            "cross_k": False, "cross_v": False, "k": True, "v": True}
        slot = pool.alloc_slot()
        pool.paste(slot, pc, n)
        cache = pool.materialize()
        for name in ("cross_k", "cross_v"):
            assert cache[name].shape[2] == cfg.encoder_seq
            assert torch.equal(cache[name][:, slot:slot + 1], pc[name])
        tok = np.repeat(batch["tokens"][:, n:n + 1], 2, axis=0)
        logits, _ = pm.decode(pp, cache, {"tokens": to_torch(tok),
                                          "pos": torch.as_tensor(pool.positions)})
        firsts.append(to_np(logits[slot]))
    assert rel_err(firsts[0], firsts[1]) < 1e-5


def test_init_tree_matches_reference():
    """Paths, shapes and dtypes of the reduced init equal the reference's;
    at full size ``init(abstract=True)`` gives the reference's abstract tree
    as meta tensors (1,621,516,800 parameters)."""
    from repro_torch.core.offload import _flatten_with_paths as port_flat
    from repro.core.offload import _flatten_with_paths as ref_flat
    from repro.configs import get_config as ref_get_config
    from repro.models.model_zoo import build_model as ref_build_model
    from repro_torch.configs import get_config as port_get_config
    from repro_torch.models.model_zoo import build_model as port_build_model
    _, rp, pm, _ = model_pair(ARCH, perturb=False)
    params, roles = pm.init(torch.Generator().manual_seed(0))
    want = [(p, tuple(a.shape), str(a.dtype)) for p, a in ref_flat(rp)]
    assert [(p, tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for p, a in port_flat(params)] == want
    # the partition specs on one device: d_fsdp on "data", none on "model"
    assert roles["decoder"]["cross_wq"] == (None, "data", None)
    assert roles["encoder"]["enc_final_scale"] == (None,)
    rfull, _ = ref_build_model(ref_get_config(ARCH), ENV).init(
        None, abstract=True)
    pfull, _ = port_build_model(port_get_config(ARCH), "cpu").init(abstract=True)
    flat = port_flat(pfull)
    assert all(t.device.type == "meta" for _, t in flat)
    assert [(p, tuple(a.shape)) for p, a in flat] == \
        [(p, tuple(a.shape)) for p, a in ref_flat(rfull)]
    assert sum(t.numel() for _, t in flat) == 1_621_516_800

