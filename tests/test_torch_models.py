"""Layers, attention and whole models of the port against the reference, on
the same numpy inputs and weights (CPU, reduced configs).

Tolerances: fp32 1e-4 relative for whole models (different summation order
through two layers), 2e-5 for single functions; bf16 2e-2 (bf16 roundings
fall at different places in the two frameworks)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import (model_pair, np_tree, rel_err, to_jax, to_np,
                         to_torch)
from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro_torch import configs as port_configs
from repro_torch.models import attention as port_attn
from repro_torch.models import layers as port_layers
from repro_torch.models.convert import cache_from_numpy
from test_cache_equivalence import ARCHS as CACHE_ARCHS

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ref_configs.ALL_ARCHS)
def test_configs_equal_reference(arch):
    r, p = ref_configs.get_config(arch), port_configs.get_config(arch)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    assert dataclasses.asdict(r.reduced()) == dataclasses.asdict(p.reduced())
    assert r.param_count() == p.param_count()
    assert port_configs.ALL_ARCHS == ref_configs.ALL_ARCHS


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3-8b", "gpt2-124m"])
@pytest.mark.parametrize("dtype", list(DT))
def test_apply_norm(arch, dtype):
    jdt, tdt = DT[dtype]
    rcfg = ref_configs.get_config(arch).reduced()
    pcfg = port_configs.get_config(arch).reduced()
    rng = _rng(0)
    x = rng.standard_normal((2, 5, rcfg.d_model)).astype(np.float32) * 3 + 1
    p = {"n_scale": (1 + 0.1 * rng.standard_normal(rcfg.d_model)).astype(np.float32),
         "n_bias": (0.1 * rng.standard_normal(rcfg.d_model)).astype(np.float32)}
    want = ref_layers.apply_norm(rcfg, {k: to_jax(a) for k, a in p.items()},
                                 "n", to_jax(x, jdt))
    got = port_layers.apply_norm(pcfg, {k: to_torch(a) for k, a in p.items()},
                                 "n", to_torch(x, tdt))
    assert got.dtype == tdt
    assert rel_err(to_np(got), to_np(want)) < (2e-5 if dtype == "float32" else 2e-2)


def test_rms_norm_vec():
    rng = _rng(1)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    want = ref_layers.rms_norm_vec(to_jax(x), to_jax(s), 1e-5)
    got = port_layers.rms_norm_vec(to_torch(x), to_torch(s), 1e-5)
    assert rel_err(to_np(got), to_np(want)) < 2e-5


@pytest.mark.parametrize("positions", ["row", "per_row"])
def test_apply_rope(positions):
    rng = _rng(2)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = (np.arange(7)[None, :] if positions == "row"
           else np.array([[3], [50]]) + np.arange(7)[None, :])
    want = ref_layers.apply_rope(to_jax(x), to_jax(pos), 500_000.0)
    got = port_layers.apply_rope(to_torch(x), to_torch(pos), 500_000.0)
    assert rel_err(to_np(got), to_np(want)) < 2e-5


@pytest.mark.parametrize("arch", ["llama3-8b", "gpt2-124m"])
def test_apply_mlp(arch):
    """SwiGLU without biases (llama) and tanh-GELU with biases (gpt2)."""
    rcfg = ref_configs.get_config(arch).reduced().with_(dtype="float32")
    pcfg = port_configs.get_config(arch).reduced().with_(dtype="float32")
    rng = _rng(3)
    d, f = rcfg.d_model, rcfg.d_ff
    p = {"w_in": rng.standard_normal((d, f)) / 8, "w_gate": rng.standard_normal((d, f)) / 8,
         "w_out": rng.standard_normal((f, d)) / 8, "b_in": rng.standard_normal(f),
         "b_gate": rng.standard_normal(f), "b_out": rng.standard_normal(d)}
    p = {k: a.astype(np.float32) for k, a in p.items()}
    x = (2 * rng.standard_normal((2, 5, d))).astype(np.float32)
    want = ref_layers.apply_mlp(rcfg, {k: to_jax(a) for k, a in p.items()}, to_jax(x))
    got = port_layers.apply_mlp(pcfg, {k: to_torch(a) for k, a in p.items()}, to_torch(x))
    assert rel_err(to_np(got), to_np(want)) < 2e-5


@pytest.mark.parametrize("arch", ["llama3-8b", "gpt2-124m"])
def test_embed_and_unembed(arch):
    rm, rp, pm, pp = model_pair(arch, dtype="float32")
    toks = _rng(4).integers(0, rm.cfg.vocab_size, size=(2, 6))
    pos = np.array([[2], [9]]) + np.arange(6)[None, :]
    want = ref_layers.embed_tokens(rm.cfg, rp, to_jax(toks), to_jax(pos))
    got = port_layers.embed_tokens(pm.cfg, pp, to_torch(toks), to_torch(pos))
    assert rel_err(to_np(got), to_np(want)) < 1e-6
    x = _rng(5).standard_normal((2, 3, rm.cfg.d_model)).astype(np.float32)
    want = ref_layers.unembed(rm.cfg, rp, to_jax(x))
    got = port_layers.unembed(pm.cfg, pp, to_torch(x))
    assert rel_err(to_np(got), to_np(want)) < 2e-5


# ---------------------------------------------------------------------------
# attention functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["causal", "q_offset", "kv_len_scalar",
                                  "kv_len_rows", "ragged_chunk", "bf16"])
def test_chunked_flash_attention(case):
    rng = _rng(6)
    B, Sq, Sk, H, hd = 2, 40, 40, 2, 16
    kw, jdt, tdt, tol = dict(causal=True, chunk=16), jnp.float32, torch.float32, 2e-5
    if case == "q_offset":
        Sq, Sk, kw = 8, 48, dict(causal=True, q_offset=40, chunk=16)
    elif case == "kv_len_scalar":
        Sq, kw = 1, dict(causal=False, kv_len=np.int32(23), chunk=16)
    elif case == "kv_len_rows":
        Sq, kw = 1, dict(causal=False, kv_len=np.array([5, 31], np.int32), chunk=16)
    elif case == "ragged_chunk":
        kw = dict(causal=True, chunk=24)          # 40 = 24 + 16: padded tail
    elif case == "bf16":
        jdt, tdt, tol = jnp.bfloat16, torch.bfloat16, 2e-2
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
    jkw = {n: (to_jax(a) if isinstance(a, np.ndarray) else a) for n, a in kw.items()}
    tkw = {n: (to_torch(a) if isinstance(a, np.ndarray) else a) for n, a in kw.items()}
    want = ref_attn.flash_attention(*(to_jax(t, jdt) for t in (q, k, v)), **jkw)
    got = port_attn.flash_attention(*(to_torch(t, tdt) for t in (q, k, v)), **tkw)
    assert got.shape == (B, Sq, H, hd)
    assert rel_err(to_np(got), to_np(want)) < tol


def test_flash_attention_fully_masked_rows_stay_finite():
    """kv_len = 0 for one row: the reference yields zeros, so does the port."""
    rng = _rng(7)
    q, k, v = (rng.standard_normal((2, 1, 2, 16)).astype(np.float32),
               rng.standard_normal((2, 8, 2, 16)).astype(np.float32),
               rng.standard_normal((2, 8, 2, 16)).astype(np.float32))
    kvl = np.array([0, 3], np.int32)
    want = ref_attn.flash_attention(to_jax(q), to_jax(k), to_jax(v),
                                    causal=False, kv_len=to_jax(kvl))
    got = port_attn.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                                    causal=False, kv_len=to_torch(kvl))
    assert torch.isfinite(got).all()
    assert np.abs(to_np(got) - to_np(want)).max() < 2e-5


@pytest.mark.parametrize("case", ["fp32", "bf16", "fp32_q_bf16_cache",
                                  "kv_len_scalar", "no_kv_len", "gqa_direct"])
def test_decode_attention(case):
    rng = _rng(8)
    B, Sk, H, hd = 3, 24, 4, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
    kvl = np.array([1, 24, 9], np.int32)
    qd = cd = "float32"
    tol = 2e-5
    if case == "bf16":
        qd = cd = "bfloat16"
        tol = 2e-2
    elif case == "fp32_q_bf16_cache":
        cd, tol = "bfloat16", 2e-2      # p is rounded to the cache dtype
    elif case == "kv_len_scalar":
        kvl = np.int32(7)
    elif case == "no_kv_len":
        kvl = None
    jq, jk, jv = to_jax(q, DT[qd][0]), to_jax(k, DT[cd][0]), to_jax(v, DT[cd][0])
    tq, tk, tv = to_torch(q, DT[qd][1]), to_torch(k, DT[cd][1]), to_torch(v, DT[cd][1])
    want = ref_attn.decode_attention(
        jq, jk, jv, kv_len=None if kvl is None else to_jax(np.asarray(kvl)))
    if case == "gqa_direct":
        # the port contracts GQA groups without expanding: 2 KV heads feed 4
        # query heads; the reference sees the expanded heads
        k2, v2 = k[:, :, :2], v[:, :, :2]
        want = ref_attn.decode_attention(
            jq, ref_attn.expand_kv(to_jax(k2), H), ref_attn.expand_kv(to_jax(v2), H),
            kv_len=to_jax(kvl))
        tk, tv = to_torch(k2), to_torch(v2)
    got = port_attn.decode_attention(
        tq, tk, tv, kv_len=None if kvl is None else to_torch(np.asarray(kvl)))
    assert got.dtype == tq.dtype and got.shape == (B, 1, H, hd)
    assert rel_err(to_np(got), to_np(want)) < tol


def test_expand_kv():
    k = _rng(9).standard_normal((2, 5, 2, 4)).astype(np.float32)
    assert np.array_equal(to_np(port_attn.expand_kv(to_torch(k), 8)),
                          to_np(ref_attn.expand_kv(to_jax(k), 8)))
    t = to_torch(k)
    assert port_attn.expand_kv(t, 2) is t


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ["llama3-8b", "gpt2-124m"])
def test_model_logits_and_prefill_cache(arch, attn_impl, dtype):
    tol = 1e-4 if dtype == "float32" else 2e-2
    rm, rp, pm, pp = model_pair(arch, dtype=dtype, attn_impl=attn_impl)
    toks = _rng(10).integers(0, rm.cfg.vocab_size, size=(2, 64))
    want, _, wcache = rm.forward(rp, {"tokens": to_jax(toks)}, return_cache=True)
    got, aux, gcache = pm.forward(pp, {"tokens": to_torch(toks)}, return_cache=True)
    assert got.shape == (2, 64, rm.cfg.vocab_size) and got.dtype == DT[dtype][1]
    assert float(aux) == 0.0
    assert torch.isfinite(got).all()
    assert rel_err(to_np(got), to_np(want)) < tol
    for name in ("k", "v"):
        assert tuple(gcache[name].shape) == tuple(wcache[name].shape)
        assert rel_err(to_np(gcache[name]), to_np(wcache[name])) < tol
    last, _, none = pm.forward(pp, {"tokens": to_torch(toks)}, last_token_only=True)
    assert none is None and last.shape == (2, 1, rm.cfg.vocab_size)
    assert rel_err(to_np(last[:, 0]), to_np(want[:, -1])) < tol


@pytest.mark.parametrize("dtype", list(DT))
def test_phi3_mini_layer_at_head_dim_96_through_the_flash_route(dtype,
                                                                monkeypatch):
    """One phi3-mini layer at a reduced width with its head dim kept at 96
    (the only arch that has it), ``attn_impl="pallas"``: logits and the
    prefill cache against the reference's, whose Pallas kernel runs in
    interpret mode; every causal prefill goes through the port's flash
    wrapper (its plain version on the CPU, the kernel on the card)."""
    from repro_torch.kernels import ops as kops
    tol = 1e-4 if dtype == "float32" else 2e-2
    rm, rp, pm, pp = model_pair("phi3-mini-3.8b", dtype=dtype,
                                attn_impl="pallas", num_layers=1, head_dim=96)
    assert pm.cfg.head_dim == 96 and pm.cfg.num_layers == 1
    calls = []
    real = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda q, k, v, **kw: calls.append(q.shape[-1])
                        or real(q, k, v, **kw))
    toks = _rng(96).integers(0, rm.cfg.vocab_size, size=(2, 128))
    want, _, wcache = rm.forward(rp, {"tokens": to_jax(toks)}, return_cache=True)
    got, _, gcache = pm.forward(pp, {"tokens": to_torch(toks)}, return_cache=True)
    assert calls == [96]
    assert torch.isfinite(got).all()
    assert rel_err(to_np(got), to_np(want)) < tol
    for name in ("k", "v"):
        assert tuple(gcache[name].shape)[-1] == 96
        assert rel_err(to_np(gcache[name]), to_np(wcache[name])) < tol


S_P, S_MAX, B = 96, 128, 2


def _cache_batch(cfg, seed):
    """Inputs of S_P + 1 positions by family, as the reference's
    ``test_cache_equivalence`` draws them: ``tokens``; ``frames`` + ``tokens``
    (encoder-decoder); ``embeds`` + ``positions`` (VLM)."""
    rng = _rng(seed)
    if cfg.family == "vlm":
        return {"embeds": (0.02 * rng.standard_normal(
                    (B, S_P + 1, cfg.d_model))).astype(np.float32),
                "positions": rng.integers(0, S_P + 1, size=(3, B, S_P + 1))}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S_P + 1))}
    if cfg.family == "encdec":
        batch["frames"] = (0.02 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return batch


def _cut(batch, lo, hi):
    """The positions lo:hi of every input that has a sequence axis."""
    out = dict(batch)
    for name in ("tokens", "embeds"):
        if name in out:
            out[name] = batch[name][:, lo:hi]
    if "positions" in out:
        out["positions"] = batch["positions"][:, :, lo:hi]
    return out


def _paste(big, pref):
    """A prefill cache into a pool of S_MAX: sequence leaves in their first
    S_P rows, the rest (SSM states, encoder-decoder cross K/V) whole."""
    from repro_torch.models.common import tree_leaves
    for d, s in zip(tree_leaves(big), tree_leaves(pref)):
        if d.dim() >= 3 and d.shape[2] == S_MAX and s.shape[2] == S_P:
            d[:, :, :S_P] = s.to(d.dtype)
        else:
            d.copy_(s.to(d.dtype))


def _ref_prefill_decode(rm, rp, full, dtype):
    pre, step = _cut(full, 0, S_P), _cut(full, S_P, S_P + 1)
    step.pop("frames", None)
    _, _, cache = rm.forward(rp, {k: to_jax(v) for k, v in pre.items()},
                             return_cache=True)
    big = jax.tree_util.tree_map(
        lambda d, s: (d.at[:, :, :S_P].set(s.astype(d.dtype))
                      if d.ndim >= 3 and d.shape[2] == S_MAX and s.shape[2] == S_P
                      else s.astype(d.dtype)),
        rm.init_cache(B, S_MAX, dtype), cache)
    return rm.decode(rp, big, {**{k: to_jax(v) for k, v in step.items()},
                               "pos": jnp.asarray(S_P, jnp.int32)})[0]


def _port_prefill_decode(pm, pp, full, dtype):
    """Prefill S_P positions, paste into a pool of S_MAX in ``dtype``, decode
    position S_P. Returns (logits, the pool)."""
    pre, step = _cut(full, 0, S_P), _cut(full, S_P, S_P + 1)
    step.pop("frames", None)
    _, _, cache = pm.forward(pp, {k: to_torch(v) for k, v in pre.items()},
                             return_cache=True)
    big = pm.init_cache(B, S_MAX, dtype)
    _paste(big, cache)
    logits, new = pm.decode(pp, big, {**{k: to_torch(v) for k, v in step.items()},
                                      "pos": torch.tensor(S_P)})
    assert new is big, "the port updates the cache in place"
    return logits, big


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The recipe of test_cache_equivalence, over its archs: prefill S_P
    positions, paste the cache into a pool of S_MAX, decode position S_P.
    With bf16 activations and pool the port's decode logits must equal its
    own full forward (the reference's tolerance 0.02); with fp32 activations
    and pool they must equal the reference's decode logits on the same
    weights and inputs (1e-4; compared in bf16 the two frameworks round at
    different places, which puts the reduced zamba2's decode logits past
    2e-2 apart). MoE runs at capacity factor 8 (no drops)."""
    _, _, pm, pp = model_pair(arch, seed=1, capacity_factor=8.0)
    full = _cache_batch(pm.cfg, 11)
    pdec, pbig = _port_prefill_decode(pm, pp, full, torch.bfloat16)
    want = pm.forward(pp, {k: to_torch(v) for k, v in full.items()})[0][:, -1]
    assert rel_err(to_np(pdec), to_np(want)) < 2e-2
    if "k" in pbig:  # the new token's KV landed at position S_P and nowhere else
        assert pbig["k"].dtype == torch.bfloat16
        assert float(pbig["k"][:, :, S_P].float().abs().sum()) > 0
        assert float(pbig["k"][:, :, S_P + 1:].float().abs().sum()) == 0

    rm, rp, pm, pp = model_pair(arch, seed=1, capacity_factor=8.0,
                                dtype="float32")
    rdec = _ref_prefill_decode(rm, rp, full, jnp.float32)
    pdec, _ = _port_prefill_decode(pm, pp, full, torch.float32)
    assert rel_err(to_np(pdec), to_np(rdec)) < 1e-4


# Every arch of CACHE_ARCHS, zamba2-1.2b included: its SSM conv takes the
# reference's bf16 silu (``layers.silu``, held to ``jax.nn.silu`` bit for bit
# by test_silu_matches_jax_bit_for_bit); with ``F.silu`` there its decode was
# 2.22e-2 apart.
BF16_DECODE_ARCHS = list(CACHE_ARCHS)


@pytest.mark.parametrize("arch", BF16_DECODE_ARCHS)
def test_bf16_prefill_decode_matches_reference(arch):
    """The served path, in bf16 activations and pool: the port's prefill ->
    decode logits against the reference's on the same weights and inputs,
    at the bf16 tolerance 2e-2. MoE runs at capacity factor 8 (no drops)."""
    rm, rp, pm, pp = model_pair(arch, seed=1, capacity_factor=8.0)
    full = _cache_batch(pm.cfg, 11)
    rdec = _ref_prefill_decode(rm, rp, full, jnp.bfloat16)
    pdec, _ = _port_prefill_decode(pm, pp, full, torch.bfloat16)
    assert rel_err(to_np(pdec), to_np(rdec)) < 2e-2


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_silu_matches_jax_bit_for_bit(dtype):
    """``layers.silu`` equals ``jax.nn.silu`` bit for bit on a seeded grid of
    200,000 values (N(0, 4)) in bf16 and fp16 (every step rounded to the
    input's dtype, as XLA does); fp32 keeps ``F.silu``, within 1 ulp
    (a relative 2.5e-7)."""
    v = _rng(5).normal(0.0, 2.0, size=200_000).astype(np.float32)
    xt = torch.from_numpy(v).to(getattr(torch, dtype))
    want = np.asarray(jax.nn.silu(jnp.asarray(xt.float().numpy()).astype(dtype))
                      .astype(jnp.float32))
    got = port_layers.silu(xt).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1e-30)
    else:
        assert np.array_equal(got, want)


def test_learned_positions_past_the_table_read_nan_as_the_reference():
    """gpt2's learned positions at a step longer than its table (1024 rows at
    full size; 8 here): the reference's ``jnp.take`` reads NaN rows past the
    table (JAX's "fill" mode) and the port's ``take_rows`` the same, where
    ``table[idx]`` raised (on the card a device-side assert)."""
    rm, rp, pm, pp = model_pair("gpt2-124m", seed=2, dtype="float32",
                                max_position=8)
    toks = _rng(4).integers(0, rm.cfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = to_np(ref_layers.embed_tokens(rm.cfg, rp, to_jax(toks)))
    got = to_np(port_layers.embed_tokens(pm.cfg, pp, to_torch(toks)))
    assert np.isnan(want[:, 8:]).all() and np.isnan(got[:, 8:]).all()
    assert not np.isnan(got[:, :8]).any()
    assert rel_err(got[:, :8], want[:, :8]) < 1e-6


def test_ragged_decode_matches_reference_and_scalar_decode():
    """Per-row cache positions from a reference-made cache carried across:
    port ragged decode == reference ragged decode == port per-row scalar."""
    rm, rp, pm, pp = model_pair("llama3-8b", seed=3, dtype="float32")
    toks = _rng(12).integers(0, rm.cfg.vocab_size, size=(2, 48))
    lens = [16, 32]
    cache = rm.init_cache(2, 64, jnp.float32)
    for b, L in enumerate(lens):
        _, _, pc = rm.forward(rp, {"tokens": to_jax(toks[b:b + 1, :L])}, return_cache=True)
        cache = jax.tree_util.tree_map(
            lambda d, s, b=b, L=L: d.at[:, b:b + 1, :L].set(s), cache, pc)
    nxt = np.stack([toks[0, 16:17], toks[1, 32:33]])
    want, wnew = rm.decode(rp, cache, {"tokens": to_jax(nxt),
                                       "pos": jnp.asarray(lens, jnp.int32)})
    pcache = cache_from_numpy(np_tree(cache), device="cpu")
    scalar_in = {n: t.clone() for n, t in pcache.items()}
    got, gnew = pm.decode(pp, pcache, {"tokens": to_torch(nxt),
                                       "pos": torch.tensor(lens)})
    assert rel_err(to_np(got), to_np(want)) < 1e-4
    for name in ("k", "v"):
        assert rel_err(to_np(gnew[name]), to_np(wnew[name])) < 1e-4
    for b, L in enumerate(lens):
        c1 = {n: t[:, b:b + 1].clone() for n, t in scalar_in.items()}
        single, _ = pm.decode(pp, c1, {"tokens": to_torch(nxt[b:b + 1]),
                                       "pos": torch.tensor(L)})
        assert rel_err(to_np(single[0]), to_np(got[b])) < 1e-4


def test_unported_families_say_which_roadmap_item():
    """Every family of the reference is ported: the init of MoE (queue A
    item 10), encoder-decoder and VLM (item 11) gives the reference's tree,
    paths and shapes, with the reference's partition specs of the new
    leaves (one device: the d_fsdp dim on "data", nothing on "model")."""
    from repro_torch.core.offload import _flatten_with_paths as port_flat
    from repro.core.offload import _flatten_with_paths as ref_flat
    for arch, leaf, spec in (
            ("granite-moe-1b-a400m", ("layers", "w_gate"),
             (None, None, "data", None)),
            ("whisper-large-v3", ("decoder", "cross_wk"),
             (None, "data", None)),
            ("qwen2-vl-72b", ("layers", "wq"), (None, "data", None))):
        rm, rp, pm, _ = model_pair(arch, perturb=False)
        params, specs = pm.init(torch.Generator().manual_seed(0))
        assert [(p, tuple(a.shape)) for p, a in port_flat(params)] == \
            [(p, tuple(a.shape)) for p, a in ref_flat(rp)], arch
        _, rspecs = rm.init(None, abstract=True)
        assert specs[leaf[0]][leaf[1]] == spec == tuple(
            rspecs[leaf[0]][leaf[1]]), arch


def test_init_names_shapes_and_scales_match_reference():
    """Same tree paths, shapes and dtypes as the reference's init; the
    port's own seeded init has the reference's scales (std within 5%)."""
    from repro_torch.core.offload import _flatten_with_paths as port_flat
    from repro.core.offload import _flatten_with_paths as ref_flat
    for arch in ("llama3-8b", "gpt2-124m", "mamba2-130m", "zamba2-1.2b"):
        rm, rp, pm, _ = model_pair(arch, perturb=False)
        params, roles = pm.init(torch.Generator().manual_seed(0))
        rflat, pflat = ref_flat(rp), port_flat(params)
        assert [p for p, _ in rflat] == [p for p, _ in pflat]
        assert set(roles) == set(params) and set(roles["layers"]) == set(params["layers"])
        # the partition specs on one device: d_fsdp on "data", none on "model"
        if "wq" in roles["layers"]:
            assert roles["layers"]["wq"] == (None, "data", None)
        else:
            assert roles["layers"]["in_zx"] == (None, "data", None)
        if "shared" in roles:
            assert roles["shared"]["wq"] == ("data", None)
        for (path, a), (_, b) in zip(rflat, pflat):
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
            if b.numel() >= 4096 and float(b.float().std()) > 0:
                ratio = float(b.float().std()) / float(np.std(to_np(a)))
                assert 0.95 < ratio < 1.05, (path, ratio)
        abstract, _ = pm.init(abstract=True)
        assert all(t.device.type == "meta" for _, t in port_flat(abstract))


def test_cuda_without_a_card_raises():
    from repro_torch.models.model_zoo import build_model
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(port_configs.get_config("gpt2-124m").reduced())
