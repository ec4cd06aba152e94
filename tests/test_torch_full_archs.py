"""starcoder2-7b and command-r-35b at their own head ratios, against the
reference on the same numpy weights and inputs (CPU).

``reduced()`` cuts every config to at most 4 query heads over 2 KV heads, so
the prefill -> decode gate of ``test_torch_models.py`` never reaches
starcoder2's GQA group of 9 (36 heads over 4 KV heads) or command-r's group
of 8 (64 over 8). Here both keep their head counts, at head dim 16, 2 layers
and ``d_model = heads x 16``: the grouped ``expand_kv`` of the prefill, the
``(B, Sq, KV, G, hd)`` contraction of ``decode_attention``, and command-r's
unembedding through its tied token table. Greedy decoding from a prefill
must give the reference's tokens exactly in fp32 (every step's logits within
1e-4); in bf16 both sides are fed the reference's tokens and every step's
logits must agree within 2e-2 (the roundings fall at different places).

At full size, ``Model.init(abstract=True)`` must count the reference's
parameters, and the bf16 weights with a 4 x 2,048 KV pool must fit the
card's 80 GiB, the serving phases of ``chip_smoke.py`` being what runs them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import ENV, model_pair, rel_err, to_jax, to_np, to_torch
from repro.configs import get_config as ref_get_config
from repro.models.model_zoo import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.models.common import tree_leaves
from repro_torch.models.model_zoo import build_model

HEADS = {"starcoder2-7b": (36, 4), "command-r-35b": (64, 8)}
HEAD_DIM, B, S_P, S_MAX, STEPS = 16, 2, 48, 64, 4
CARD_BYTES = 80 << 30


def _pair(arch, dtype, attn_impl):
    heads, kv = HEADS[arch]
    return model_pair(arch, seed=3, dtype=dtype, attn_impl=attn_impl,
                      num_heads=heads, num_kv_heads=kv, head_dim=HEAD_DIM,
                      d_model=heads * HEAD_DIM)


def _ref_side(rm, rp, dtype):
    def prefill(prompt):
        logits, _, cache = rm.forward(rp, {"tokens": to_jax(prompt)},
                                      return_cache=True)
        pool = jax.tree_util.tree_map(
            lambda d, s: d.at[:, :, :S_P].set(s.astype(d.dtype)),
            rm.init_cache(B, S_MAX, dtype), cache)
        return logits[:, -1], pool

    def decode(pool, tok, pos):
        return rm.decode(rp, pool, {"tokens": to_jax(tok[:, None]),
                                    "pos": jnp.asarray(pos, jnp.int32)})
    return prefill, decode


def _port_side(pm, pp, dtype):
    def prefill(prompt):
        logits, _, cache = pm.forward(pp, {"tokens": to_torch(prompt)},
                                      return_cache=True)
        pool = pm.init_cache(B, S_MAX, dtype)
        for name in ("k", "v"):
            pool[name][:, :, :S_P] = cache[name].to(dtype)
        return logits[:, -1], pool

    def decode(pool, tok, pos):
        logits, new = pm.decode(pp, pool, {"tokens": to_torch(tok[:, None]),
                                           "pos": torch.tensor(pos)})
        assert new is pool, "the port updates the cache in place"
        return logits, new
    return prefill, decode


def _greedy(side, prompt, forced=None):
    """Prefill ``prompt``, then STEPS - 1 decode steps. Each step's token is
    the argmax of the logits before it, or ``forced[i]``. Returns the tokens
    (STEPS, B) and the logits of every step (STEPS, B, vocab)."""
    prefill, decode = side
    logits, pool = prefill(prompt)
    toks, out = [], [to_np(logits)]
    for i in range(STEPS):
        tok = np.argmax(out[-1], axis=-1) if forced is None else forced[i]
        toks.append(tok)
        if i < STEPS - 1:
            logits, pool = decode(pool, tok, S_P + i)
            out.append(to_np(logits))
    return np.stack(toks), np.stack(out)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", sorted(HEADS))
def test_full_head_ratio_greedy_decode_matches_reference_fp32(arch, attn_impl):
    rm, rp, pm, pp = _pair(arch, "float32", attn_impl)
    assert (pm.cfg.num_heads // pm.cfg.num_kv_heads
            == HEADS[arch][0] // HEADS[arch][1])
    prompt = np.random.default_rng(7).integers(0, rm.cfg.vocab_size,
                                               size=(B, S_P))
    r_toks, r_logits = _greedy(_ref_side(rm, rp, jnp.float32), prompt)
    p_toks, p_logits = _greedy(_port_side(pm, pp, torch.float32), prompt)
    assert np.array_equal(p_toks, r_toks)
    for i in range(STEPS):
        assert rel_err(p_logits[i], r_logits[i]) < 1e-4, i


@pytest.mark.parametrize("arch", sorted(HEADS))
def test_full_head_ratio_decode_matches_reference_bf16(arch):
    rm, rp, pm, pp = _pair(arch, "bfloat16", "pallas")
    prompt = np.random.default_rng(8).integers(0, rm.cfg.vocab_size,
                                               size=(B, S_P))
    r_toks, r_logits = _greedy(_ref_side(rm, rp, jnp.bfloat16), prompt)
    _, p_logits = _greedy(_port_side(pm, pp, torch.bfloat16), prompt,
                          forced=r_toks)
    assert np.isfinite(p_logits).all()
    for i in range(STEPS):
        assert rel_err(p_logits[i], r_logits[i]) < 2e-2, i


def _layernorm_biases(cfg):
    """The analytic ``param_count`` (the reference's formula) counts a
    layernorm's scale alone; both packages' init also create its bias: two
    norms a layer and the final one."""
    return (2 * cfg.num_layers + 1) * cfg.d_model if cfg.norm == "layernorm" else 0


@pytest.mark.parametrize("arch", sorted(HEADS))
def test_full_size_param_count_and_fit(arch):
    cfg = get_config(arch).with_(param_dtype="bfloat16")
    model = build_model(cfg, "cpu")
    params, _ = model.init(abstract=True)
    leaves = list(tree_leaves(params))
    n = sum(t.numel() for t in leaves)
    ref_params, _ = ref_build_model(ref_get_config(arch), ENV).init(
        None, abstract=True)
    assert n == sum(x.size for x in jax.tree_util.tree_leaves(ref_params))
    assert n == cfg.param_count() + _layernorm_biases(cfg)
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    if cfg.tie_embeddings:       # the unembedding reads the token table
        assert "lm_head" not in params
    weights = sum(t.numel() * t.element_size() for t in leaves)
    pool = model.cache_bytes(4, 2048)
    assert pool == 2 * cfg.num_layers * 4 * 2048 * cfg.num_kv_heads * cfg.head_dim * 2
    assert weights + pool < CARD_BYTES
