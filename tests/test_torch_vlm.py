"""The VLM family of the port (qwen2-vl-72b, reduced) against the reference
on the same numpy inputs and weights (CPU): M-RoPE, the forward over input
embeddings with three position streams, the decode and the loss.

Prompts are laid out as Qwen2-VL lays out one image (temporal grid 1): a
text prefix at t = h = w = i, a gh x gw block of image embeddings at
t = a, h = a + row, w = a + col (a the prefix length), then text again on all
three streams from a + max(gh, gw). So after the image the M-RoPE position
is below the cache index, and the decode's ``positions`` and ``pos`` differ.

Tolerances, the repo's: fp32 1e-4 for whole models, 1e-5 for layer
functions; bf16 2e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import model_pair, rel_err, to_jax, to_np, to_torch
from repro.models import layers as ref_layers
from repro_torch.models import layers as port_layers

ARCH = "qwen2-vl-72b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def vlm_positions(prefix: int, gh: int, gw: int, suffix: int, extra: int = 0):
    """(3, S) M-RoPE streams of one prompt of ``prefix`` text tokens, a
    gh x gw image and ``suffix`` text tokens, then ``extra`` generated
    tokens."""
    a = prefix
    text0 = np.repeat(np.arange(a)[None], 3, axis=0)
    rows, cols = np.divmod(np.arange(gh * gw), gw)
    image = np.stack([np.full(gh * gw, a), a + rows, a + cols])
    start = a + max(gh, gw)
    text1 = np.repeat(np.arange(start, start + suffix + extra)[None], 3, axis=0)
    return np.concatenate([text0, image, text1], axis=1)


def _batch(cfg, seed, B=2, extra=0):
    """Two prompts of 3 + 3x4 + 5 = 20 tokens (+ ``extra``), embeddings
    0.02 x normal (the stubbed vision tower and text rows alike)."""
    rng = np.random.default_rng(seed)
    pos = vlm_positions(3, 3, 4, 5, extra)
    S = pos.shape[1]
    return {"embeds": (0.02 * rng.standard_normal((B, S, cfg.d_model))
                       ).astype(np.float32),
            "positions": np.repeat(pos[:, None], B, axis=1)}


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("hd", [16, 128])
def test_apply_mrope_matches_reference(hd, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    positions = np.stack([rng.integers(0, 50, (2, 7)),          # three streams
                          rng.integers(100, 2000, (2, 7)),      # that differ
                          rng.integers(5000, 9000, (2, 7))])
    want = ref_layers.apply_mrope(to_jax(x, jdt), to_jax(positions), 1e6)
    got = port_layers.apply_mrope(to_torch(x, tdt), to_torch(positions), 1e6)
    assert got.dtype == tdt and got.shape == x.shape
    assert rel_err(to_np(got), to_np(want)) < (1e-5 if dtype == "float32" else 2e-2)
    # each frequency group follows its own stream: with two streams equal to
    # the third, M-RoPE is plain RoPE at those positions
    same = np.repeat(positions[1:2], 3, axis=0)
    plain = port_layers.apply_rope(to_torch(x), to_torch(same[0]), 1e6)
    assert rel_err(to_np(port_layers.apply_mrope(to_torch(x), to_torch(same), 1e6)),
                   to_np(plain)) < 1e-6


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_forward_matches_reference(attn_impl, dtype):
    rm, rp, pm, pp = model_pair(ARCH, dtype=dtype, attn_impl=attn_impl)
    batch = _batch(rm.cfg, 0)
    want, _, wcache = rm.forward(rp, {k: to_jax(v) for k, v in batch.items()},
                                 return_cache=True)
    got, aux, gcache = pm.forward(pp, {k: to_torch(v) for k, v in batch.items()},
                                  return_cache=True)
    assert got.shape == want.shape and float(aux) == 0.0
    assert rel_err(to_np(got), to_np(want)) < TOL[dtype]
    for name in ("k", "v"):
        assert rel_err(to_np(gcache[name]), to_np(wcache[name])) < TOL[dtype]


def test_decode_matches_reference_with_position_below_cache_index():
    """Prefill the 20-token prompt, paste into a bf16 pool of 32, decode one
    more embedding at cache index 20 whose M-RoPE position is 3 + 4 + 5 = 12:
    the reference's logits, and the port's own full forward's last row."""
    rm, rp, pm, pp = model_pair(ARCH, dtype="float32", seed=2)
    batch = _batch(rm.cfg, 1, extra=1)
    S_P, S_MAX = batch["embeds"].shape[1] - 1, 32
    assert batch["positions"][0, 0, S_P] == 12 < S_P
    pre = {"embeds": batch["embeds"][:, :S_P],
           "positions": batch["positions"][:, :, :S_P]}
    step = {"embeds": batch["embeds"][:, S_P:], "positions": batch["positions"][:, :, S_P:]}

    _, _, rc = rm.forward(rp, {k: to_jax(v) for k, v in pre.items()}, return_cache=True)
    rbig = {n: rm.init_cache(2, S_MAX)[n].at[:, :, :S_P].set(rc[n].astype(jnp.bfloat16))
            for n in rc}
    want, _ = rm.decode(rp, rbig, {**{k: to_jax(v) for k, v in step.items()},
                                   "pos": jnp.asarray(S_P, jnp.int32)})

    _, _, pc = pm.forward(pp, {k: to_torch(v) for k, v in pre.items()}, return_cache=True)
    pbig = pm.init_cache(2, S_MAX)
    for n in pbig:
        pbig[n][:, :, :S_P] = pc[n].to(pbig[n].dtype)
    got, _ = pm.decode(pp, pbig, {**{k: to_torch(v) for k, v in step.items()},
                                  "pos": torch.tensor(S_P)})
    assert rel_err(to_np(got), to_np(want)) < 1e-4
    full, _, _ = pm.forward(pp, {k: to_torch(v) for k, v in batch.items()})
    assert rel_err(to_np(got), to_np(full[:, -1])) < 2e-2
    # the new key went to cache row S_P, rotated at its M-RoPE position 12
    assert float(pbig["k"][:, :, S_P].float().abs().sum()) > 0
    assert float(pbig["k"][:, :, S_P + 1:].float().abs().sum()) == 0


def test_loss_matches_reference():
    rm, rp, pm, pp = model_pair(ARCH, dtype="float32", seed=3)
    batch = _batch(rm.cfg, 4)
    batch["labels"] = np.random.default_rng(5).integers(
        0, rm.cfg.vocab_size, size=batch["embeds"].shape[:2])
    want = float(rm.loss_fn(rp, {k: to_jax(v) for k, v in batch.items()}))
    got = pm.loss_fn(pp, {k: to_torch(v) for k, v in batch.items()})
    assert abs(float(got) - want) <= 1e-4 * abs(want)


def test_loss_and_grads_match_reference():
    """Model.loss_fn and every gradient leaf against jax.value_and_grad
    (fp32, 1e-4 of each leaf's largest value plus 1e-6, the atol of the key
    bias whose gradient is zero in exact arithmetic)."""
    import jax
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.train_step import _accumulate_grads
    rm, rp, pm, pp = model_pair(ARCH, dtype="float32", seed=3)
    batch = _batch(rm.cfg, 4)
    batch["labels"] = np.random.default_rng(5).integers(
        0, rm.cfg.vocab_size, size=batch["embeds"].shape[:2])
    want_loss, want = jax.value_and_grad(rm.loss_fn)(
        rp, {k: to_jax(v) for k, v in batch.items()})
    loss, grads = _accumulate_grads(pm, pp, {k: to_torch(v) for k, v in batch.items()}, 1)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = list(tree_leaves(grads))
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g, w = to_np(g), to_np(w)
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) <= 1e-4 * np.max(np.abs(w)) + 1e-6
