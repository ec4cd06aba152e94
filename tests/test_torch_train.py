"""The port's training path against the reference on the same numpy inputs:
flash forward-with-stats and backward (the kernels' plain versions on the
CPU, the reference's Pallas kernels in interpret mode), the custom-backward
flash, model loss and gradients, AdamW, microbatching, the data pipeline,
checkpoints written by either package, the fault-tolerant runner, the remat
routes, the train CLI, and the two guards that keep a kernel without a
backward from silently dropping gradients.

Tolerances are the reference's (tests/test_kernels.py, tests/test_train.py):
fp32 forward 2e-5, backward 1e-4 of the largest value, loss 1e-5. A gradient
leaf is held to 1e-4 of its largest value plus an absolute 1e-6, the
reference's atol for leaves whose gradient vanishes (the key bias: softmax
is unchanged by adding one score to every key of a query, so its gradient is
rounding noise on both sides).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import model_pair, np_tree, rel_err, to_jax, to_np, to_torch

from repro.configs.shapes import ShapeSuite as RefShapeSuite, TRAIN as REF_TRAIN
from repro.data import pipeline as ref_pipeline
from repro.kernels import flash_attention as ref_fa
from repro.kernels import ops as ref_ops
from repro.models import attention as ref_attention
from repro.models import model_zoo as ref_zoo
from repro.optim import adamw as ref_adamw
from repro.train import checkpoint as ref_ckpt
from repro.train.train_step import _accumulate_grads as ref_accumulate
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSuite, TRAIN
from repro_torch.data import pipeline as port_pipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as port_ops
from repro_torch.models import attention as port_attention
from repro_torch.models import model_zoo as port_zoo
from repro_torch.models import transformer as port_tfm
from repro_torch.models.common import cast_tree, weight_matmul
from repro_torch.models.convert import adamw_state_from_numpy, params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw as port_adamw
from repro_torch.train import checkpoint as port_ckpt
from repro_torch.train.train_step import (TrainStepConfig, _accumulate_grads,
                                          _value_and_grad, make_eval_step,
                                          make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaf_close(got, want, rtol=1e-4, atol=1e-6):
    got, want = to_np(got), to_np(want)
    return float(np.max(np.abs(got - want))) <= rtol * float(np.max(np.abs(want))) + atol


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _batch(vocab, B, S, seed):
    arr = ref_pipeline.SyntheticSource(vocab, seed=seed).batch(0, B, S)
    return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def _ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_batch(b):
    return {k: to_torch(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# kernels #2, #3, #4: plain versions vs the reference's Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,bq,bk", [(True, 64, 64), (True, 128, 64),
                                          (False, 64, 128)])
def test_flash_grads_match_reference_kernels(causal, bq, bk):
    """out and lse (2e-5), dq, dk, dv (1e-4) at test_kernels.py's shapes."""
    rng = np.random.default_rng(7)
    BH, S, hd = 4, 256, 64
    q, k, v, do = (rng.standard_normal((BH, S, hd)).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv, jdo = map(to_jax, (q, k, v, do))
    r_out, r_lse = ref_fa.flash_attention_fwd_stats(
        jq, jk, jv, causal=causal, block_q=bq, block_k=bk, interpret=True)
    _, r_dq, r_dk, r_dv = ref_ops.flash_attention_grads(
        jq, jk, jv, jdo, causal=causal, block_q=bq, block_k=bk)
    tq, tk, tv, tdo = map(to_torch, (q, k, v, do))
    out, lse = fa.flash_attention_fwd_stats(tq, tk, tv, causal=causal)
    dq, dk, dv = fa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=causal)
    assert rel_err(out, r_out) < 2e-5 and rel_err(lse, r_lse) < 2e-5
    for name, a, b in (("dq", dq, r_dq), ("dk", dk, r_dk), ("dv", dv, r_dv)):
        assert rel_err(a, b) < 1e-4, name
    # the ops wrapper computes the same four tensors
    got = port_ops.flash_attention_grads(tq, tk, tv, tdo, causal=causal)
    for a, b in zip(got, (out, dq, dk, dv)):
        assert torch.equal(a, b)


def test_flash_bwd_pieces_and_counts_on_cpu():
    """The dk/dv and dq wrappers take their plain versions on the CPU (no
    launch counted); bf16 inputs give bf16 gradients; bad inputs raise."""
    rng = np.random.default_rng(3)
    q, k, v, do = (to_torch(rng.standard_normal((2, 70, 32)).astype(np.float32),
                            torch.bfloat16) for _ in range(4))
    counts = (fa.flash_attention_fwd_stats.launches,
              fa.flash_attention_bwd_dkdv.launches, fa.flash_attention_bwd_dq.launches)
    out, lse = fa.flash_attention_fwd_stats(q, k, v)
    delta = fa.bwd_delta(out, do)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    assert (fa.flash_attention_fwd_stats.launches, fa.flash_attention_bwd_dkdv.launches,
            fa.flash_attention_bwd_dq.launches) == counts
    assert lse.dtype == torch.float32 and lse.shape == (2, 70)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert torch.equal(out, fa.flash_attention_fwd(q, k, v))
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dq(q, k, v, do, lse[:, :-1], delta)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd_dkdv(q, k, v, do.float(), lse, delta)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_routes_count_no_launch_on_cpu(dtype):
    """The backward wrappers' route table maps bf16 to the wgmma kernels and
    fp32 to the FMA ones, as the forward's does; CPU tensors take the plain
    versions and count no launch on any route."""
    assert fa.BWD_ROUTES == {torch.bfloat16: "wgmma", torch.float32: "fma"}
    assert fa.BWD_ROUTES == fa.FWD_ROUTES
    wrappers = (fa.flash_attention_bwd_dkdv, fa.flash_attention_bwd_dq)
    assert all(set(w.launches_by_route) == {"wgmma", "fma"} for w in wrappers)
    rng = np.random.default_rng(5)
    q, k, v, do = (to_torch(rng.standard_normal((2, 40, 16)).astype(np.float32),
                            dtype) for _ in range(4))
    before = [(w.launches, dict(w.launches_by_route)) for w in wrappers]
    out, lse = fa.flash_attention_fwd_stats(q, k, v)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    assert [(w.launches, dict(w.launches_by_route)) for w in wrappers] == before


def test_flash_cv_grads_match_reference():
    """jax.grad of sum(sin(flash_attention_cv)) against torch autograd of the
    port's flash_attention_cv (test_kernels.py:81), 1e-4."""
    rng = np.random.default_rng(8)
    B, S, H, hd = 2, 256, 2, 64
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    f = lambda *a: jnp.sum(jnp.sin(ref_attention.flash_attention_cv(
        *a, True, 64, hd ** -0.5)))
    want = jax.grad(f, argnums=(0, 1, 2))(*map(to_jax, (q, k, v)))
    tq, tk, tv = (to_torch(a).requires_grad_() for a in (q, k, v))
    out = port_attention.flash_attention_cv(tq, tk, tv, True, 64, hd ** -0.5)
    got = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))
    for a, b in zip(got, want):
        assert rel_err(a, b) < 1e-4


# ---------------------------------------------------------------------------
# the guards: no silent loss of gradients through a kernel without backward
# ---------------------------------------------------------------------------
def test_pallas_route_raises_under_autograd():
    """attn_impl="pallas" is the forward kernel alone: with a gradient
    wanted it raises and names xla_cv, on every device; without one it runs."""
    cfg = get_config("gpt2-124m").reduced().with_(attn_impl="pallas")
    q, k, v = (torch.randn(1, 8, cfg.num_heads, cfg.head_dim) for _ in range(3))
    assert port_attention.attention_core(cfg, q, k, v, causal=True).shape == q.shape
    with pytest.raises(RuntimeError, match="xla_cv"):
        port_attention.attention_core(cfg, q.requires_grad_(), k, v, causal=True)
    with torch.no_grad():
        port_attention.attention_core(cfg, q, k, v, causal=True)
    model = build_model(cfg, "cpu")
    params, _ = model.init(torch.Generator().manual_seed(0))
    batch = _port_batch(_batch(cfg.vocab_size, 2, 8, 0))
    with pytest.raises(RuntimeError, match="xla_cv"):
        _accumulate_grads(model, params, batch, 1)


def test_streamed_weight_raises_under_autograd():
    """A weight placed apart from the activations goes to stream_matmul,
    which has no backward: with a gradient wanted weight_matmul raises
    before any kernel is reached (activations on the meta device stand in
    for CUDA ones here)."""
    w = torch.randn(16, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        weight_matmul(torch.empty(2, 16, device="meta", requires_grad=True), w)
    with pytest.raises(RuntimeError, match="no backward"):
        weight_matmul(torch.empty(2, 16, device="meta"), w.requires_grad_())
    x = torch.randn(2, 16, requires_grad=True)
    assert weight_matmul(x, w).requires_grad          # same device: plain x @ w


def test_unread_parameter_raises_unless_declared():
    """A parameter the loss does not read is a wiring fault and raises; only
    one the model declares unread (``Model.unread_params``: the VLM's token
    table) gets a zero gradient."""
    params = {"a": torch.randn(3), "b": torch.randn(2, 2)}
    loss_fn = lambda p, batch: (p["a"] * batch["x"]).sum()
    batch = {"x": torch.randn(3)}
    with pytest.raises(RuntimeError, match="not read by the loss"):
        _value_and_grad(loss_fn, params, batch)
    loss, grads = _value_and_grad(loss_fn, params, batch, [params["b"]])
    torch.testing.assert_close(grads["a"], batch["x"])
    assert torch.equal(grads["b"], torch.zeros(2, 2))
    vlm = build_model(get_config("qwen2-vl-72b").reduced(), "cpu")
    assert vlm.unread_params() == ("tok_embed",)
    assert build_model(get_config("gpt2-124m").reduced(), "cpu").unread_params() == ()


# ---------------------------------------------------------------------------
# loss and gradients of whole models
# ---------------------------------------------------------------------------
# phi3-mini keeps its head dim of 96 (the width follows: 4 heads x 96), so
# that the flash forward+lse and backward routes run at the head dim its
# full-size training on the card gives them
GRAD_WIDTHS = {"phi3-mini-3.8b": dict(head_dim=96, d_model=384)}


@pytest.mark.parametrize("attn_impl", ["xla", "xla_cv"])
@pytest.mark.parametrize("arch", ["gpt2-124m", "llama3-8b", "phi3-mini-3.8b"])
def test_loss_and_grads_match_reference(arch, attn_impl):
    """Model.loss_fn and every gradient leaf, reduced config in fp32 (GQA in
    llama3-8b; head dim 96 in phi3-mini), the reference's init carried
    across."""
    rmodel, rparams, pmodel, pparams = model_pair(arch, dtype="float32",
                                                  attn_impl=attn_impl,
                                                  **GRAD_WIDTHS.get(arch, {}))
    assert pmodel.cfg.head_dim == GRAD_WIDTHS.get(arch, {}).get("head_dim", 16)
    b = _batch(rmodel.cfg.vocab_size, 2, 128, 11)
    r_loss, r_grads = jax.value_and_grad(rmodel.loss_fn)(rparams, _ref_batch(b))
    loss, grads = _accumulate_grads(pmodel, pparams, _port_batch(b), 1)
    assert abs(float(loss) - float(r_loss)) <= 1e-5 * abs(float(r_loss))
    want = _flat(np_tree(r_grads))
    got = _flat(grads)
    assert sorted(got) == sorted(want)
    for name in want:
        assert _leaf_close(got[name], want[name]), name


def test_softmax_xent_and_batch_specs_match_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 300)).astype(np.float32) * 3
    labels = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    want = float(ref_zoo.softmax_xent(to_jax(logits), to_jax(labels)))
    got = float(port_zoo.softmax_xent(to_torch(logits), to_torch(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)
    for arch in ("gpt2-124m", "llama3-8b"):
        rmodel, _, pmodel, _ = model_pair(arch)
        for kind, S in ((TRAIN, 32), ("decode", 32), ("prefill", 16)):
            rs = rmodel.batch_specs(RefShapeSuite("s", kind, S, 4))
            ps = pmodel.batch_specs(ShapeSuite("s", kind, S, 4))
            assert {k: (tuple(v[0]), np.dtype(v[1]).name) for k, v in rs.items()} == {
                k: (tuple(v[0]), str(v[1]).replace("torch.", "")) for k, v in ps.items()}
    batch = pmodel.synthetic_batch(ShapeSuite("t", TRAIN, 32, 4),
                                   torch.Generator().manual_seed(0))
    again = pmodel.synthetic_batch(ShapeSuite("t", TRAIN, 32, 4),
                                   torch.Generator().manual_seed(0))
    assert set(batch) == {"tokens", "labels"} and batch["tokens"].dtype == torch.int32
    assert batch["tokens"].shape == (4, 32) and int(batch["labels"].max()) < pmodel.cfg.vocab_size
    assert all(torch.equal(batch[k], again[k]) for k in batch)


def test_cast_tree():
    tree = {"a": torch.ones(2), "b": {"c": torch.ones(3, dtype=torch.int32)},
            "d": (torch.zeros(1, dtype=torch.float64),)}
    out = cast_tree(tree, "bfloat16")
    assert out["a"].dtype == torch.bfloat16 and out["d"][0].dtype == torch.bfloat16
    assert out["b"]["c"].dtype == torch.int32
    state = cast_tree(port_adamw.init({"w": torch.ones(2)}), torch.float16)
    assert isinstance(state, port_adamw.AdamWState) and state.mu["w"].dtype == torch.float16


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_schedule_matches_reference():
    cfg_r = ref_adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    cfg_p = port_adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    for s in (0, 1, 10, 19, 20, 21, 57, 150, 199, 200, 250):
        want = float(ref_adamw.schedule(cfg_r, jnp.asarray(s, jnp.int32)))
        assert abs(float(port_adamw.schedule(cfg_p, s)) - want) <= 1e-6 * want, s


def test_adamw_update_matches_reference():
    """Two updates from the reference's gradients: after each, params, mu,
    nu, lr and grad_norm equal the reference's to 1e-6 (in place in the
    port: the same trees come back). The reference's state after the first
    update crosses over with adamw_state_from_numpy for the second."""
    rmodel, rparams, pmodel, pparams = model_pair("gpt2-124m", dtype="float32")
    b = _batch(rmodel.cfg.vocab_size, 2, 32, 4)
    _, r_grads = jax.value_and_grad(rmodel.loss_fn)(rparams, _ref_batch(b))
    grads = params_from_numpy(np_tree(r_grads), device="cpu")
    cfg_r = ref_adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                                  clip_norm=0.5)
    cfg_p = port_adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                                   clip_norm=0.5)
    r_state = ref_adamw.init(rparams)
    p_state = port_adamw.init(pparams)
    for _ in range(2):
        rparams, r_state, r_met = ref_adamw.update(cfg_r, r_grads, r_state, rparams)
        same_p = pparams
        pparams, p_state, p_met = port_adamw.update(cfg_p, grads, p_state, pparams)
        assert pparams is same_p
        for key in ("lr", "grad_norm"):
            assert abs(float(p_met[key]) - float(r_met[key])) <= 1e-6 * float(r_met[key])
        assert int(p_state.step) == int(r_state.step)
        for got, want in ((pparams, rparams), (p_state.mu, r_state.mu),
                          (p_state.nu, r_state.nu)):
            want = _flat(np_tree(want))
            got = _flat(got)
            for name in want:
                assert rel_err(got[name], want[name]) <= 1e-6, name
        # the next round starts from the reference's state, carried across
        p_state = adamw_state_from_numpy(np_tree(r_state), device="cpu")
        pparams = params_from_numpy(np_tree(rparams), device="cpu")


# ---------------------------------------------------------------------------
# train step: microbatching, remat routes, the step itself
# ---------------------------------------------------------------------------
def test_microbatches_match_full_batch_and_reference():
    """4 microbatches against 1 (the port's own), and against the
    reference's _accumulate_grads with 4, fp32."""
    rmodel, rparams, pmodel, pparams = model_pair("gpt2-124m", dtype="float32")
    rbatch = rmodel.synthetic_batch(RefShapeSuite("t", REF_TRAIN, 32, 4))
    b = {k: np.asarray(v) for k, v in rbatch.items()}
    loss1, g1 = _accumulate_grads(pmodel, pparams, _port_batch(b), 1)
    loss4, g4 = _accumulate_grads(pmodel, pparams, _port_batch(b), 4)
    r_loss4, r_g4 = ref_accumulate(rmodel, rparams, rbatch, 4)
    assert abs(float(loss1) - float(loss4)) <= 1e-5 * abs(float(loss1))
    assert abs(float(loss4) - float(r_loss4)) <= 1e-5 * abs(float(r_loss4))
    want = _flat(np_tree(r_g4))
    for name, a in _flat(g4).items():
        assert _leaf_close(a, _flat(g1)[name]), name
        assert _leaf_close(a, want[name]), name
    with pytest.raises(ValueError, match="microbatches"):
        _accumulate_grads(pmodel, pparams, _port_batch(b), 3)


@pytest.mark.parametrize("arch", ["gpt2-124m", "llama3-8b"])
def test_remat_routes_give_equal_loss_and_grads(arch):
    """remat none, layer and offload run the same arithmetic: equal loss
    and gradients; the offload route sends each layer's input to the host
    once per step (counted), the others send nothing."""
    results = {}
    for remat in ("none", "layer", "offload"):
        cfg = get_config(arch).reduced().with_(attn_impl="xla_cv", remat=remat)
        model = build_model(cfg, "cpu")
        params, _ = model.init(torch.Generator().manual_seed(0))
        batch = _port_batch(_batch(cfg.vocab_size, 2, 64, 5))
        before = port_tfm.offload_activation.d2h_bytes
        loss, grads = _accumulate_grads(model, params, batch, 1)
        results[remat] = (loss, _flat(grads),
                          port_tfm.offload_activation.d2h_bytes - before)
    loss_l, g_l, bytes_l = results["layer"]
    for remat in ("none", "offload"):
        loss, g, _ = results[remat]
        assert abs(float(loss) - float(loss_l)) <= 1e-6 * abs(float(loss_l))
        for name in g_l:
            assert rel_err(g[name], g_l[name]) <= 1e-6, (remat, name)
    L, d = cfg.num_layers, cfg.d_model
    assert results["offload"][2] == L * 2 * 64 * d * 2      # bf16 layer inputs
    assert results["none"][2] == bytes_l == 0


def test_train_step_and_eval_step():
    """make_train_step updates in place and lowers the loss on a fixed
    batch; make_eval_step gives the loss without autograd; with gradient
    compression on one device (no group of pods) the step is the plain one,
    as the reference's is without a "pod" axis: the same parameters."""
    cfg = get_config("gpt2-124m").reduced().with_(attn_impl="xla_cv")
    model = build_model(cfg, "cpu")
    params, _ = model.init(torch.Generator().manual_seed(0))
    opt = port_adamw.init(params)
    batch = _port_batch(_batch(cfg.vocab_size, 4, 32, 6))
    step = make_train_step(model, TrainStepConfig(
        microbatches=2, opt=port_adamw.AdamWConfig(lr=1e-2, warmup_steps=1)))
    evaluate = make_eval_step(model)
    first = float(evaluate(params, batch))
    for _ in range(5):
        params, opt, met = step(params, opt, batch)
    assert set(met) == {"loss", "grad_norm", "lr"} and int(opt.step) == 5
    assert float(evaluate(params, batch)) < first - 0.5
    assert not evaluate(params, batch).requires_grad
    outs = []
    for compress in (False, True):
        p, _ = model.init(torch.Generator().manual_seed(1))
        o = port_adamw.init(p)
        step = make_train_step(model, TrainStepConfig(
            grad_compression=compress,
            opt=port_adamw.AdamWConfig(lr=1e-2, warmup_steps=1)))
        p, o, _ = step(p, o, batch)
        outs.append(_flat(p))
    for name in outs[0]:
        assert torch.equal(outs[0][name], outs[1][name]), name


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
def test_batch_at_and_sources_match_reference(tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(bytes(range(256)) * 9)
    pairs = [(ref_pipeline.SyntheticSource(256, seed=3),
              port_pipeline.SyntheticSource(256, seed=3)),
             (ref_pipeline.ByteCorpusSource(str(corpus), seed=1),
              port_pipeline.ByteCorpusSource(str(corpus), seed=1))]
    for rsrc, psrc in pairs:
        rp = ref_pipeline.DataPipeline(rsrc, 4, 32)
        pp = port_pipeline.DataPipeline(psrc, 4, 32)
        for step in (0, 7, 12):
            want, got = rp.batch_at(step), pp.batch_at(step)
            assert sorted(got) == ["labels", "tokens"]
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        it = iter(port_pipeline.DataPipeline(psrc, 4, 32, start_step=5))
        for step in (5, 6):
            got = next(it)
            assert got["tokens"].dtype == torch.int32
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          pp.batch_at(step)["tokens"])
        it.close()


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------
def _states():
    rmodel, rparams, pmodel, pparams = model_pair("gpt2-124m")
    r_state = {"params": rparams, "opt": ref_adamw.init(rparams)}
    p_state = {"params": pparams, "opt": port_adamw.init(pparams)}
    return r_state, p_state


def test_checkpoint_paths_and_hash_match_reference():
    r_state, p_state = _states()
    assert port_ckpt._tree_paths(p_state) == ref_ckpt._tree_paths(r_state)
    assert port_ckpt._tree_paths(p_state)[:2] == ["opt/.step", "opt/.mu/final_norm_bias"]
    assert port_ckpt._structure_hash(p_state) == ref_ckpt._structure_hash(r_state)
    assert port_ckpt.volume_bytes(p_state) == ref_ckpt.volume_bytes(r_state)
    tree = {"a": torch.ones(8, 4), "b": torch.zeros(3, dtype=torch.int32)}
    assert port_ckpt.volume_bytes(tree) == 8 * 4 * 4 + 3 * 4
    with pytest.raises(TypeError, match="bfloat16"):
        port_ckpt._structure_hash({"w": torch.ones(2, dtype=torch.bfloat16)})


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_in_the_other_package(writer, tmp_path):
    """Training state saved by one package restores in the other, value for
    value; a wrong structure is rejected on both sides; keep-N gc holds."""
    r_state, p_state = _states()
    rng = np.random.default_rng(0)
    # make the moments non-trivial, on both sides alike
    mu = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
          for k, v in _flat(np_tree(r_state["opt"].mu)).items()}
    d = str(tmp_path)
    if writer == "reference":
        rmu = jax.tree_util.tree_map(lambda a: a, r_state["opt"].mu)
        flat_paths = sorted(mu)
        leaves = [jnp.asarray(mu[p]) for p in flat_paths]
        rmu = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(rmu), leaves)
        r_state = {"params": r_state["params"], "opt": r_state["opt"]._replace(
            mu=rmu, step=jnp.asarray(3, jnp.int32))}
        for s in (10, 20, 30):
            ref_ckpt.save(d, s, r_state, keep=2)
        restored, step = port_ckpt.restore(d, p_state)
        source = r_state
    else:
        for name, arr in mu.items():
            node = p_state["opt"].mu
            *parents, leaf = name.split("/")
            for part in parents:
                node = node[part]
            node[leaf].copy_(torch.from_numpy(arr))
        p_state["opt"].step.fill_(3)
        for s in (10, 20, 30):
            port_ckpt.save(d, s, p_state, keep=2)
        restored, step = ref_ckpt.restore(d, r_state)
        source = p_state
    assert step == 30 == ref_ckpt.latest_step(d) == port_ckpt.latest_step(d)
    assert len([x for x in os.listdir(d) if x.startswith("step_")]) == 2
    with open(os.path.join(d, "step_00000030", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["paths"] == ref_ckpt._tree_paths(r_state)
    assert int(to_np(restored["opt"].step)) == 3
    want = _flat(np_tree({"params": source["params"], "mu": source["opt"].mu}))
    got = _flat(np_tree({"params": restored["params"], "mu": restored["opt"].mu}))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    if writer == "reference":
        assert isinstance(restored["opt"], port_adamw.AdamWState)
        assert all(isinstance(t, torch.Tensor) for t in _flat(restored["params"]).values())
        with pytest.raises(ValueError, match="structure"):
            port_ckpt.restore(d, {"params": p_state["params"]})
    else:
        with pytest.raises(ValueError, match="structure"):
            ref_ckpt.restore(d, {"params": r_state["params"]})


# ---------------------------------------------------------------------------
# fault-tolerant runner and the train CLI
# ---------------------------------------------------------------------------
def test_fault_runner_restarts_and_repartitions(tmp_path):
    """The reference's scenario (tests/test_train.py:104) on the port: a chip
    fails at step 12, the runner restores step 10 and moves to another
    slice, and finishes 20 steps."""
    from repro_torch.core.partitioner import StaticPartitioner
    from repro_torch.core.slices import get_profile
    from repro_torch.launch.train import build_config, train
    from repro_torch.train.fault import (FaultTolerantRunner, RunnerConfig,
                                         StepFailure)
    cfg = build_config("gpt2-124m", full_size=False, attn_impl="xla_cv")
    model = build_model(cfg, "cpu")
    step_fn = make_train_step(model, TrainStepConfig(
        opt=port_adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=60)))
    pipe = port_pipeline.DataPipeline(port_pipeline.SyntheticSource(
        cfg.vocab_size, seed=5), 2, 16)
    d = str(tmp_path / "a")

    def build_step(profile):
        params, _ = model.init(torch.Generator().manual_seed(0))
        state = {"params": params, "opt": port_adamw.init(params)}
        if port_ckpt.latest_step(d) is not None:
            state, _ = port_ckpt.restore(d, state)

        def step(state, batch):
            p, o, met = step_fn(state["params"], state["opt"],
                                port_pipeline.to_device(batch, "cpu"))
            return {"params": p, "opt": o}, {k: float(v) for k, v in met.items()}
        return step, state

    part = StaticPartitioner()
    prof = get_profile("8s.128c")
    part.allocate(prof)
    fired = []

    def fail_hook(step):
        if step == 12 and not fired:
            fired.append(step)
            part.fail_chips([(0, 0)])
            raise StepFailure("injected")

    runner = FaultTolerantRunner(
        RunnerConfig(ckpt_dir=d, ckpt_every=5, max_restarts=2),
        part, prof, build_step, pipe.batch_at, lambda s: s, fail_hook)
    stats = runner.run(20)
    assert stats.restarts == 1 and stats.repartitions
    assert stats.steps_done >= 20 and len(stats.step_seconds) == stats.steps_done
    assert port_ckpt.latest_step(d) == 20
    # the entry point's own loop: the same failure through launch.train.train
    stats = train(cfg, steps=20, batch=2, seq=16, lr=1e-3, device="cpu",
                  ckpt_dir=str(tmp_path / "b"), ckpt_every=5,
                  inject_failure_at=12)
    assert stats.restarts == 1 and stats.repartitions == ["1s.16c->8s.128c"]
    assert stats.steps_done == 22         # steps 10 and 11 ran twice


@pytest.mark.parametrize("argv", [
    ["-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "25",
     "--batch", "4", "--seq", "32", "--lr", "1e-2", "--attn-impl", "xla_cv",
     "--ckpt-every", "5", "--inject-failure-at", "12", "--log-every", "0"],
    ["-m", "repro_torch.examples.train_gpt2", "--tiny", "--device", "cpu",
     "--steps", "25", "--batch", "4", "--seq", "32"],
] + [
    ["-m", "repro_torch.launch.train", "--arch", arch, "--device", "cpu",
     "--steps", "25", "--batch", "4", "--seq", "32", "--lr", "1e-2",
     "--attn-impl", "xla_cv", "--ckpt-every", "5", "--log-every", "0"]
    for arch in ("mamba2-130m", "zamba2-1.2b", "granite-moe-1b-a400m")
])
def test_train_cli_on_cpu_loss_falls(argv):
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": os.environ.get("PATH", ""),
           "HOME": os.environ.get("HOME", ROOT)}
    run = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    line = run.stdout.strip().splitlines()[-1]
    first, last = (float(x) for x in line.split("loss ")[1].split(" step")[0].split(" -> "))
    assert last < first - 0.5, line
    assert "attn_impl=xla_cv" in line
    if "--inject-failure-at" in argv:
        assert "restarts=1" in line and "steps=27" in line
