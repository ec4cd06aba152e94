"""Gradient compression of the port (``repro_torch.optim.compression``)
against the reference's (``repro.optim.compression``) on the same numpy
inputs, its cross-rank sync over a two-rank gloo group on the CPU, and the
train step with ``grad_compression`` on one device.

Tolerances: int8 payloads bit-equal; scales, dequantized values and error
feedback within 1e-7 relative (one fp32 rounding of the same operations)."""
import datetime
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from port_parity import rel_err, to_np
from repro.optim import compression as ref_comp
from repro_torch.configs import get_config
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw as port_adamw
from repro_torch.optim import compression as port_comp
from repro_torch.train.train_step import TrainStepConfig, make_train_step

# 0-d; shorter than a block; exactly one block; ragged last dims with a
# padded block; leading dims kept
SHAPES = [(), (7,), (256,), (300,), (3, 513), (2, 4, 1000)]


def _draw(shape, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return np.asarray(scale * rng.standard_normal(shape), np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_and_dequantize_match_reference(shape):
    x = _draw(shape, 0)
    rq, rs = ref_comp.quantize_int8(jnp.asarray(x))
    q, s = port_comp.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert rel_err(s.numpy(), np.asarray(rs)) <= 1e-7
    size = int(np.prod(shape))
    want = ref_comp.dequantize_int8(rq, rs, shape, size)
    got = port_comp.dequantize_int8(q, s, shape, size)
    assert tuple(got.shape) == tuple(shape)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-7


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_compress_residual_matches_reference(shape):
    x, e = _draw(shape, 1), _draw(shape, 2, 0.03)
    (rq, rs), re = ref_comp.compress_residual(jnp.asarray(x), jnp.asarray(e))
    (q, s), err = port_comp.compress_residual(torch.from_numpy(x),
                                              torch.from_numpy(e))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert rel_err(s.numpy(), np.asarray(rs)) <= 1e-7
    assert tuple(err.shape) == tuple(shape) and err.dtype == torch.float32
    assert float(np.max(np.abs(err.numpy() - np.asarray(re)))) <= \
        1e-7 * float(np.max(np.abs(x))) + 1e-12


def test_init_error_feedback_matches_reference():
    tree = {"a": np.zeros((3, 5), np.float32), "b": {"c": np.zeros((), np.float32)}}
    want = ref_comp.init_error_feedback({"a": jnp.zeros((3, 5), jnp.bfloat16),
                                         "b": {"c": jnp.zeros(())}})
    got = port_comp.init_error_feedback(
        {"a": torch.zeros(3, 5, dtype=torch.bfloat16), "b": {"c": torch.zeros(())}})
    for path in (("a",), ("b", "c")):
        w, g = want, got
        for k in path:
            w, g = w[k], g[k]
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape)
        assert float(g.abs().sum()) == 0
    assert set(got) == set(tree)


def test_sync_without_a_group_returns_its_inputs():
    g = {"w": torch.randn(4, 300)}
    e = port_comp.init_error_feedback(g)
    out, err = port_comp.cross_pod_sync(g, e, None)
    assert out is g and err is e


# ---------------------------------------------------------------------------
# two ranks, gloo, on the CPU
# ---------------------------------------------------------------------------
def _grads(rank):
    return {"w": torch.from_numpy(_draw((5, 300), 10 + rank)),
            "b": torch.from_numpy(_draw((300,), 20 + rank)),
            "s": torch.from_numpy(_draw((), 30 + rank))}


def _errs(rank):
    return {k: torch.from_numpy(_draw(tuple(v.shape), 40 + rank, 0.03))
            for k, v in _grads(rank).items()}


def _rank_main(rank, world, store_path, out_dir):
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        group = dist.new_group(list(range(world)))
        mean, err = port_comp.cross_pod_sync(_grads(rank), _errs(rank), group)
        plain, same = port_comp.cross_pod_sync(_grads(rank), _errs(rank), group,
                                               compress=False)
        # the compressed train step: each rank its own batch, both apply
        # the same compressed mean and keep their own error feedback
        cfg = get_config("gpt2-124m").reduced()
        model = build_model(cfg, "cpu")
        params, _ = model.init(torch.Generator().manual_seed(0))
        toks = torch.from_numpy(np.random.default_rng(50 + rank).integers(
            0, cfg.vocab_size, size=(2, 17)))
        step = make_train_step(model, TrainStepConfig(
            grad_compression=True,
            opt=port_adamw.AdamWConfig(lr=1e-2, warmup_steps=1)), group)
        ef = port_comp.init_error_feedback(params)
        for _ in range(2):
            params, _, _, ef = step(params, port_adamw.init(params),
                                    {"tokens": toks[:, :-1],
                                     "labels": toks[:, 1:]}, ef)
        torch.save({"mean": mean, "err": err, "plain": plain, "same": same,
                    "params": params, "ef": ef},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_cross_pod_sync_two_gloo_ranks(tmp_path):
    """Each rank gets the mean of both ranks' dequantized compressions of
    grad + error feedback, and keeps its own ``compress_residual`` error;
    with ``compress=False`` the plain mean, the error untouched. Two
    compressed train steps on different batches leave both ranks with the
    same parameters and their own, non-zero, error feedback."""
    world = 2
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(tmp_path / "store"), str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    for name in ("w", "b", "s"):
        deq, resid = [], []
        for r in range(world):
            g, e = _grads(r)[name], _errs(r)[name]
            (q, s), ne = port_comp.compress_residual(g, e)
            deq.append(port_comp.dequantize_int8(q, s, tuple(g.shape), g.numel()))
            resid.append(ne)
        want = (deq[0] + deq[1]) / world
        want_plain = (_grads(0)[name] + _grads(1)[name]) / world
        for r in range(world):
            assert torch.equal(res[r]["mean"][name], want)
            assert torch.equal(res[r]["err"][name], resid[r])
            assert rel_err(to_np(res[r]["plain"][name]), to_np(want_plain)) <= 1e-7
            assert torch.equal(res[r]["same"][name], _errs(r)[name])
    p0, p1 = (port_comp.tree_leaves(res[r]["params"]) for r in range(world))
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
    e0, e1 = (list(port_comp.tree_leaves(res[r]["ef"])) for r in range(world))
    assert any(float(e.abs().sum()) > 0 for e in e0)
    assert any(not torch.equal(a, b) for a, b in zip(e0, e1))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def test_compressed_train_step_on_one_device_is_the_plain_step():
    """On one device (no group, or a group of one rank) the reference's
    step with ``grad_compression`` is the plain one: the same parameters."""
    cfg = get_config("gpt2-124m").reduced()
    model = build_model(cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt_cfg = port_adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    out = []
    for compress in (False, True):
        params, _ = model.init(torch.Generator().manual_seed(0))
        opt = port_adamw.init(params)
        step = make_train_step(model, TrainStepConfig(grad_compression=compress,
                                                      opt=opt_cfg))
        for _ in range(2):
            params, opt, _ = step(params, opt, batch)
        out.append(params)
    for a, b in zip(port_comp.tree_leaves(out[0]), port_comp.tree_leaves(out[1])):
        assert torch.equal(a, b)
