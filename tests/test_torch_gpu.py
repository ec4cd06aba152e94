"""Kernels of the port on the card, each against its plain version, and the
model paths that route through them.

Needs a CUDA device; every test skips inside itself without one. This file
imports neither jax nor the reference package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: fp32 1e-5 relative (the reference's, tests/test_kernels.py; the
kernel multiplies in true fp32, the plain version through cuBLAS without
TF32), bf16 2e-2 (one bf16 rounding of the output, sums in another order).
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.kernels import stream_matmul as sm

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / (want.float().abs().max() + 1e-9))


def _inputs(M, K, N, xdt, wdt, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(xdt)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(wdt)
    return x, w


CASES = [  # (M, K, N, x dtype, w dtype)
    (128, 512, 128, torch.float32, torch.float32),     # the reference's shapes
    (256, 1024, 384, torch.float32, torch.float32),
    (4, 4096, 1000, torch.bfloat16, torch.bfloat16),
    (5, 1000, 77, torch.bfloat16, torch.bfloat16),      # ragged everywhere
    (67, 300, 129, torch.float32, torch.float32),
    (33, 700, 200, torch.bfloat16, torch.float32),      # w in another dtype
    (9, 520, 64, torch.float32, torch.bfloat16),
    (1, 1, 1, torch.bfloat16, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["device", "pinned"])
@pytest.mark.parametrize("M,K,N,xdt,wdt", CASES)
def test_stream_matmul_matches_plain(M, K, N, xdt, wdt, where):
    dev = _cuda()
    x, w = _inputs(M, K, N, xdt, wdt)
    x = x.to(dev)
    w = w.to(dev) if where == "device" else w.pin_memory()
    launches, streamed = sm.stream_matmul.launches, sm.stream_matmul.h2d_bytes
    got = sm.stream_matmul(x, w, block_k=256)
    want = sm.stream_matmul_plain(x, w.to(dev))
    torch.cuda.synchronize()
    assert got.dtype == xdt and got.shape == (M, N) and got.device == x.device
    assert _rel(got, want) < TOL[xdt], (M, K, N, xdt, wdt, where)
    assert sm.stream_matmul.launches == launches + 1
    assert sm.stream_matmul.h2d_bytes - streamed == (
        K * N * w.element_size() if where == "pinned" else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["device", "pinned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_matmul_transposed_table(where, dtype):
    """w = table.T of an (N, K) row-major table (the tied unembedding),
    and w = a row of a stacked pinned tensor (a layer's weight)."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((1031, 96)).astype(np.float32))
    stacked = torch.from_numpy(rng.standard_normal((3, 96, 130)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((6, 96)).astype(np.float32)).to(dtype).to(dev)
    if where == "device":
        table, stacked = table.to(dev), stacked.to(dev)
    else:
        table, stacked = table.pin_memory(), stacked.pin_memory()
    for w in (table.T, stacked[2]):
        got = sm.stream_matmul(x, w, block_k=40)
        want = sm.stream_matmul_plain(x, w.to(dev))
        torch.cuda.synchronize()
        assert _rel(got, want) < TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("block_k", [None, 64, "K"])
@pytest.mark.parametrize("M,K,N,xdt,wdt", CASES)
def test_stream_matmul_ring_panel_depths_match_plain(M, K, N, xdt, wdt, block_k):
    """The ring at its byte-sized panels, at 64-row panels (ragged last one)
    and at one panel of the whole K: the same function, each byte of w
    streamed once, each launch counted on the ring."""
    dev = _cuda()
    x, w = _inputs(M, K, N, xdt, wdt, seed=1)
    x, w = x.to(dev), w.pin_memory()
    before = (sm.stream_matmul.h2d_bytes, dict(sm.stream_matmul.launches_by_route))
    got = sm.stream_matmul(x, w, block_k=K if block_k == "K" else block_k)
    want = sm.stream_matmul_plain(x, w.to(dev))
    torch.cuda.synchronize()
    assert got.dtype == xdt and got.shape == (M, N)
    assert _rel(got, want) < TOL[xdt], (M, K, N, xdt, wdt, block_k)
    assert sm.stream_matmul.h2d_bytes - before[0] == K * N * w.element_size()
    assert {r: n - before[1][r] for r, n in sm.stream_matmul.launches_by_route.items()
            } == {"ring": 1, "resident": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 16, 17, 64, 200])
@pytest.mark.parametrize("where", ["device", "pinned"])
def test_stream_matmul_routes_by_placement_on_card(M, where):
    """The plan's routes at decode and prefill sizes, at llama3-8b's w_gate
    widths cut to 1024 columns: a pinned w through the ring, a device w
    resident; each matches."""
    dev = _cuda()
    x, w = _inputs(M, 4096, 1024, torch.bfloat16, torch.bfloat16, seed=M)
    x = x.to(dev)
    w = w.to(dev) if where == "device" else w.pin_memory()
    want_route = "resident" if where == "device" else "ring"
    before = dict(sm.stream_matmul.launches_by_route)
    got = sm.stream_matmul(x, w)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in sm.stream_matmul.launches_by_route.items()
            } == {r: int(r == want_route) for r in sm.ROUTES}
    assert _rel(got, sm.stream_matmul_plain(x, w.to(dev))) < TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 16, 100])
@pytest.mark.parametrize("tdt,xdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_stream_matmul_streams_a_table_by_rows(M, tdt, xdt):
    """The tied unembedding: w is the transposed view of a pinned (N, K)
    table (granite-moe's bf16 one, gpt2's fp32 one, cut in rows), streamed
    in panels of whole table rows, each product placed into its output
    columns; N off every tile."""
    dev = _cuda()
    rng = np.random.default_rng(M)
    K = 768 if tdt == torch.float32 else 1024
    table = torch.from_numpy(rng.standard_normal((5003, K)).astype(np.float32)
                             ).to(tdt).pin_memory()
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(xdt).to(dev)
    want = sm.stream_matmul_plain(x, table.T.to(dev))
    for block_k in (None, 64, 5003):   # byte-sized panels, 64 rows, one panel
        before = dict(sm.stream_matmul.launches_by_route)
        got = sm.stream_matmul(x, table.T, block_k=block_k)
        torch.cuda.synchronize()
        assert sm.stream_matmul.launches_by_route["ring"] == before["ring"] + 1
        assert _rel(got, want) < TOL[xdt], block_k


@pytest.mark.gpu
def test_stream_matmul_rejects_pageable_and_mixed():
    dev = _cuda()
    x = torch.zeros(4, 8, device=dev)
    with pytest.raises(ValueError, match="pageable"):
        sm.stream_matmul(x, torch.zeros(8, 4))
    with pytest.raises(ValueError):
        sm.stream_matmul(torch.zeros(4, 8), torch.zeros(8, 4, device=dev))
    with pytest.raises(TypeError):
        sm.stream_matmul(x.half(), torch.zeros(8, 4, device=dev))


@pytest.mark.gpu
def test_weight_matmul_routes_by_placement():
    """A device weight takes the plain product (no launch); a pinned one
    streams through the kernel; an embedding table in pinned memory moves
    only the gathered rows."""
    from repro_torch.models import layers
    from repro_torch.models.common import weight_matmul
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 3, 64, device=dev, generator=g).bfloat16()
    w = torch.randn(64, 96, device=dev, generator=g).bfloat16()
    launches = sm.stream_matmul.launches
    plain = weight_matmul(x, w)
    assert sm.stream_matmul.launches == launches
    streamed = weight_matmul(x, w.cpu().pin_memory())
    torch.cuda.synchronize()
    assert sm.stream_matmul.launches == launches + 1
    assert streamed.shape == (2, 3, 96) and _rel(streamed, plain) < 2e-2
    with pytest.raises(ValueError, match="pageable"):
        weight_matmul(x, w.cpu())
    table = torch.randn(100, 64, device=dev, generator=g)
    tokens = torch.tensor([[5, 7, 99]], device=dev)
    before = layers.gather_rows.h2d_bytes
    rows = layers.gather_rows(table.cpu().pin_memory(), tokens)
    assert rows.device == tokens.device and torch.equal(rows, table[tokens])
    assert layers.gather_rows.h2d_bytes - before == 3 * 64 * 4


@pytest.mark.gpu
def test_runtime_streams_offloaded_weights():
    """A reduced llama3 tenant whose budget spills a stacked MLP matrix:
    the matrix lives in pinned memory, every prefill and tick streams it once
    per layer, and the logits equal those of an all-device copy (fp32)."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload import memory_kind_of
    from repro_torch.serving import Request, SliceRuntime, TenantSpec
    dev = _cuda()
    cfg = get_config("llama3-8b").reduced().with_(remat="none", dtype="float32")
    rt = SliceRuntime(device=dev)
    t = rt.add_tenant(TenantSpec("llm", cfg, profile="2s.32c", slots=2,
                                 max_seq=48, hbm_budget=300_000,
                                 spill_granule=4096))
    assert "params/layers/w_gate" in t.plan.offloaded
    w_gate = t.params["layers"]["w_gate"]
    assert memory_kind_of(w_gate) == "pinned_host" and w_gate.is_pinned()
    assert t.engine.pool.memory_kinds() == {"pinned_host"}
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=6).astype(np.int32), 4)
            for i in range(3)]
    launches, streamed = sm.stream_matmul.launches, sm.stream_matmul.h2d_bytes
    rt.submit("llm", reqs)
    rt.run()
    stats = t.engine.stats
    calls = (stats.admitted + stats.ticks) * cfg.num_layers
    assert sm.stream_matmul.launches - launches == calls
    assert sm.stream_matmul.h2d_bytes - streamed == calls * w_gate[0].numel() * 4
    assert all(len(v) == 4 for v in t.engine.outputs.values())
    on_device = {k: (v.to(dev) if torch.is_tensor(v) else
                     {kk: vv.to(dev) for kk, vv in v.items()})
                 for k, v in t.params.items()}
    toks = torch.as_tensor(reqs[0].prompt.astype(np.int64), device=dev)[None]
    got = t.model.forward(t.params, {"tokens": toks})[0]
    want = t.model.forward(on_device, {"tokens": toks})[0]
    assert _rel(got, want) < 1e-4


FLASH_SHAPES = [  # (Sq, Sk, causal): square, ragged, non-causal, cross-length
    (128, 128, True), (300, 300, True), (77, 77, False), (1, 1, True),
    (40, 200, False), (130, 257, True)]
# the bf16 kernels' tile edges besides: one 64-row tile, one short of two
# (the forward's 128-row query block), a ragged S and a serving length,
# causal and full; the forward and the backward tests take both lists
FWD_SHAPES = FLASH_SHAPES + [(S, S, c) for S in (64, 127, 300, 1024)
                             for c in (True, False) if (S, S, c) != (300, 300, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    """The flash-attention forward kernel against its plain version, at every
    head dim it takes, square and ragged lengths, causal and not, each launch
    counted on its route (bf16 wgmma, fp32 fma); inputs it cannot take
    raise."""
    from repro_torch.kernels import flash_attention as fa
    dev = _cuda()
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}[dtype]
    for hd in fa.HEAD_DIMS:
        for Sq, Sk, causal in FWD_SHAPES:
            g = torch.Generator(device=dev).manual_seed(Sq + Sk + hd)
            q = torch.randn(4, Sq, hd, device=dev, generator=g).to(dtype)
            k, v = (torch.randn(4, Sk, hd, device=dev, generator=g).to(dtype)
                    for _ in range(2))
            before = (fa.flash_attention_fwd.launches,
                      fa.flash_attention_fwd.launches_by_route[fa.FWD_ROUTES[dtype]])
            got = fa.flash_attention_fwd(q, k, v, causal=causal)
            want = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert (fa.flash_attention_fwd.launches,
                    fa.flash_attention_fwd.launches_by_route[fa.FWD_ROUTES[dtype]]
                    ) == (before[0] + 1, before[1] + 1)
            assert _rel(got, want) < tol, (dtype, hd, Sq, Sk, causal)
    wide = torch.zeros(4, 8, 32, device=dev, dtype=dtype)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(wide[..., :16], wide[..., :16], wide[..., :16])
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(wide.half(), wide.half(), wide.half())
    odd = torch.zeros(4 * 8 * 16 + 1, device=dev, dtype=dtype)[1:].view(4, 8, 16)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(odd, odd, odd)




def _flash_inputs(dev, dtype, BH, Sq, Sk, hd, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(BH, Sq, hd, device=dev, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(BH, Sk, hd, device=dev, generator=g).to(dtype)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_stats_matches_plain_on_card(dtype):
    """The forward kernel with its lse output: out and lse against the plain
    version (out: fp32 2e-5, bf16 2e-2; lse fp32 2e-5 of its largest value,
    in both input types since the statistics are fp32 sums)."""
    from repro_torch.kernels import flash_attention as fa
    dev = _cuda()
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}[dtype]
    for hd in fa.HEAD_DIMS:
        for Sq, Sk, causal in FWD_SHAPES:
            q, k, v, _ = _flash_inputs(dev, dtype, 4, Sq, Sk, hd, Sq + Sk + hd)
            before = (fa.flash_attention_fwd_stats.launches,
                      fa.flash_attention_fwd.launches)
            out, lse = fa.flash_attention_fwd_stats(q, k, v, causal=causal)
            want_out, want_lse = fa.flash_attention_fwd_stats_plain(
                q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert (fa.flash_attention_fwd_stats.launches,
                    fa.flash_attention_fwd.launches) == (before[0] + 1, before[1])
            assert lse.dtype == torch.float32 and lse.shape == (4, Sq)
            assert _rel(out, want_out) < tol, (dtype, hd, Sq, Sk, causal)
            assert _rel(lse, want_lse) < 2e-5, (dtype, hd, Sq, Sk, causal)


def _close(got, want, tol, atol=1e-5) -> bool:
    """max |diff| <= tol * max |want| + atol: the absolute term covers a
    gradient that vanishes (one key: dS = p (dO.v - dO.o) = 0 exactly), where
    both sides hold rounding noise."""
    diff = float((got.float() - want.float()).abs().max())
    return diff <= tol * float(want.float().abs().max()) + atol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain_on_card(dtype):
    """dk/dv and dq kernels against their plain versions on the same lse and
    delta (fp32 1e-4, the reference's backward tolerance; bf16 2e-2), at
    every head dim, square, ragged and cross lengths and the forward's tile
    edges, causal and not, each launch counted on its route (bf16 wgmma,
    fp32 fma)."""
    from repro_torch.kernels import flash_attention as fa
    dev = _cuda()
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    route = fa.BWD_ROUTES[dtype]
    for hd in fa.HEAD_DIMS:
        for Sq, Sk, causal in FWD_SHAPES:
            q, k, v, do = _flash_inputs(dev, dtype, 4, Sq, Sk, hd, Sq * Sk + hd)
            out, lse = fa.flash_attention_fwd_stats_plain(q, k, v, causal=causal)
            delta = fa.bwd_delta(out, do)
            before = (fa.flash_attention_bwd_dkdv.launches,
                      fa.flash_attention_bwd_dq.launches,
                      fa.flash_attention_bwd_dkdv.launches_by_route[route],
                      fa.flash_attention_bwd_dq.launches_by_route[route])
            dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                 causal=causal)
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
            want_dk, want_dv = fa.flash_attention_bwd_dkdv_plain(
                q, k, v, do, lse, delta, causal=causal)
            want_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                      causal=causal)
            torch.cuda.synchronize()
            assert (fa.flash_attention_bwd_dkdv.launches,
                    fa.flash_attention_bwd_dq.launches,
                    fa.flash_attention_bwd_dkdv.launches_by_route[route],
                    fa.flash_attention_bwd_dq.launches_by_route[route]
                    ) == tuple(n + 1 for n in before)
            case = (dtype, hd, Sq, Sk, causal)
            assert dq.dtype == dk.dtype == dv.dtype == dtype
            assert _close(dq, want_dq, tol), ("dq",) + case
            assert _close(dk, want_dk, tol), ("dk",) + case
            assert _close(dv, want_dv, tol), ("dv",) + case
    # deterministic: no atomics, so a second launch is bitwise the same
    q, k, v, do = _flash_inputs(dev, dtype, 8, 512, 512, 64, 1)
    out, lse = fa.flash_attention_fwd_stats(q, k, v)
    first = fa.flash_attention_bwd(q, k, v, out, lse, do)
    second = fa.flash_attention_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# (Sq, Sk, q_offset): a sequence-parallel rank's block at its offset over
# the whole sequence (bottom-right: Sk = Sq + q_offset), offsets inside a
# 64-row tile and past its edge, ragged lengths, queries past the last key
OFFSET_SHAPES = [(256, 1024, 768), (256, 1024, 256), (128, 512, 100),
                 (100, 300, 130), (70, 300, 129), (128, 128, 37), (1, 64, 63)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_with_query_offset_match_plain_on_card(dtype):
    """The forward (with and without lse), dk/dv and dq kernels, causal with
    ``q_offset``, against their plain versions at every head dim (forward
    fp32 2e-5, lse 2e-5, gradients fp32 1e-4; bf16 2e-2), each launch on its
    route."""
    from repro_torch.kernels import flash_attention as fa
    dev = _cuda()
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}[dtype]
    gtol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    routes = (fa.FWD_ROUTES[dtype], fa.BWD_ROUTES[dtype])
    for hd in fa.HEAD_DIMS:
        for Sq, Sk, off in OFFSET_SHAPES:
            q, k, v, do = _flash_inputs(dev, dtype, 4, Sq, Sk, hd, Sq + off + hd)
            before = (fa.flash_attention_fwd.launches_by_route[routes[0]],
                      fa.flash_attention_bwd_dq.launches_by_route[routes[1]])
            out = fa.flash_attention_fwd(q, k, v, q_offset=off)
            out_s, lse = fa.flash_attention_fwd_stats(q, k, v, q_offset=off)
            want, want_lse = fa.flash_attention_fwd_stats_plain(q, k, v,
                                                                q_offset=off)
            delta = fa.bwd_delta(want, do)
            args = (q, k, v, do, want_lse, delta)
            dk, dv = fa.flash_attention_bwd_dkdv(*args, q_offset=off)
            dq = fa.flash_attention_bwd_dq(*args, q_offset=off)
            w_dk, w_dv = fa.flash_attention_bwd_dkdv_plain(*args, q_offset=off)
            w_dq = fa.flash_attention_bwd_dq_plain(*args, q_offset=off)
            torch.cuda.synchronize()
            case = (dtype, hd, Sq, Sk, off)
            assert (fa.flash_attention_fwd.launches_by_route[routes[0]],
                    fa.flash_attention_bwd_dq.launches_by_route[routes[1]]
                    ) == (before[0] + 1, before[1] + 1), case
            assert _rel(out, want) < tol and _rel(out_s, want) < tol, case
            assert _rel(lse, want_lse) < 2e-5, case
            assert _close(dq, w_dq, gtol), ("dq",) + case
            assert _close(dk, w_dk, gtol), ("dk",) + case
            assert _close(dv, w_dv, gtol), ("dv",) + case


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_phi3_mini_head_dim_on_card(dtype):
    """Head dim 96 (phi3-mini) at its serving shape (32, 1024, 96), causal:
    the forward, the forward with lse and both backward kernels against their
    plain versions (fp32 2e-5 forward, 1e-4 backward; bf16 2e-2), each launch
    on its route in the kernel itself (bf16 wgmma, fp32 fma)."""
    from repro_torch.kernels import flash_attention as fa
    dev = _cuda()
    fwd_tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}[dtype]
    bwd_tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    q, k, v, do = _flash_inputs(dev, dtype, 32, 1024, 1024, 96, 96)
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_fwd_stats,
                fa.flash_attention_bwd_dkdv, fa.flash_attention_bwd_dq)
    route = fa.FWD_ROUTES[dtype]
    assert route == fa.BWD_ROUTES[dtype]
    before = [(w.launches, w.launches_by_route[route]) for w in wrappers]
    out = fa.flash_attention_fwd(q, k, v)
    out_s, lse = fa.flash_attention_fwd_stats(q, k, v)
    want_out, want_lse = fa.flash_attention_fwd_stats_plain(q, k, v)
    delta = fa.bwd_delta(want_out, do)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, want_lse, delta)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, want_lse, delta)
    want_dk, want_dv = fa.flash_attention_bwd_dkdv_plain(q, k, v, do, want_lse,
                                                         delta)
    want_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, want_lse, delta)
    torch.cuda.synchronize()
    assert [(w.launches, w.launches_by_route[route]) for w in wrappers] == [
        (n + 1, r + 1) for n, r in before]
    assert _rel(out, want_out) < fwd_tol and _rel(out_s, want_out) < fwd_tol
    assert _rel(lse, want_lse) < 2e-5
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        assert got.shape == want.shape == (32, 1024, 96)
        assert _close(got, want, bwd_tol), name


@pytest.mark.gpu
def test_phi3_mini_prefill_at_head_dim_96_on_card():
    """phi3-mini at a reduced width and depth with its head dim kept at 96,
    bf16: the prefill through the flash kernel (one launch a layer, all
    wgmma) against the same model through the eager chunked attention."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model_zoo import build_model
    dev = _cuda()
    cfg = get_config("phi3-mini-3.8b").reduced().with_(
        remat="none", num_layers=3, head_dim=96, num_heads=8, num_kv_heads=8,
        param_dtype="bfloat16")
    model = build_model(cfg.with_(attn_impl="pallas"), dev)
    eager = build_model(cfg.with_(attn_impl="xla"), dev)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(3))
    toks = torch.randint(0, cfg.vocab_size, (2, 200), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_fwd.launches_by_route["wgmma"])
    got = model.forward(params, {"tokens": toks})[0]
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_fwd.launches_by_route["wgmma"]) == (
        before[0] + 3, before[1] + 3)
    want = eager.forward(params, {"tokens": toks})[0]
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) < 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize("S", [4, 5, 7, 8])
@pytest.mark.parametrize("BH,hd", [(12, 64), (32, 96), (32, 128), (64, 128)])
def test_flash_fwd_at_cluster_prefill_shapes_on_card(BH, hd, S):
    """The cluster scheduler's live prefills (one request of 4-8 tokens, the
    heads of gpt2-124m, phi3-mini-3.8b, llama3-8b and qwen3-32b after
    expand_kv): one ragged tile, causal, bf16 on the wgmma route, against
    the plain version under 2e-2."""
    from repro_torch.kernels import flash_attention as fa
    dev = _cuda()
    q, k, v, _ = _flash_inputs(dev, torch.bfloat16, BH, S, S, hd, BH + S + hd)
    before = fa.flash_attention_fwd.launches_by_route["wgmma"]
    got = fa.flash_attention_fwd(q, k, v, causal=True)
    want = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches_by_route["wgmma"] == before + 1
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) < 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cv_autograd_on_card(dtype):
    """flash_attention_cv (kernel forward and backward under autograd, heads
    folded from (B, S, H, hd), a non-contiguous dout) against autograd of
    the eager chunked attention."""
    from repro_torch.models.attention import flash_attention, flash_attention_cv
    dev = _cuda()
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    g = torch.Generator(device=dev).manual_seed(5)
    B, S, H, hd = 2, 256, 4, 64
    q, k, v = (torch.randn(B, S, H, hd, device=dev, generator=g).to(dtype)
               .requires_grad_() for _ in range(3))
    w = torch.randn(B, H, S, hd, device=dev, generator=g).permute(0, 2, 1, 3)
    loss_k = (flash_attention_cv(q, k, v, True, 64, hd ** -0.5).float() * w).sum()
    loss_e = (flash_attention(q, k, v, causal=True, chunk=64).float() * w).sum()
    gk = torch.autograd.grad(loss_k, (q, k, v))
    ge = torch.autograd.grad(loss_e, (q, k, v))
    for a, b in zip(gk, ge):
        assert _rel(a, b) < tol


@pytest.mark.gpu
def test_train_step_on_card():
    """One make_train_step step of a reduced gpt2 on the card through the
    kernels (attn_impl="xla_cv", remat="layer"): the launches follow the
    step's structure, the loss and gradients equal the CPU step's (fp32,
    plain versions there), and the step changes the parameters."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSuite, TRAIN
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (TrainStepConfig, _accumulate_grads,
                                              make_train_step)
    dev = _cuda()
    cfg = get_config("gpt2-124m").reduced().with_(
        attn_impl="xla_cv", remat="layer", dtype="float32")
    model = build_model(cfg, dev)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = model.synthetic_batch(ShapeSuite("t", TRAIN, 64, 4),
                                  torch.Generator(device=dev).manual_seed(1))
    cpu = build_model(cfg, "cpu")
    to_cpu = lambda t: {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()
    loss_c, grads_c = _accumulate_grads(cpu, to_cpu(params), to_cpu(batch), 1)
    counts = lambda: (fa.flash_attention_fwd_stats.launches,
                      fa.flash_attention_bwd_dkdv.launches,
                      fa.flash_attention_bwd_dq.launches)
    before = counts()
    loss_g, grads_g = _accumulate_grads(model, params, batch, 1)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert tuple(a - b for a, b in zip(counts(), before)) == (2 * L, L, L)
    assert abs(float(loss_g) - float(loss_c)) < 1e-5 * abs(float(loss_c))
    for (name, a), (_, b) in zip(to_cpu(grads_g)["layers"].items(),
                                 grads_c["layers"].items()):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-6, name
    step = make_train_step(model, TrainStepConfig(opt=adamw.AdamWConfig()))
    old = params["layers"]["wq"].clone()
    params, opt, met = step(params, adamw.init(params), batch)
    assert torch.isfinite(met["loss"]) and int(opt.step) == 1
    assert not torch.equal(old, params["layers"]["wq"])


def _ssd_inputs(dev, dtype, B, S, nh, hp, N, seed, with_state=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (0.5 * torch.randn(B, S, nh, hp, device=dev, generator=g)).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, nh, device=dev, generator=g))
    A = -torch.exp(0.3 * torch.randn(nh, device=dev, generator=g))
    B_, C_ = ((0.3 * torch.randn(B, S, N, device=dev, generator=g)).to(dtype)
              for _ in range(2))
    s0 = (0.5 * torch.randn(B, nh, hp, N, device=dev, generator=g)
          if with_state else None)
    return x, dt, A, B_, C_, s0


SSD_CASES = [  # (B, S, nh, hp, N, init_state)
    (1, 1024, 24, 64, 128, False),   # mamba2-130m's prefill
    (1, 1000, 24, 64, 128, False),   # ragged S
    (1, 300, 64, 64, 64, True),      # zamba2-1.2b's heads, a carried state
    (2, 256, 8, 32, 64, True),       # the reference's shapes
    (1, 128, 2, 64, 128, False),
    (3, 5, 8, 16, 16, True),         # one short chunk, reduced widths
    (1, 4096, 24, 64, 128, False),   # 64 chunks
    (1, 4096, 64, 64, 64, True),
    (1, 65, 24, 64, 128, True),      # one chunk and one row
    (2, 40, 6, 64, 128, False),      # S below one chunk
    (3, 200, 6, 48, 32, True),       # three batches, hp not a multiple of 64
    (3, 130, 5, 16, 16, False),      # an odd head count: one head a block
    (1, 100, 2, 128, 256, True),     # the widest state the kernels take
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hp,N,with_state", SSD_CASES)
def test_ssd_scan_matches_plain_on_card(B, S, nh, hp, N, with_state, dtype):
    """The SSD kernel against its plain version: y within fp32 1e-4 (the
    reference's) or bf16 2e-2 (one rounding of the output), the final state
    within 1e-4 in both (summed in fp32)."""
    from repro_torch.kernels import ssd_scan as ssd
    dev = _cuda()
    x, dt, A, B_, C_, s0 = _ssd_inputs(dev, dtype, B, S, nh, hp, N, seed=S + nh,
                                       with_state=with_state)
    before = ssd.ssd_scan.launches
    y, st = ssd.ssd_scan(x, dt, A, B_, C_, init_state=s0, return_state=True)
    want_y, want_st = ssd.ssd_scan_plain(x, dt, A, B_, C_, init_state=s0,
                                         return_state=True)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1
    assert y.dtype == dtype and st.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    assert _rel(y, want_y) < {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    assert _rel(st, want_st) < 1e-4
    y_only = ssd.ssd_scan(x, dt, A, B_, C_, init_state=s0)
    assert torch.equal(y_only, y)


@pytest.mark.gpu
def test_ssd_scan_rejects_what_it_cannot_take():
    from repro_torch.kernels import ssd_scan as ssd
    dev = _cuda()
    x, dt, A, B_, C_, _ = _ssd_inputs(dev, torch.bfloat16, 1, 64, 4, 32, 64, 0)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt.bfloat16(), A, B_, C_)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt, A, B_.float(), C_)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B_, C_)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd.ssd_scan(x[..., :24].contiguous(), dt, A, B_, C_)
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt, A, B_.cpu(), C_)


@pytest.mark.gpu
def test_apply_ssm_prefill_launches_the_kernel():
    """A CUDA prefill of a reduced mamba2 goes through the kernel (one
    launch per layer) and equals the same model on the CPU (fp32, plain
    ``ssd_chunked`` there)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.model_zoo import build_model
    dev = _cuda()
    cfg = get_config("mamba2-130m").reduced().with_(remat="none", dtype="float32")
    model = build_model(cfg, dev)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 100), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    before = ssd.ssd_scan.launches
    logits, _, cache = model.forward(params, {"tokens": toks}, return_cache=True)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches - before == cfg.num_layers
    cpu = build_model(cfg, "cpu")
    cparams = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
                   else v.cpu()) for k, v in params.items()}
    want, _, wcache = cpu.forward(cparams, {"tokens": toks.cpu()}, return_cache=True)
    assert _rel(logits.cpu(), want) < 1e-4
    assert _rel(cache["ssm"].state.cpu(), wcache["ssm"].state) < 1e-4


# ---------------------------------------------------------------------------
# grouped_matmul (MoE expert products)
# ---------------------------------------------------------------------------
GMM_CASES = [  # (E, M, K, N, x expert stride 0, bf16 takes the wgmma route)
    (2, 128, 128, 128, False, True),        # the reference's shapes
    (4, 256, 128, 384, False, True),
    (1, 128, 256, 128, False, True),
    (32, 320, 1024, 512, False, True),      # granite-moe's prefill at 1024 tokens
    (1, 320, 1024, 512, False, True),
    (32, 4, 1024, 512, True, True),         # granite-moe's decode: one shared x
    (32, 4, 512, 1024, False, True),        # its w_out
    (32, 1, 1024, 512, True, True),         # one slot
    (32, 16, 1024, 512, True, True),
    (32, 17, 1024, 520, False, True),       # one row past a 16-row tile
    (32, 64, 512, 1024, False, True),       # the last M of the 64 x 64 tiles
    (5, 77, 200, 96, False, True),          # ragged C; K, N off the tile
    (1, 65, 72, 40, True, True),            # N below one tile, shared x
    (3, 33, 70, 50, True, False),           # ragged everywhere, shared x
    (4, 8, 100, 64, False, False),          # x's rows not 16-byte multiples
    (16, 1, 4096, 6400, True, True),        # phi3.5-moe's widths, one row
    (16, 160, 4096, 6400, False, True),     # its prefill at 1024 tokens (C 160)
    (16, 4, 6400, 4096, False, True),       # its decode w_out
]


def _gmm_inputs(dev, E, M, K, N, shared, dtype, seed=0, layout="kn"):
    """x (E, M, K) (one expanded (M, K) buffer when shared); w (E, K, N),
    row-major ("kn") or the transposed view of an (E, N, K) stack ("nk")."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(1 if shared else E, M, K, device=dev, generator=g).to(dtype)
    shape = (E, N, K) if layout == "nk" else (E, K, N)
    w = (torch.randn(*shape, device=dev, generator=g) * K ** -0.5).to(dtype)
    return (x.expand(E, M, K) if shared else x), (
        w.transpose(1, 2) if layout == "nk" else w)


def _pinned(w):
    """The same stack in pinned host memory, in the same layout."""
    if w.stride(1) == 1 and w.stride(2) != 1:
        return w.transpose(1, 2).cpu().pin_memory().transpose(1, 2)
    return w.cpu().pin_memory()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("where", ["device", "pinned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,K,N,shared,tma", GMM_CASES)
def test_grouped_matmul_matches_plain(E, M, K, N, shared, tma, dtype, where,
                                     layout, monkeypatch):
    """The kernel against its plain version, w on the card or streamed from
    pinned host memory (every byte once per call) in panels of several whole
    experts (``BLOCK_K``), of one (``K``), and of 64 rows of one; each call
    counted on the route the shape rule names: fp32 x -> fma, bf16 whose
    operands a TMA descriptor takes -> wgmma, any other bf16 -> mma_sync."""
    from repro_torch.kernels import grouped_matmul as gmm
    dev = _cuda()
    x, w = _gmm_inputs(dev, E, M, K, N, shared, dtype, seed=E + M + K,
                       layout=layout)
    want = gmm.grouped_matmul_plain(x, w)
    wk = w if where == "device" else _pinned(w)
    route = ("fma" if dtype == torch.float32 else
             "wgmma" if tma else "mma_sync")
    for block_k in (gmm.BLOCK_K, K, 64):
        monkeypatch.setattr(gmm, "BLOCK_K", block_k)
        before = (gmm.grouped_matmul.launches, gmm.grouped_matmul.h2d_bytes,
                  dict(gmm.grouped_matmul.launches_by_route))
        got = gmm.grouped_matmul(x, wk)
        torch.cuda.synchronize()
        assert gmm.grouped_matmul.launches == before[0] + 1
        assert {r: n - before[2][r] for r, n in
                gmm.grouped_matmul.launches_by_route.items()} == {
            r: int(r == route) for r in gmm.ROUTES}, block_k
        streamed = gmm.grouped_matmul.h2d_bytes - before[1]
        assert streamed == (w.numel() * w.element_size() if where == "pinned" else 0)
        assert got.dtype == dtype and tuple(got.shape) == (E, M, N)
        assert torch.isfinite(got.float()).all()
        assert _rel(got, want) < TOL[dtype], block_k


@pytest.mark.gpu
@pytest.mark.parametrize("M,shared", [(4, True), (160, False)])
def test_grouped_matmul_streams_a_host_tier_stack(M, shared):
    """phi3.5-moe's gate stack at its decode (one shared x) and 1024-token
    prefill rows, w in the host tier's own memory (``core.offload.
    empty_host``: registered pages of exactly its bytes, as the runtime
    places a spilled stack): every byte streamed once, on the wgmma route,
    equal to the plain version on the card's copy."""
    from repro_torch.core.offload import to_host
    from repro_torch.kernels import grouped_matmul as gmm
    dev = _cuda()
    x, w = _gmm_inputs(dev, 16, M, 4096, 6400, shared, torch.bfloat16, seed=M)
    host = to_host(w, dev)
    assert host.is_pinned() and host[0].is_pinned()
    before = (gmm.grouped_matmul.h2d_bytes,
              gmm.grouped_matmul.launches_by_route["wgmma"])
    got = gmm.grouped_matmul(x, host)
    torch.cuda.synchronize()
    assert gmm.grouped_matmul.h2d_bytes - before[0] == w.numel() * 2
    assert gmm.grouped_matmul.launches_by_route["wgmma"] == before[1] + 1
    assert torch.isfinite(got.float()).all()
    assert _rel(got, gmm.grouped_matmul_plain(x, w)) < TOL[torch.bfloat16]


# a rank's local experts under expert parallelism on the 16x16 mesh, at
# capacity rows cut from the mesh cells' 10,240: granite-moe's 2 of 32
# (w_in / w_gate, then w_out), phi3.5-moe's 1 of 16, and its decode's one
# shared x
GMM_LOCAL_CASES = [  # (E_local, M, K, N, x expert stride 0)
    (2, 1280, 1024, 512, False),
    (2, 1280, 512, 1024, False),
    (1, 1280, 4096, 6400, False),
    (1, 1280, 6400, 4096, False),
    (1, 8, 4096, 6400, True),
    (2, 4, 1024, 512, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("E,M,K,N,shared", GMM_LOCAL_CASES)
def test_grouped_matmul_on_a_ranks_local_experts(E, M, K, N, shared):
    """B6 on the stacks one rank holds under expert parallelism (E = 1 and
    E = 2: the experts of model rank 1, a contiguous slice of a larger
    stack, as a shard of it is), in bf16 on the wgmma route, against its
    plain version: the forward, and for a routed x its backward through the
    autograd Function (``dx`` on w's transposed view, ``dw`` on x's)."""
    from repro_torch.kernels import grouped_matmul as gmm
    dev = _cuda()
    x, w_all = _gmm_inputs(dev, 2 * E, M, K, N, shared, torch.bfloat16,
                           seed=E + M + K)
    x, w = x[:E], w_all[E:]
    before = (gmm.grouped_matmul.launches,
              gmm.grouped_matmul.launches_by_route["wgmma"])
    got = gmm.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert gmm.grouped_matmul.launches == before[0] + 1
    assert gmm.grouped_matmul.launches_by_route["wgmma"] == before[1] + 1
    assert tuple(got.shape) == (E, M, N) and torch.isfinite(got.float()).all()
    assert _rel(got, gmm.grouped_matmul_plain(x, w)) < TOL[torch.bfloat16]
    if shared:
        return
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
    xp, wp = x.detach().requires_grad_(), w.detach().requires_grad_()
    dy = torch.randn(E, M, N, device=dev).to(torch.bfloat16)
    gmm.grouped_matmul(xg, wg).backward(dy)
    torch.einsum("emk,ekn->emn", xp.float(), wp.float()).backward(dy.float())
    assert gmm.grouped_matmul.launches == before[0] + 4
    assert _rel(xg.grad, xp.grad) < TOL[torch.bfloat16]
    assert _rel(wg.grad, wp.grad) < TOL[torch.bfloat16]


@pytest.mark.gpu
def test_grouped_matmul_misaligned_base_takes_mma_sync():
    """An x whose base is not 16-byte aligned cannot be described by a TMA
    descriptor: the plan sends it to the mma.sync kernel, which matches."""
    from repro_torch.kernels import grouped_matmul as gmm
    dev = _cuda()
    _, w = _gmm_inputs(dev, 4, 8, 64, 64, False, torch.bfloat16)
    # every stride a multiple of 8 elements, the base 2 bytes past an
    # aligned one
    x = torch.randn(4 * 8 * 64 + 1, device=dev).to(torch.bfloat16)[1:].view(4, 8, 64)
    before = dict(gmm.grouped_matmul.launches_by_route)
    got = gmm.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert gmm.grouped_matmul.launches_by_route["mma_sync"] == before["mma_sync"] + 1
    assert _rel(got, gmm.grouped_matmul_plain(x, w)) < TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["gmm_decode", "gmm_prefill", "gmm_pinned",
                                  "flash", "flash_stats", "flash_bwd",
                                  "stream_ring", "stream_ring_nk",
                                  "stream_prefill", "stream_resident", "ssd",
                                  "ssd_fp32"])
def test_bf16_kernels_are_bit_identical_across_runs(what):
    """No atomics, no split reduction in a changing order: the same bf16
    inputs give the same bits twice."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gmm
    dev = _cuda()
    if what.startswith("stream"):
        M = 300 if what == "stream_prefill" else 4
        x, w = _inputs(M, 4096, 14336, torch.bfloat16, torch.bfloat16)
        x = x.to(dev)
        if what == "stream_ring_nk":
            w = w.T.contiguous().pin_memory().T
        else:
            w = w.to(dev) if what == "stream_resident" else w.pin_memory()
        run = lambda: sm.stream_matmul(x, w)
    elif what.startswith("ssd"):
        from repro_torch.kernels import ssd_scan as ssd
        dtype = torch.float32 if what == "ssd_fp32" else torch.bfloat16
        x, dt, A, B_, C_, s0 = _ssd_inputs(dev, dtype, 2, 1000, 24, 64, 128, 5,
                                           with_state=True)
        run = lambda: ssd.ssd_scan(x, dt, A, B_, C_, init_state=s0,
                                   return_state=True)
    elif what.startswith("gmm"):
        M, shared = (320, False) if what == "gmm_prefill" else (4, True)
        x, w = _gmm_inputs(dev, 32, M, 1024, 512, shared, torch.bfloat16)
        w = _pinned(w) if what == "gmm_pinned" else w
        run = lambda: gmm.grouped_matmul(x, w)
    else:
        q, k, v, do = _flash_inputs(dev, torch.bfloat16, 8, 1000, 1000, 128, 3)
        if what == "flash_bwd":             # dq, dk, dv
            out, lse = fa.flash_attention_fwd_stats(q, k, v)
            run = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do)
        elif what == "flash_stats":
            run = lambda: fa.flash_attention_fwd_stats(q, k, v)
        else:
            run = lambda: fa.flash_attention_fwd(q, k, v)
    a, b = run(), run()
    torch.cuda.synchronize()
    for u, v_ in zip(a if isinstance(a, tuple) else (a,),
                     b if isinstance(b, tuple) else (b,)):
        assert torch.equal(u, v_)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["device", "pinned"])
def test_grouped_matmul_never_reaches_a_library_product(monkeypatch, where):
    """The CUDA route launches the kernel: with torch.bmm, torch.matmul,
    torch.einsum and the ``@`` operator made to raise, it still runs."""
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.models.common import weight_matmul
    dev = _cuda()
    x, w = _gmm_inputs(dev, 4, 40, 64, 96, False, torch.bfloat16)
    want = gmm.grouped_matmul_plain(x, w)
    wk = w if where == "device" else w.cpu().pin_memory()

    def refuse(*a, **k):
        raise AssertionError("a library product was called")
    for name in ("bmm", "matmul", "einsum", "baddbmm"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    got = weight_matmul(x, wk)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert _rel(got, want) < TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_raises_under_autograd_and_on_pageable_w(dtype):
    """Under autograd a stack on the device goes through the kernel's
    Function: out, dx and dw (each one more launch, by the route the plan
    gives bf16 or fp32) equal autograd through the plain version. A pinned
    stack still raises under autograd, a pageable one always."""
    from repro_torch.kernels import grouped_matmul as gmm
    dev = _cuda()
    x0, w0 = _gmm_inputs(dev, 4, 320, 256, 128, False, dtype)
    dy = torch.randn(4, 320, 128, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(5)).to(dtype)
    res = []
    for fn in (gmm.grouped_matmul, gmm.grouped_matmul_plain):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        before = gmm.grouped_matmul.launches
        out = fn(x, w)
        dx, dw = torch.autograd.grad(out, [x, w], dy)
        torch.cuda.synchronize()
        res.append((out.detach(), dx, dw, gmm.grouped_matmul.launches - before))
    assert res[0][3] == 3 and res[1][3] == 0
    for got, want in zip(res[0][:3], res[1][:3]):
        assert got.dtype == dtype and _rel(got, want) < TOL[dtype]
    with pytest.raises(RuntimeError, match="pinned"):
        gmm.grouped_matmul(x0.clone().requires_grad_(), _pinned(w0))
    with torch.no_grad():
        assert gmm.grouped_matmul(x0, _pinned(w0)).shape == (4, 320, 128)
    with pytest.raises(ValueError, match="pageable"):
        gmm.grouped_matmul(x0, w0.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E,C,d,f", [(32, 320, 1024, 512), (4, 77, 200, 96),
                                     (2, 64, 64, 64), (3, 40, 72, 24),
                                     (1, 130, 136, 8)])
def test_grouped_matmul_transposed_x_matches_plain(E, C, d, f, dtype):
    """dw[e] = x[e]^T dy[e] as the backward runs it: bf16 reads x's
    transposed view (the wgmma kernel's transposed A, 64 x 64 tiles up to 64
    rows, 128 x 128 above, ragged edges), copying nothing; fp32 copies it
    dense (counted) for the FMA kernel. Both against the plain product."""
    from repro_torch.kernels import grouped_matmul as gmm
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(E + C + d)
    x = torch.randn(E, C, d, device=dev, generator=g).to(dtype)
    dy = torch.randn(E, C, f, device=dev, generator=g).to(dtype)
    before = (gmm.grouped_matmul.transpose_bytes,
              dict(gmm.grouped_matmul.launches_by_route))
    xt = gmm.transposed_x(x, dy)
    got = gmm._launch(xt, dy)
    want = gmm.grouped_matmul_plain(x.transpose(1, 2), dy)
    torch.cuda.synchronize()
    copied = gmm.grouped_matmul.transpose_bytes - before[0]
    routes = {r: n - before[1][r]
              for r, n in gmm.grouped_matmul.launches_by_route.items()}
    assert got.shape == (E, d, f) and _rel(got, want) < TOL[dtype]
    if dtype == torch.bfloat16:
        assert copied == 0 and xt.stride(1) == 1
        assert routes == {"wgmma": 1, "mma_sync": 0, "fma": 0}
    else:
        assert copied == x.numel() * 4 and xt.is_contiguous()
        assert routes == {"wgmma": 0, "mma_sync": 0, "fma": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,nh,hp,N", [(2, 256, 24, 64, 128),
                                         (1, 300, 64, 64, 64)])
def test_ssd_autograd_on_card(B, S, nh, hp, N):
    """The SSD Function with the kernel as its forward (one launch) against
    autograd through the plain ``ssd_chunked`` on the card (fp32, 1e-4)."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import ssm
    dev = _cuda()
    ins = _ssd_inputs(dev, torch.float32, B, S, nh, hp, N, 7)[:5]
    dy = torch.randn(B, S, nh, hp, device=dev)
    res = []
    for fn in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in ins]
        before = ssd.ssd_scan.launches
        y, _ = (ssm.ssd_autograd(ssm.ssd_kernel, *leaves, 128) if fn == "kernel"
                else ssm.ssd_chunked(*leaves, 128))
        grads = torch.autograd.grad(y, leaves, dy)
        torch.cuda.synchronize()
        res.append(((y,) + grads, ssd.ssd_scan.launches - before))
    assert res[0][1] == 1 and res[1][1] == 0
    for got, want in zip(res[0][0], res[1][0]):
        assert _rel(got, want) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b",
                                  "granite-moe-1b-a400m", "whisper-large-v3",
                                  "qwen2-vl-72b"])
def test_family_loss_and_grads_through_kernels_equal_cpu(arch):
    """One loss and gradient of a reduced model on the card through the
    kernels (the SSD Function, the grouped matmul Function, the flash
    forward and backward by ``xla_cv``), fp32, remat "layer", against the
    same weights and batch on the CPU (plain versions there): loss 1e-5,
    each gradient leaf 1e-4 of its largest value plus 1e-6 (the key biases,
    zero in exact arithmetic)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import _accumulate_grads
    dev = _cuda()
    cfg = get_config(arch).reduced().with_(attn_impl="xla_cv", remat="layer",
                                           dtype="float32")
    model = build_model(cfg, dev)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 97), generator=g, device=dev)
    batch = {"labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["embeds"] = 0.02 * torch.randn(2, 96, cfg.d_model, generator=g,
                                             device=dev)
        batch["positions"] = torch.arange(96, device=dev).expand(3, 2, 96)
    else:
        batch["tokens"] = toks[:, :-1]
    if cfg.family == "encdec":
        batch["frames"] = 0.02 * torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                             generator=g, device=dev)
    loss_g, grads_g = _accumulate_grads(model, params, batch, 1)
    cpu = build_model(cfg, "cpu")
    to_cpu = lambda tree: tree_unflatten(tree, [t.cpu() for t in tree_leaves(tree)])
    loss_c, grads_c = _accumulate_grads(cpu, to_cpu(params), to_cpu(batch), 1)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for a, b in zip(tree_leaves(grads_g), tree_leaves(grads_c)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-6


@pytest.mark.gpu
def test_moe_model_launches_the_kernel_and_equals_cpu():
    """A reduced granite-moe on the card (fp32): a prefill launches the
    kernel three times a layer (w_in, w_gate, w_out), so does a decode step
    (one shared x), and the logits equal the same model's on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.models.model_zoo import build_model
    dev = _cuda()
    cfg = get_config("granite-moe-1b-a400m").reduced().with_(remat="none",
                                                            dtype="float32")
    model = build_model(cfg, dev)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    before = gmm.grouped_matmul.launches
    logits, aux, cache = model.forward(params, {"tokens": toks}, return_cache=True)
    torch.cuda.synchronize()
    assert gmm.grouped_matmul.launches - before == 3 * cfg.num_layers
    big = model.init_cache(2, 64, torch.float32)
    for name in ("k", "v"):
        big[name][:, :, :40] = cache[name]
    before = gmm.grouped_matmul.launches
    dec, _ = model.decode(params, big, {"tokens": toks[:, -1:],
                                        "pos": torch.tensor(40, device=dev)})
    torch.cuda.synchronize()
    assert gmm.grouped_matmul.launches - before == 3 * cfg.num_layers
    cpu = build_model(cfg, "cpu")
    cparams = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
                   else v.cpu()) for k, v in params.items()}
    want, want_aux, _ = cpu.forward(cparams, {"tokens": toks.cpu()})
    assert _rel(logits.cpu(), want) < 1e-4
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)


def _gate_spilling_budget(cfg, slots, max_seq):
    """The budget of ``cfg``'s resident bytes once the table, the KV pool
    and ``layers/w_gate`` are on the host (the moe_full phase's plan)."""
    from repro_torch.models.model_zoo import build_model
    model = build_model(cfg, "cpu")
    inv = model.serving_inventory(model.init(abstract=True)[0],
                                  model.cache_shapes(slots, max_seq))
    return sum(t.bytes for t in inv if t.name not in (
        "params/tok_embed", "kv/k", "kv/v", "params/layers/w_gate"))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-reduced", "phi3.5-moe-2-layers"])
def test_runtime_streams_offloaded_experts(arch):
    """A MoE tenant whose budget spills an expert stack: reduced granite-moe,
    and phi3.5-moe at full width and 2 of its 32 layers with the table, the
    KV pool and ``layers/w_gate`` spilled (its full-size plan). The stack
    lives in pinned memory (so do its per-layer slices), every prefill and
    tick streams it once a layer through grouped_matmul, and the tokens
    equal a lone engine's with every weight on the device (fp32)."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload import memory_kind_of
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.serving import Request, SliceRuntime, TenantEngine, TenantSpec
    dev = _cuda()
    if arch == "granite-moe-reduced":
        cfg = get_config("granite-moe-1b-a400m").reduced().with_(
            remat="none", dtype="float32")
        budget = dict(hbm_budget=300_000, spill_granule=4096)
    else:
        cfg = get_config("phi3.5-moe-42b-a6.6b").with_(
            num_layers=2, remat="none", dtype="float32")
        budget = dict(hbm_budget=_gate_spilling_budget(cfg, 2, 48))
    rt = SliceRuntime(device=dev)
    t = rt.add_tenant(TenantSpec("moe", cfg, profile="1s.16c", slots=2,
                                 max_seq=48, **budget))
    spilled = [n for n in t.plan.offloaded
               if n in ("params/layers/w_gate", "params/layers/w_in",
                        "params/layers/w_out")]
    assert spilled, t.plan.offloaded
    if arch != "granite-moe-reduced":
        assert sorted(t.plan.offloaded) == sorted(
            ("params/tok_embed", "kv/k", "kv/v", "params/layers/w_gate"))
        assert t.engine.pool.memory_kinds() == {"pinned_host"}
    stacks = [t.params["layers"][n.split("/")[-1]] for n in spilled]
    for s in stacks:
        assert memory_kind_of(s) == "pinned_host" and s.is_pinned()
        assert s[0].is_pinned() and s[0].dim() == 3
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=9).astype(np.int32), 4)
            for i in range(3)]
    launches, streamed = gmm.grouped_matmul.launches, gmm.grouped_matmul.h2d_bytes
    rt.submit("moe", reqs)
    rt.run()
    stats = t.engine.stats
    passes = stats.admitted + stats.ticks
    assert gmm.grouped_matmul.launches - launches == 3 * cfg.num_layers * passes
    assert gmm.grouped_matmul.h2d_bytes - streamed == passes * cfg.num_layers * sum(
        s[0].numel() * s.element_size() for s in stacks)
    on_device = {k: (v.to(dev) if torch.is_tensor(v) else
                     {kk: vv.to(dev) for kk, vv in v.items()})
                 for k, v in t.params.items()}
    resident = TenantEngine(t.model, on_device, slots=2, max_seq=48)
    again = [Request(r.rid, r.prompt, 4) for r in reqs]
    assert resident.run(again) == t.engine.outputs


def _flash_prefill_vs_eager(arch, make_batch):
    """A reduced ``arch`` on the card (fp32): one forward with
    ``attn_impl="pallas"`` launches the flash forward once a decoder layer,
    and its logits and cache equal the same weights' with the eager flash."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model_zoo import build_model
    dev = _cuda()
    cfg = get_config(arch).reduced().with_(remat="none", dtype="float32",
                                           attn_impl="pallas")
    model = build_model(cfg, dev)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = make_batch(cfg, dev, torch.Generator(device=dev).manual_seed(1))
    before = fa.flash_attention_fwd.launches
    logits, _, cache = model.forward(params, batch, return_cache=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches - before == cfg.num_layers
    eager = build_model(cfg.with_(attn_impl="xla"), dev)
    want, _, want_cache = eager.forward(params, batch, return_cache=True)
    assert torch.isfinite(logits).all()
    assert _rel(logits, want) < 1e-4
    for name in cache:
        assert _rel(cache[name], want_cache[name]) < 1e-4, name


@pytest.mark.gpu
def test_encdec_decoder_prefill_through_the_flash_kernel():
    """whisper: the decoder's causal self-attention takes the kernel; the
    encoder's and the cross attention (not causal) take the eager flash."""
    def batch(cfg, dev, g):
        return {"frames": 0.02 * torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                             generator=g, device=dev),
                "tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                        generator=g, device=dev)}
    _flash_prefill_vs_eager("whisper-large-v3", batch)


@pytest.mark.gpu
def test_vlm_prefill_through_the_flash_kernel():
    """qwen2-vl: input embeddings and three M-RoPE streams that differ."""
    def batch(cfg, dev, g):
        return {"embeds": 0.02 * torch.randn(2, 40, cfg.d_model, generator=g,
                                             device=dev),
                "positions": torch.stack([
                    torch.randint(lo, lo + 40, (2, 40), generator=g, device=dev)
                    for lo in (0, 100, 1000)])}
    _flash_prefill_vs_eager("qwen2-vl-72b", batch)


@pytest.mark.gpu
def test_flash_fwd_at_llama3_prefill_32k_on_card():
    """The dry run's llama3-8b prefill_32k cell sends 32,768-token rows
    through the forward kernel; two heads here (the plain scores of a few
    heads fit), bf16 causal, against the plain version under 2e-2."""
    from repro_torch.kernels import flash_attention as fa
    dev = _cuda()
    q, k, v, _ = _flash_inputs(dev, torch.bfloat16, 2, 32768, 32768, 128, 5)
    got = fa.flash_attention_fwd(q, k, v, causal=True)
    want = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) < 2e-2


@pytest.mark.gpu
def test_count_step_launches_equal_the_wrappers_counts_on_card():
    """``count_step`` over a reduced bf16 training step of granite-moe (flash
    forward with lse, both backward kernels, grouped_matmul forward and
    backward) and a mamba2 prefill (ssd_scan): the count's launches by kernel
    equal the wrappers' launch deltas, and every bf16 flash and grouped_matmul
    launch takes wgmma. An H2D copy goes to host_bytes."""
    from repro_torch.configs import get_config
    from repro_torch.core.step_analysis import count_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import _accumulate_grads
    dev = _cuda()
    wrappers = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_fwd_stats": fa.flash_attention_fwd_stats,
                "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "ssd_scan": ssd.ssd_scan, "grouped_matmul": gmm.grouped_matmul}
    g = torch.Generator(device=dev).manual_seed(0)
    moe = build_model(get_config("granite-moe-1b-a400m").reduced()
                      .with_(attn_impl="xla_cv"), dev)
    mp, _ = moe.init(g)
    toks = torch.randint(0, moe.cfg.vocab_size, (2, 64), generator=g, device=dev)
    ssm = build_model(get_config("mamba2-130m").reduced()
                      .with_(param_dtype="bfloat16"), dev)
    sp, _ = ssm.init(g)
    steps = (lambda: _accumulate_grads(moe, mp, {"tokens": toks,
                                                 "labels": toks}, 1),
             lambda: ssm.forward(sp, {"tokens": toks}, last_token_only=True))
    for step in steps:
        before = {n: w.launches for n, w in wrappers.items()}
        _, cost = count_step(step)
        torch.cuda.synchronize()
        deltas = {n: w.launches - before[n] for n, w in wrappers.items()
                  if w.launches != before[n]}
        assert deltas and cost.kernel_launches == deltas
        for name, routes in cost.kernel_launches_by_route.items():
            if name != "ssd_scan":
                assert set(routes) == {"wgmma"}, (name, routes)
        assert cost.kernel_flops > 0 and cost.flops > cost.kernel_flops
    x = torch.ones(1024, 256)
    _, cost = count_step(lambda: x.to(dev))
    assert cost.host_bytes == 1024 * 256 * 4 and cost.bytes_accessed == 0


def _mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _settled_mem_available() -> int:
    """MemAvailable once two readings a second apart differ by under
    64 MiB: a freed pinned buffer's pages come back over seconds."""
    import time
    last = _mem_available_bytes()
    for _ in range(120):
        time.sleep(1.0)
        now = _mem_available_bytes()
        if abs(now - last) < (64 << 20):
            return now
        last = now
    raise AssertionError("MemAvailable did not settle in 120 s")


PLACED_ARCHS = ["qwen2-vl-72b", "llama3-8b", "granite-moe-1b-a400m",
                "zamba2-1.2b", "whisper-large-v3"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", PLACED_ARCHS)
def test_placed_init_equals_init_then_place_tree(arch):
    """Full width, 2 layers, bf16 weights, a budget of half the footprint:
    the placed draw equals ``init`` followed by ``place_tree`` bit for bit;
    every host leaf, and each layer view of a host stack, is pinned; the
    device held at most the resident bytes and the largest host leaf."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ENCDEC
    from repro_torch.core.offload import (PINNED_HOST_KIND, _flatten_with_paths,
                                          memory_kind_of, param_placement,
                                          place_tree, plan_offload)
    from repro_torch.models.model_zoo import build_model
    dev = _cuda()
    cfg = get_config(arch).with_(num_layers=2, param_dtype="bfloat16",
                                 remat="none")
    if cfg.family == ENCDEC:
        cfg = cfg.with_(encoder_layers=2)
    model = build_model(cfg, dev)
    shapes, _ = model.init(abstract=True)
    inv = model.serving_inventory(shapes, model.cache_shapes(2, 64))
    plan = plan_offload(inv, sum(t.bytes for t in inv) // 2)
    placement = param_placement(shapes, plan, dev)
    sizes = {p: t.numel() * t.element_size()
             for p, t in _flatten_with_paths(shapes)}
    host = {p for p, kind in placement.items() if kind == PINNED_HOST_KIND}
    assert host, plan
    gc.collect()                      # earlier tests' tensors, freed first
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    placed, _ = model.init(torch.Generator(device=dev).manual_seed(3),
                           placement=placement)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    resident = sum(b for p, b in sizes.items() if p not in host)
    # the device allocator hands out a cached block unsplit when under
    # 1 MiB would be left over
    rounding = (1 << 20) * len(sizes)
    assert peak <= resident + max(sizes[p] for p in host) + rounding
    want = place_tree({"params": model.init(
        torch.Generator(device=dev).manual_seed(3))[0]}, plan, dev)["params"]
    got_leaves, want_leaves = (_flatten_with_paths(placed),
                               _flatten_with_paths(want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, got), (_, ref) in zip(got_leaves, want_leaves):
        assert memory_kind_of(got) == memory_kind_of(ref) == placement[path]
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert torch.equal(got.view(torch.uint8).cpu(),
                           ref.view(torch.uint8).cpu()), path
        if path in host:
            assert got.is_pinned() and (got.dim() < 3 or got[1].is_pinned())


@pytest.mark.gpu
def test_empty_host_reserves_its_own_bytes():
    """A pinned buffer of 3 GiB + 1 MiB + 6 bytes takes that much of the
    host's memory (the caching host allocator would reserve 4 GiB) and gives
    it back when its last view is freed; a layer view of it is pinned and
    copies both ways."""
    from repro_torch.core.offload import empty_host
    dev = _cuda()
    nbytes = (3 << 30) + (1 << 20) + 6
    gc.collect()             # buffers of earlier tests, freed before reading
    before = _settled_mem_available()
    buf = empty_host((nbytes // 2,), torch.bfloat16, dev)
    buf.fill_(1)
    taken = before - _mem_available_bytes()
    assert buf.is_pinned() and buf.numel() == nbytes // 2
    assert abs(taken - nbytes) <= 0.02 * nbytes, (taken, nbytes)
    rows = buf[: (1 << 20)].view(1024, 1024)
    assert rows[3].is_pinned()
    on_card = rows.to(dev, non_blocking=True) * 2
    rows.copy_(on_card)
    assert float(rows.float().mean()) == 2.0
    del buf, rows, on_card
    gc.collect()
    assert before - _settled_mem_available() <= 0.02 * nbytes


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4, 300])
def test_stream_matmul_on_a_registered_host_stack(M):
    """w: one layer of a bf16 (3, K, N) stack in ``empty_host`` memory (page
    registered, not from the caching allocator): the ring route, every byte
    streamed once, and the plain version's result."""
    from repro_torch.core.offload import to_host
    dev = _cuda()
    K, N = 1536, 2300
    rng = np.random.default_rng(M)
    stack = torch.from_numpy(rng.standard_normal((3, K, N)).astype(np.float32)
                             ).to(torch.bfloat16)
    host = to_host(stack, dev)
    assert host.is_pinned() and host[1].is_pinned()
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16).to(dev)
    before = (dict(sm.stream_matmul.launches_by_route), sm.stream_matmul.h2d_bytes)
    got = sm.stream_matmul(x, host[1])
    want = sm.stream_matmul_plain(x, stack[1].to(dev))
    torch.cuda.synchronize()
    assert _rel(got, want) < TOL[torch.bfloat16]
    assert sm.stream_matmul.launches_by_route["ring"] - before[0]["ring"] == 1
    assert sm.stream_matmul.h2d_bytes - before[1] == K * N * 2
