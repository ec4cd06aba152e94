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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    """The flash-attention forward kernel against its plain version, at every
    head dim it takes, square and ragged lengths, causal and not; inputs it
    cannot take raise."""
    from repro_torch.kernels import flash_attention as fa
    dev = _cuda()
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}[dtype]
    for hd in fa.HEAD_DIMS:
        for Sq, Sk, causal in ((128, 128, True), (300, 300, True), (77, 77, False),
                               (1, 1, True), (40, 200, False), (130, 257, True)):
            g = torch.Generator(device=dev).manual_seed(Sq + Sk + hd)
            q = torch.randn(4, Sq, hd, device=dev, generator=g).to(dtype)
            k, v = (torch.randn(4, Sk, hd, device=dev, generator=g).to(dtype)
                    for _ in range(2))
            before = fa.flash_attention_fwd.launches
            got = fa.flash_attention_fwd(q, k, v, causal=causal)
            want = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert fa.flash_attention_fwd.launches == before + 1
            assert _rel(got, want) < tol, (dtype, hd, Sq, Sk, causal)
    wide = torch.zeros(4, 8, 32, device=dev, dtype=dtype)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(wide[..., :16], wide[..., :16], wide[..., :16])
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(wide.half(), wide.half(), wide.half())
    odd = torch.zeros(4 * 8 * 16 + 1, device=dev, dtype=dtype)[1:].view(4, 8, 16)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(odd, odd, odd)
