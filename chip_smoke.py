#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # needs one NVIDIA H100 and nvcc

Drives the port's main path through its public entry points and prints one
JSON line per phase; any failure is a non-zero exit:

  env      torch / CUDA versions, the card's name and power limit
  build    builds every kernel under src/repro_torch/kernels/csrc with nvcc
  kernels  each kernel's wrapper against its plain PyTorch version on the
           card at the main path's shapes, with its time, the plain
           version's, one library call's, and the card's bound for the work
  serve    llama3-8b at full width and depth (random bf16 weights from a
           seed) through ServingEngine.run; the kernel launch counts are set
           to 0 just before and read just after
  check    full-width logits through the kernel against the eager chunked
           attention, and prefill -> decode against the full forward
  offload  the same requests with the KV pool on the device, split by an
           OffloadPlan, and fully in pinned host memory: identical tokens
  runtime  SliceRuntime with two tenants: llama3-8b at full width and depth
           on 2s.32c with an HBM budget that spills the embedding table, the
           KV pool and one stacked MLP matrix to pinned host memory (the
           matrix streamed through stream_matmul in every prefill and tick),
           next to gpt2-124m on 1s.16c; the counts are set to 0 just before
           SliceRuntime.run and read just after
  gpt2     gpt2-124m at full size (layernorm, learned positions, tanh-GELU,
           biases, tied embeddings)

Then a line {"kernels": [...]} with every kernel's figures, the card's name
and power limit, and last {"ok": true, "device": {...}}.

Timing: CUDA events around single launches after a warm-up, median of 20;
inputs stay in the L2 cache between launches, as they do for the real caller
whose previous kernels just wrote them. bound_ms is the larger of bytes moved
(each input read once, the output written once) over 3.35 TB/s and operations
over the peak rate of the input type (989 TFLOP/s bf16 on the tensor cores,
67 TFLOP/s fp32), the published H100 SXM figures. For a weight in pinned host
memory the bytes of the weight cross the host link; its bound is the larger
of those bytes over the link's peak rate and the device bound. The peak is
that of the card's published host interface, PCIe Gen5 x16 (lanes x transfer
rate x line-code efficiency, one direction: 63.0 GB/s); the rate one 1 GiB
pinned -> device copy reaches between CUDA events is printed beside it.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}     # max |diff| / max |plain|
# stream_matmul: the reference's fp32 tolerance (tests/test_kernels.py), and
# one bf16 rounding of the output in bf16
STREAM_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# whole-model logits in bf16 through up to 32 layers, two routes whose bf16
# roundings fall at different places: max |diff| / max |logit|
MODEL_TOL = 5e-2
# PCIe transfer rate per lane in GT/s, by generation
PCIE_GT_PER_S = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0}


def pcie_peak_bytes_per_s(gen: int, width: int) -> float:
    """Peak data rate of one direction of a PCIe link: lanes x transfer
    rate x line-code efficiency (8b/10b up to Gen2, 128b/130b from Gen3)."""
    if gen not in PCIE_GT_PER_S or width < 1:
        raise ValueError(f"no peak rate for a PCIe Gen{gen} x{width} link")
    code = 8 / 10 if gen <= 2 else 128 / 130
    return PCIE_GT_PER_S[gen] * 1e9 * width * code / 8


# the H100's host interface, PCIe Gen5 x16: a host link that trains lower
# only makes the bound looser, never too tight
HOST_LINK_BYTES_PER_S = pcie_peak_bytes_per_s(5, 16)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.offload import memory_kind_of, place_tree, plan_offload
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.models import layers as mlayers
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving import (Request, ServingEngine, SliceRuntime,
                                     TenantEngine, TenantSpec)

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references in fp32
    dev = torch.device("cuda")
    kernel_wrappers = {"flash_attention_fwd": fa.flash_attention_fwd,
                       "stream_matmul": sm.stream_matmul}

    def reset_counts():
        for w in kernel_wrappers.values():
            w.launches = 0
        sm.stream_matmul.h2d_bytes = 0
        mlayers.gather_rows.h2d_bytes = 0

    # ------------------------------------------------------------------ env
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0].strip()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), card=card_line)

    # ---------------------------------------------------------------- build
    t0 = time.time()
    libs = _build.build_all()
    for name in libs:
        _build.load(name)
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.build_log.items()}
    spills = sorted({ln for lines in ptxas.values() for ln in lines
                     if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln})
    regs = sorted({int(ln.split("Used ")[1].split(" registers")[0])
                   for lines in ptxas.values() for ln in lines if "Used " in ln})
    emit("build", seconds=round(time.time() - t0, 2), libraries=sorted(libs),
         nvcc=_build.find_nvcc(), registers=regs, spilling=spills[:8])

    # -------------------------------------------------------------- kernels
    def time_ms(fn, warmup=3, iters=20):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def flash_case(BH, S, hd, dtype_name, causal):
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device=dev).manual_seed(SEED + S + hd)
        q, k, v = (torch.randn(BH, S, hd, device=dev, generator=g).to(dtype)
                   for _ in range(3))
        got = fa.flash_attention_fwd(q, k, v, causal=causal)
        want = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            fail(f"flash_attention_fwd gave non-finite values at {(BH, S, hd)}")
        abs_err = float((got.float() - want.float()).abs().max())
        rel = abs_err / (float(want.float().abs().max()) + 1e-9)
        if rel >= TOL[dtype_name]:
            fail(f"flash_attention_fwd disagrees with its plain version at "
                 f"{(BH, S, hd)} {dtype_name} causal={causal}: rel {rel:.3e} "
                 f">= {TOL[dtype_name]}")
        q4, k4, v4 = (t[None] for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = 4.0 * BH * pairs * hd
        nbytes = 4.0 * BH * S * hd * q.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
        return {
            "shape": [BH, S, hd], "dtype": dtype_name, "causal": causal,
            "max_abs_err": abs_err, "rel_err": rel, "tol": TOL[dtype_name],
            "ms": ms,
            "plain_ms": time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, causal=causal), iters=5),
            "library_ms": time_ms(lambda: sdpa(q4, k4, v4, is_causal=causal)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "tflops": flops / (ms * 1e-3) / 1e12,
        }

    cases = [flash_case(32, 1024, 128, "bfloat16", True),   # the headline
             flash_case(32, 128, 128, "bfloat16", True),
             flash_case(32, 300, 128, "bfloat16", True),    # ragged S
             flash_case(32, 1024, 128, "float32", True),
             flash_case(32, 128, 128, "float32", True),
             flash_case(32, 300, 128, "float32", True),
             flash_case(32, 256, 128, "float32", False),
             flash_case(12, 300, 64, "bfloat16", True)]     # gpt2's head dim

    # the host link's rate: one 1 GiB pinned -> device copy between events
    host_buf = torch.empty(1 << 30, dtype=torch.uint8, pin_memory=True)
    dev_buf = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    link_ms = time_ms(lambda: dev_buf.copy_(host_buf, non_blocking=True),
                      warmup=1, iters=5)
    link_bytes_per_s = (1 << 30) / (link_ms * 1e-3)
    del host_buf, dev_buf
    # a bound is never above what was reached
    link_bound_rate = max(HOST_LINK_BYTES_PER_S, link_bytes_per_s)

    def stream_case(M, K, N, xdt, wdt, where, transposed=False):
        """x (M, K) on the card; w (K, N) on the card or in pinned host
        memory, or the transposed view of an (N, K) table."""
        g = torch.Generator(device=dev).manual_seed(SEED + M + K + N)
        x = torch.randn(M, K, device=dev, generator=g).to(getattr(torch, xdt))
        shape = (N, K) if transposed else (K, N)
        w_dev = (torch.randn(*shape, device=dev, generator=g)
                 * K ** -0.5).to(getattr(torch, wdt))
        w = w_dev if where == "device" else w_dev.cpu().pin_memory()
        if transposed:
            w_dev, w = w_dev.T, w.T
        before = sm.stream_matmul.h2d_bytes
        got = sm.stream_matmul(x, w)
        h2d = sm.stream_matmul.h2d_bytes - before
        want = sm.stream_matmul_plain(x, w_dev)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            fail(f"stream_matmul gave non-finite values at {(M, K, N)}")
        abs_err = float((got.float() - want.float()).abs().max())
        rel = abs_err / (float(want.float().abs().max()) + 1e-9)
        tol = STREAM_TOL[xdt]
        if rel >= tol:
            fail(f"stream_matmul disagrees with its plain version at "
                 f"{(M, K, N)} x {xdt} w {wdt} {where}: rel {rel:.3e} >= {tol}")
        w_bytes = K * N * w.element_size()
        if h2d != (w_bytes if where == "pinned" else 0):
            fail(f"stream_matmul streamed {h2d} bytes for a {where} w of "
                 f"{w_bytes} bytes")
        nbytes = (M * K + M * N) * x.element_size() + w_bytes
        flops = 2.0 * M * K * N
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[xdt] * 1e3
        t_link = w_bytes / link_bound_rate * 1e3 if where == "pinned" else 0.0
        ms = time_ms(lambda: sm.stream_matmul(x, w))
        lib_dev = time_ms(lambda: x @ w_dev.to(x.dtype))
        lib_host = (time_ms(lambda: x @ w.to(dev, non_blocking=True).to(x.dtype))
                    if where == "pinned" else None)
        return {
            "shape": [M, K, N], "x": xdt, "w": wdt, "where": where,
            "transposed": transposed, "max_abs_err": abs_err, "rel_err": rel,
            "tol": tol, "kernel_ms": ms,
            "plain_ms": time_ms(lambda: sm.stream_matmul_plain(x, w_dev), iters=5),
            "library_ms": lib_host if lib_host is not None else lib_dev,
            "library_device_w_ms": lib_dev, "library_host_w_ms": lib_host,
            "bound_ms": max(t_bytes, t_ops, t_link),
            "bound_by": "bytes" if max(t_bytes, t_link) >= t_ops else "operations",
            "h2d_bytes": h2d,
            "h2d_gb_per_s": h2d / (ms * 1e-3) / 1e9 if h2d else None,
        }

    stream_cases = [
        stream_case(4, 4096, 14336, "bfloat16", "bfloat16", "pinned"),  # decode
        stream_case(1024, 4096, 14336, "bfloat16", "bfloat16", "pinned"),
        stream_case(4, 14336, 4096, "bfloat16", "bfloat16", "pinned"),
        stream_case(5, 4096, 1000, "bfloat16", "bfloat16", "pinned"),   # ragged
        stream_case(4, 768, 50257, "bfloat16", "float32", "pinned",
                    transposed=True),                    # gpt2's tied unembed
        stream_case(4, 4096, 4096, "bfloat16", "float32", "pinned"),
        stream_case(128, 512, 128, "float32", "float32", "device"),  # reference
        stream_case(256, 1024, 384, "float32", "float32", "device"),
        stream_case(4, 4096, 14336, "bfloat16", "bfloat16", "device"),
    ]
    emit("kernels", flash_attention_fwd=cases, stream_matmul=stream_cases,
         host_link={"peak_gb_per_s": HOST_LINK_BYTES_PER_S / 1e9,
                    "bound_gb_per_s": link_bound_rate / 1e9,
                    "measured_ms_per_gib": link_ms,
                    "measured_gb_per_s": link_bytes_per_s / 1e9})

    # ---------------------------------------------------------------- serve
    def timed_engine(engine):
        """Stamp prefill and tick wall times (synchronised) on an engine."""
        engine.prefill_s, engine.tick_s = [], []
        prefill, tick = engine.prefill, engine.tick

        def timed_prefill(req):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok = prefill(req)
            torch.cuda.synchronize()
            engine.prefill_s.append((len(req.prompt), time.perf_counter() - t))
            return ok

        def timed_tick():
            torch.cuda.synchronize()
            t, n_pre = time.perf_counter(), len(engine.prefill_s)
            n = tick()
            torch.cuda.synchronize()
            spent = time.perf_counter() - t
            spent -= sum(s for _, s in engine.prefill_s[n_pre:])
            engine.tick_s.append(spent)       # decode part of the tick
            return n

        engine.prefill, engine.tick = timed_prefill, timed_tick
        return engine

    def make_requests(cfg, lens, max_new):
        rng = np.random.default_rng(SEED)
        return [Request(i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                        max_new) for i, n in enumerate(lens)]

    def check_outputs(out, reqs, cfg, max_new):
        if sorted(out) != [r.rid for r in reqs]:
            fail(f"missing requests: {sorted(out)}")
        for rid, toks in out.items():
            if len(toks) != max_new:
                fail(f"request {rid} returned {len(toks)} tokens, not {max_new}")
            if min(toks) < 0 or max(toks) >= cfg.vocab_size:
                fail(f"request {rid}: token id out of range")

    def run_engine(engine, reqs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.run(reqs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    cfg = get_config("llama3-8b").with_(attn_impl="pallas", remat="none",
                                        param_dtype="bfloat16")
    model = build_model(cfg, dev)
    t0 = time.time()
    params, _ = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        t.numel() for k, t in params.items() if k != "layers")
    if n_params != cfg.param_count():
        fail(f"parameter count {n_params} != config's {cfg.param_count()}")
    init_s = time.time() - t0

    LENS = [16, 100, 128, 300, 512, 777, 1000, 1024]
    SLOTS, MAX_SEQ, MAX_NEW = 4, 2048, 16
    torch.cuda.reset_peak_memory_stats()
    # warm-up: the same prompts once, so that first-use costs (library
    # handles, kernels loaded per shape) are not timed as serving
    run_engine(ServingEngine(model, params, slots=SLOTS, max_seq=MAX_SEQ),
               make_requests(cfg, LENS, 2))
    engine = timed_engine(ServingEngine(model, params, slots=SLOTS, max_seq=MAX_SEQ))
    reqs = make_requests(cfg, LENS, MAX_NEW)
    reset_counts()                                   # main path starts here
    out, wall = run_engine(engine, reqs)
    main_path_launches = {n: w.launches for n, w in kernel_wrappers.items()}
    check_outputs(out, reqs, cfg, MAX_NEW)
    want_launches = engine.stats.admitted * cfg.num_layers
    if main_path_launches["flash_attention_fwd"] != want_launches:
        fail(f"flash_attention_fwd launched {main_path_launches['flash_attention_fwd']} "
             f"times, expected admitted x layers = {want_launches}")
    tokens = sum(len(v) for v in out.values())
    base_tokens = out
    emit("serve", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         params=n_params, param_dtype=cfg.param_dtype, init_seconds=round(init_s, 2),
         requests=len(out), prompt_lens=LENS, slots=SLOTS, max_seq=MAX_SEQ,
         tokens=tokens, ticks=engine.ticks, admitted=engine.stats.admitted,
         wall_seconds=wall, tok_per_s=tokens / wall,
         prefill_ms={str(n): s * 1e3 for n, s in engine.prefill_s},
         prefill_ms_median=statistics.median(s for _, s in engine.prefill_s) * 1e3,
         tick_ms_median=statistics.median(engine.tick_s) * 1e3,
         tick_ms_max=max(engine.tick_s) * 1e3,
         kv_pool_bytes=model.cache_bytes(SLOTS, MAX_SEQ),
         flash_attention_fwd_launches=main_path_launches["flash_attention_fwd"],
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del engine

    # ---------------------------------------------------------------- check
    def rel_err(a, b):
        return float((a.float() - b.float()).abs().max()
                     / (b.float().abs().max() + 1e-9))

    rng = np.random.default_rng(SEED + 1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 301)), device=dev)
    logits_k, _, _ = model.forward(params, {"tokens": toks})
    eager = build_model(cfg.with_(attn_impl="xla"), dev)
    logits_e, _, _ = eager.forward(params, {"tokens": toks})
    if tuple(logits_k.shape) != (1, 301, cfg.vocab_size):
        fail(f"logits shape {tuple(logits_k.shape)}")
    if not torch.isfinite(logits_k.float()).all():
        fail("non-finite logits")
    kernel_vs_eager = rel_err(logits_k, logits_e)
    # prefill 300 tokens, decode the 301st: equals the full forward's last row
    _, _, pc = model.forward(params, {"tokens": toks[:, :300]}, return_cache=True)
    cache = model.init_cache(1, 512)
    for name in cache:
        cache[name][:, :, :300] = pc[name].to(cache[name].dtype)
    dec, _ = model.decode(params, cache, {"tokens": toks[:, 300:301],
                                          "pos": torch.tensor(300, device=dev)})
    decode_vs_forward = rel_err(dec[0], logits_k[0, -1])
    torch.cuda.synchronize()
    if not torch.isfinite(dec.float()).all():
        fail("non-finite decode logits")
    if kernel_vs_eager >= MODEL_TOL or decode_vs_forward >= MODEL_TOL:
        fail(f"full-width logits disagree: kernel vs eager {kernel_vs_eager:.3e}, "
             f"decode vs forward {decode_vs_forward:.3e} (limit {MODEL_TOL})")
    emit("check", kernel_vs_eager_rel=kernel_vs_eager,
         decode_vs_forward_rel=decode_vs_forward, tol=MODEL_TOL,
         argmax_agree=float((logits_k.argmax(-1) == logits_e.argmax(-1)).float().mean()))
    del logits_k, logits_e, pc, cache, dec

    # -------------------------------------------------------------- offload
    inventory = model.serving_inventory(params, model.cache_shapes(SLOTS, MAX_SEQ))
    total = sum(t.bytes for t in inventory)
    embed = sum(t.bytes for t in inventory if t.group == "embed")
    kv = sum(t.bytes for t in inventory if t.group == "kv_cache")
    # the embedding table spills first (coldest per byte); the budget sits a
    # quarter of the KV bytes below what is left, so a KV leaf must split
    hbm_budget = total - embed - kv // 4
    plan = plan_offload(inventory, hbm_budget)
    if not plan.fits:
        fail("offload plan does not fit its budget")
    # whole-leaf placement by the same plan, on stand-ins of two parameters:
    # the spilled table lands in pinned host memory, the rest on the device
    placed = place_tree({"params": {"tok_embed": torch.ones(8, 8, device=dev),
                                    "lm_head": torch.ones(8, 8, device=dev)}},
                        plan, dev)["params"]
    placed_kinds = {n: memory_kind_of(t) for n, t in placed.items()}
    if placed_kinds != {"tok_embed": "pinned_host", "lm_head": "device"}:
        fail(f"place_tree put leaves in {placed_kinds}")
    engines = {
        "device": lambda: TenantEngine(model, params, slots=SLOTS, max_seq=MAX_SEQ),
        "split": lambda: TenantEngine(model, params, slots=SLOTS, max_seq=MAX_SEQ,
                                      plan=plan),
        "host": lambda: TenantEngine(model, params, slots=SLOTS, max_seq=MAX_SEQ,
                                     offload_kv=True),
    }
    want_kinds = {"device": {"device"}, "split": {"device", "pinned_host"},
                  "host": {"pinned_host"}}
    rows = {}
    for name, make in engines.items():
        eng = timed_engine(make())
        pool = eng.pool
        if pool.memory_kinds() != want_kinds[name]:
            fail(f"{name}: memory kinds {pool.memory_kinds()} != {want_kinds[name]}")
        if not all(t.is_pinned() for t in pool.host_tensors()):
            fail(f"{name}: a host-tier buffer is not pinned")
        if pool.device_bytes + pool.host_bytes != model.cache_bytes(SLOTS, MAX_SEQ):
            fail(f"{name}: device + host bytes != pool size")
        if (name == "split") != bool(pool.split_leaves):
            fail(f"{name}: split_leaves = {pool.split_leaves}")
        o_reqs = make_requests(cfg, LENS, MAX_NEW)
        o_out, o_wall = run_engine(eng, o_reqs)
        check_outputs(o_out, o_reqs, cfg, MAX_NEW)
        if o_out != base_tokens:
            fail(f"{name}: tokens differ from the device-pool serve run")
        if pool.memory_kinds() != want_kinds[name]:
            fail(f"{name}: pool migrated to {pool.memory_kinds()} while serving")
        rows[name] = {
            "device_bytes": pool.device_bytes, "host_bytes": pool.host_bytes,
            "split_leaves": pool.split_leaves,
            "memory_kinds": sorted(pool.memory_kinds()),
            "wall_seconds": o_wall, "tok_per_s": tokens / o_wall,
            "tick_ms_median": statistics.median(eng.tick_s) * 1e3,
            "prefill_ms_median": statistics.median(s for _, s in eng.prefill_s) * 1e3,
            "h2d_bytes_per_tick": pool.h2d_bytes / max(eng.ticks, 1),
            "d2h_bytes_per_tick": pool.d2h_bytes / max(eng.ticks, 1),
            "paste_host_bytes": pool.paste_host_bytes, "ticks": eng.ticks,
        }
        del eng, pool
        torch.cuda.empty_cache()
    emit("offload", hbm_budget=hbm_budget, footprint=total,
         plan={"offloaded": list(plan.offloaded), "partial": list(plan.partial),
               "resident_bytes": plan.resident_bytes, "host_bytes": plan.host_bytes},
         plan_applied_to="kv pool (parameters stay on the device)",
         place_tree_kinds=placed_kinds,
         tokens_equal=True, **rows)
    del params, model, eager
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- runtime
    gcfg = get_config("gpt2-124m").with_(attn_impl="pallas", remat="none")
    meta = build_model(cfg, dev)
    meta_inv = meta.serving_inventory(meta.init(abstract=True)[0],
                                      meta.cache_shapes(SLOTS, MAX_SEQ))
    footprint = sum(t.bytes for t in meta_inv)
    embed = sum(t.bytes for t in meta_inv if t.group == "embed")
    kv = sum(t.bytes for t in meta_inv if t.group == "kv_cache")
    # one byte over what spilling the table and the KV pool frees: by the
    # planner's order the next spill is one whole stacked MLP matrix
    llm_budget = footprint - embed - kv - 1
    rt = SliceRuntime(device=dev)
    t0 = time.time()
    llm = rt.add_tenant(TenantSpec("llm", cfg, profile="2s.32c", slots=SLOTS,
                                   max_seq=MAX_SEQ, hbm_budget=llm_budget,
                                   seed=SEED))
    gpt = rt.add_tenant(TenantSpec("gpt2", gcfg, profile="1s.16c", slots=SLOTS,
                                   max_seq=256, seed=SEED))
    torch.cuda.synchronize()
    add_s = time.time() - t0
    plan = llm.plan
    streamed = [n for n in plan.offloaded if n.startswith("params/layers/")]
    if not streamed:
        fail(f"the plan spills no layer matrix: {plan}")
    host_leaves = {}
    for name in streamed:
        leaf = llm.params["layers"][name.split("/")[-1]]
        if memory_kind_of(leaf) != "pinned_host" or not leaf.is_pinned():
            fail(f"{name} is not in pinned host memory after placement")
        host_leaves[name] = leaf
    want_kinds = {"pinned_host" if plan.is_offloaded(f"kv/{n}") else "device"
                  for n in ("k", "v")}
    if llm.engine.pool.memory_kinds() != want_kinds:
        fail(f"llm pool kinds {llm.engine.pool.memory_kinds()} != {want_kinds}")
    for t in rt.tenants.values():
        timed_engine(t.engine)
    llm_reqs = make_requests(cfg, LENS, MAX_NEW)
    g_reqs = make_requests(gcfg, [5, 33, 64, 100], 8)
    rt.submit("llm", llm_reqs)
    rt.submit("gpt2", g_reqs)
    reset_counts()                                   # main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = rt.run()
    torch.cuda.synchronize()
    rt_wall = time.perf_counter() - t0
    rt_launches = {n: w.launches for n, w in kernel_wrappers.items()}
    weight_h2d = sm.stream_matmul.h2d_bytes
    embed_h2d = mlayers.gather_rows.h2d_bytes
    check_outputs(llm.engine.outputs, llm_reqs, cfg, MAX_NEW)
    check_outputs(gpt.engine.outputs, g_reqs, gcfg, 8)
    lst = llm.engine.stats
    calls = (lst.admitted + lst.ticks) * cfg.num_layers * len(streamed)
    if rt_launches["stream_matmul"] != calls:
        fail(f"stream_matmul launched {rt_launches['stream_matmul']} times, "
             f"expected (prefills + ticks) x layers x matrices = {calls}")
    slice_bytes = sum(leaf[0].numel() * leaf.element_size()
                      for leaf in host_leaves.values()) // len(streamed)
    if weight_h2d != calls * slice_bytes:
        fail(f"stream_matmul streamed {weight_h2d} bytes, expected "
             f"{calls} calls x {slice_bytes} bytes")
    want_flash = (lst.admitted * cfg.num_layers
                  + gpt.engine.stats.admitted * gcfg.num_layers)
    if rt_launches["flash_attention_fwd"] != want_flash:
        fail(f"flash_attention_fwd launched {rt_launches['flash_attention_fwd']}"
             f" times in the runtime, expected {want_flash}")
    row_bytes = cfg.d_model * llm.params["tok_embed"].element_size()
    want_embed = (lst.prefill_tokens + lst.ticks * SLOTS) * row_bytes
    if plan.is_offloaded("params/tok_embed") and embed_h2d != want_embed:
        fail(f"embedding rows moved {embed_h2d} bytes, expected {want_embed}")
    if report["pod_utilization"] != 48 / 256:
        fail(f"pod utilization {report['pod_utilization']} != 48/256")
    if not 0 < report["modeled"]["throttle"] <= 1:
        fail(f"modeled throttle {report['modeled']['throttle']}")

    # the co-run must not change the tenant's tokens: a lone engine over the
    # same placed parameters and plan, with stream_matmul timed per call
    sm_events = []
    ops_stream_matmul = kops.stream_matmul

    def timed_stream_matmul(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ops_stream_matmul(*a, **k)
        end.record()
        sm_events.append((start, end))
        return out

    lone = timed_engine(TenantEngine(llm.model, llm.params, slots=SLOTS,
                                     max_seq=MAX_SEQ, plan=plan))
    kops.stream_matmul = timed_stream_matmul
    lone_ticks_sm = []
    tick = lone.tick

    def tick_with_share():
        n_before = len(sm_events)
        n_pre = len(lone.prefill_s)
        emitted = tick()        # timed_engine's wrapper: synchronised
        per_prefill = cfg.num_layers * len(streamed) * (len(lone.prefill_s) - n_pre)
        lone_ticks_sm.append(sum(s.elapsed_time(e) for s, e in
                                 sm_events[n_before + per_prefill:]))
        return emitted

    lone.tick = tick_with_share
    try:
        lone_out, lone_wall = run_engine(lone, make_requests(cfg, LENS, MAX_NEW))
    finally:
        kops.stream_matmul = ops_stream_matmul
    if lone_out != llm.engine.outputs:
        fail("llm tokens of the co-run differ from a lone engine's")

    # full-width logits: host-placed parameters vs all on the device
    rng = np.random.default_rng(SEED + 1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 301)), device=dev)
    on_device = dict(llm.params)
    on_device["layers"] = {k: v.to(dev) for k, v in llm.params["layers"].items()}
    on_device["tok_embed"] = llm.params["tok_embed"].to(dev)
    logits_h, _, _ = llm.model.forward(llm.params, {"tokens": toks})
    logits_d, _, _ = llm.model.forward(on_device, {"tokens": toks})
    torch.cuda.synchronize()
    placed_vs_device = rel_err(logits_h, logits_d)
    if not torch.isfinite(logits_h.float()).all() or placed_vs_device >= MODEL_TOL:
        fail(f"host-placed vs device logits: rel {placed_vs_device:.3e} "
             f"(limit {MODEL_TOL})")
    argmax_agree = float((logits_h.argmax(-1) == logits_d.argmax(-1)).float().mean())
    del on_device, logits_h, logits_d

    def tier_bytes(t):
        kinds = {}
        for leaf in list(t.params["layers"].values()) + [
                v for k, v in t.params.items() if k != "layers"]:
            kind = memory_kind_of(leaf)
            kinds[kind] = kinds.get(kind, 0) + leaf.numel() * leaf.element_size()
        return {"params_by_kind": kinds,
                "kv_device_bytes": t.engine.pool.device_bytes,
                "kv_host_bytes": t.engine.pool.host_bytes}

    tenants_out = {}
    for t in rt.tenants.values():
        row = report["tenants"][t.name]
        tenants_out[t.name] = {
            "arch": t.spec.cfg.name, "profile": row["profile"],
            "rect": row["rect"], "tokens": row["tokens_out"],
            "tok_per_s": row["tok_per_s"], "ticks": row["ticks"],
            "tick_ms_median": statistics.median(t.engine.tick_s) * 1e3,
            "prefill_ms_median": statistics.median(
                s for _, s in t.engine.prefill_s) * 1e3,
            **tier_bytes(t)}
    sm_tick_ms = statistics.median(lone_ticks_sm)
    lone_tick_ms = statistics.median(lone.tick_s) * 1e3
    emit("runtime", footprint=footprint, hbm_budget=llm_budget,
         plan={"offloaded": list(plan.offloaded), "partial": list(plan.partial),
               "resident_bytes": plan.resident_bytes, "host_bytes": plan.host_bytes},
         add_tenants_seconds=add_s, wall_seconds=rt_wall, tenants=tenants_out,
         llm_prefills=lst.admitted, llm_ticks=lst.ticks,
         launches=rt_launches, stream_matmul_h2d_bytes=weight_h2d,
         weight_h2d_bytes_per_call=slice_bytes,
         weight_h2d_bytes_per_tick=slice_bytes * cfg.num_layers * len(streamed),
         embed_h2d_bytes=embed_h2d,
         lone_tokens_equal=True, lone_tick_ms_median=lone_tick_ms,
         stream_matmul_ms_per_tick_median=sm_tick_ms,
         stream_matmul_share_of_tick=sm_tick_ms / lone_tick_ms,
         placed_vs_device_rel=placed_vs_device, tol=MODEL_TOL,
         argmax_agree=argmax_agree, pod_utilization=report["pod_utilization"],
         modeled_not_this_card=report["modeled"])
    for name in list(rt.tenants):
        rt.remove_tenant(name)
    del rt, llm, gpt, lone, host_leaves, report
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- gpt2
    gmodel = build_model(gcfg, dev)
    gparams, _ = gmodel.init(torch.Generator(device=dev).manual_seed(SEED))
    geng = timed_engine(ServingEngine(gmodel, gparams, slots=2, max_seq=256))
    greqs = make_requests(gcfg, [5, 33, 64, 100], 8)
    before = fa.flash_attention_fwd.launches
    gout, gwall = run_engine(geng, greqs)
    check_outputs(gout, greqs, gcfg, 8)
    if fa.flash_attention_fwd.launches - before != 4 * gcfg.num_layers:
        fail("gpt2: kernel launch count != admitted x layers")
    geager = build_model(gcfg.with_(attn_impl="xla"), dev)
    gt = torch.as_tensor(greqs[3].prompt.astype(np.int64), device=dev)[None]
    g_rel = rel_err(gmodel.forward(gparams, {"tokens": gt})[0],
                    geager.forward(gparams, {"tokens": gt})[0])
    if g_rel >= MODEL_TOL:
        fail(f"gpt2 logits: kernel vs eager rel {g_rel:.3e} >= {MODEL_TOL}")
    emit("gpt2", arch=gcfg.name, layers=gcfg.num_layers, tokens=sum(map(len, gout.values())),
         ticks=geng.ticks, wall_seconds=gwall,
         tick_ms_median=statistics.median(geng.tick_s) * 1e3,
         kernel_vs_eager_rel=g_rel)

    # ------------------------------------------------------------- summary
    head, shead = cases[0], stream_cases[0]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:302",
        "launches": main_path_launches["flash_attention_fwd"],
        "shape": head["shape"], "dtype": head["dtype"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }, {
        "name": "stream_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stream_matmul.cu",
        "replaces": "src/repro/kernels/stream_matmul.py:55",
        "launches": rt_launches["stream_matmul"],
        "shape": shead["shape"], "dtype": shead["x"], "w": shead["where"],
        "max_abs_err": max(c["max_abs_err"] for c in stream_cases),
        "ms": shead["kernel_ms"], "plain_ms": shead["plain_ms"],
        "bound_ms": shead["bound_ms"], "bound_by": shead["bound_by"],
        "library_ms": shead["library_ms"],
        "library_device_w_ms": shead["library_device_w_ms"],
        "host_link_peak_gb_per_s": HOST_LINK_BYTES_PER_S / 1e9,
        "host_link_measured_gb_per_s": link_bytes_per_s / 1e9,
    }]}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
