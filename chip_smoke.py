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
  gpt2     gpt2-124m at full size (layernorm, learned positions, tanh-GELU,
           biases, tied embeddings)

Then a line {"kernels": [...]} with every kernel's figures, the card's name
and power limit, and last {"ok": true, "device": {...}}.

Timing: CUDA events around single launches after a warm-up, median of 20;
inputs stay in the L2 cache between launches, as they do for the real caller
whose previous kernels just wrote them. bound_ms is the larger of bytes moved
(each input read once, the output written once) over 3.35 TB/s and operations
over the peak rate of the input type (989 TFLOP/s bf16 on the tensor cores,
67 TFLOP/s fp32), the published H100 SXM figures.
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
# whole-model logits in bf16 through up to 32 layers, two routes whose bf16
# roundings fall at different places: max |diff| / max |logit|
MODEL_TOL = 5e-2


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
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving import Request, ServingEngine, TenantEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references in fp32
    dev = torch.device("cuda")
    kernel_wrappers = {"flash_attention_fwd": fa.flash_attention_fwd}

    def reset_counts():
        for w in kernel_wrappers.values():
            w.launches = 0

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
    emit("kernels", flash_attention_fwd=cases)

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

    # ----------------------------------------------------------------- gpt2
    gcfg = get_config("gpt2-124m").with_(attn_impl="pallas", remat="none")
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
    head = cases[0]
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
    }]}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
