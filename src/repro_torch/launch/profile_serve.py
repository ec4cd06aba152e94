"""Where a decode tick's time goes on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch llama3-8b \
        --full-size [--offload-kv | --hbm-budget BYTES] [--ticks 8]

Fills every slot of a ``TenantEngine`` with one request, warms up, then
profiles ``--ticks`` decode ticks with ``torch.profiler`` (host and device
activity). Prints one JSON object: wall time per tick, device-busy time per
tick (the sum of kernel and copy durations on the device), the idle share of
the device, the number of kernels per tick and the kernels that take the most
device time. A tick whose device-busy time is far below its wall time is bound
by the host issuing small kernels, not by the card.

``--hbm-budget`` profiles a ``SliceRuntime`` tenant instead, added with that
HBM budget: the runtime cuts its ``OffloadPlan`` and places parameters and KV
pool by it, so spilled parameters live in pinned host memory and are streamed
through ``stream_matmul`` (an MoE expert stack through ``grouped_matmul``,
e.g. ``--arch granite-moe-1b-a400m``). Copies on the side stream overlap
kernels, so the device-busy sum can then exceed the time the device was busy.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model_zoo import build_model
from repro_torch.serving import Request, SliceRuntime, TenantEngine, TenantSpec


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total", 0.0)
                 or getattr(evt, "cuda_time_total", 0.0))


def device_summary(prof, wall_s: float, calls: int, top: int = 12,
                   unit: str = "tick") -> dict:
    """What a ``torch.profiler`` window of ``calls`` calls (each a ``unit``)
    taking ``wall_s`` seconds spent on the device, per call: wall ms,
    device-busy ms (the sum of kernel and copy durations), the device's idle
    share, device ops, and the ``top`` ops by device time."""
    # device-side events only: kernels and memcpys (their own device time)
    dev_events = [e for e in prof.key_averages()
                  if _device_us(e) > 0 and getattr(e, "device_type", None)
                  is not None and "CUDA" in str(e.device_type)]
    if not dev_events:
        raise RuntimeError("the profiler recorded no device activity")
    busy_us = sum(_device_us(e) for e in dev_events)
    return {
        f"wall_ms_per_{unit}": wall_s * 1e3 / calls,
        f"device_busy_ms_per_{unit}": busy_us / 1e3 / calls,
        "device_idle_share": 1.0 - (busy_us / 1e6) / wall_s,
        f"device_ops_per_{unit}": sum(e.count for e in dev_events) / calls,
        "top_device_ops": [
            {"name": e.key.replace("(anonymous namespace)::", "")[:80],
             f"ms_per_{unit}": _device_us(e) / 1e3 / calls,
             f"per_{unit}": e.count / calls}
            for e in sorted(dev_events, key=_device_us, reverse=True)[:top]],
    }


def profile(args) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cfg = get_config(args.arch)
    cfg = (cfg.with_(remat="none", param_dtype="bfloat16") if args.full_size
           else cfg.reduced())
    cfg = cfg.with_(attn_impl=args.attn_impl)
    plan = None
    if args.hbm_budget is not None:
        tenant = SliceRuntime(device="cuda").add_tenant(TenantSpec(
            "profiled", cfg, slots=args.slots, max_seq=args.max_seq,
            hbm_budget=args.hbm_budget, seed=0))
        engine, plan = tenant.engine, tenant.plan
    else:
        model = build_model(cfg, "cuda")
        params, _ = model.init(torch.Generator(device="cuda").manual_seed(0))
        engine = TenantEngine(model, params, slots=args.slots,
                              max_seq=args.max_seq, offload_kv=args.offload_kv)
    rng = np.random.default_rng(0)
    budget = args.warmup + args.ticks + 1
    for i in range(args.slots):
        prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len)
        engine.submit(Request(i, prompt.astype(np.int32), budget))
    for _ in range(args.warmup):
        engine.tick()
    torch.cuda.synchronize()

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    summary = device_summary(prof, wall, args.ticks, args.top)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return {
        "arch": cfg.name, "full_size": args.full_size, "slots": args.slots,
        "max_seq": args.max_seq, "prompt_len": args.prompt_len,
        "offload_kv": args.offload_kv, "ticks": args.ticks, "card": card,
        "plan_offloaded": list(plan.offloaded) if plan else [],
        **summary,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--attn-impl", default="pallas", choices=("xla", "pallas"))
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--prompt-len", type=int, default=512)
    placement = ap.add_mutually_exclusive_group()
    placement.add_argument("--offload-kv", action="store_true")
    placement.add_argument("--hbm-budget", type=int, default=None,
                           help="profile a SliceRuntime tenant whose plan is "
                                "cut against this many device bytes")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    print(json.dumps(profile(ap.parse_args())))


if __name__ == "__main__":
    main()
