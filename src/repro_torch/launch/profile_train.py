"""Where a training step's time goes on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch gpt2-124m \
        --full-size --attn-impl xla_cv [--remat layer] [--batch 8 --seq 1024]

Builds the model and ``make_train_step`` as ``launch/train.py`` does (without
the fault-tolerant runner, whose checkpoints are host work), warms up, times
``--steps`` AdamW steps, then profiles as many more with ``torch.profiler``.
Each step ends by reading its metrics, which waits for the card, as the
runner's steps do. Prints one JSON object: wall time per step without and
with the profiler (which slows the host), device-busy time per step (the sum
of kernel and copy durations on the device), the device's idle share against
the unprofiled wall time, device time per step by group (the flash kernels
one by one, the matrix products, copies, the rest) and the operations that
take the most device time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.data.pipeline import DataPipeline, SyntheticSource, to_device
from repro_torch.launch.profile_serve import _device_us
from repro_torch.launch.train import REMATS, build_config
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw
from repro_torch.train.train_step import (TrainStepConfig, make_train_step,
                                          metrics_to_floats)

# device-op name fragments -> group; the first match wins
GROUPS = (("flash_fwd", "flash forward (+lse)"),
          ("bwd_dkdv", "flash backward dk/dv"),
          ("bwd_dq", "flash backward dq"),
          ("gmm_", "grouped_matmul"),
          ("chunk_state", "ssd_scan"), ("state_pass", "ssd_scan"),
          ("chunk_scan", "ssd_scan"),
          ("gemm", "matrix products"), ("nvjet", "matrix products"),
          ("xmma", "matrix products"), ("cutlass", "matrix products"),
          ("Memcpy", "copies"), ("Memset", "copies"))


def _group(name: str) -> str:
    return next((g for frag, g in GROUPS if frag in name), "other")


def profile(args) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cfg = build_config(args.arch, full_size=args.full_size,
                       attn_impl=args.attn_impl, remat=args.remat)
    model = build_model(cfg, "cuda")
    params, _ = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt = adamw.init(params)
    total = args.warmup + 2 * args.steps
    step = make_train_step(model, TrainStepConfig(opt=adamw.AdamWConfig(
        lr=3e-3, warmup_steps=20, total_steps=total)))
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0), args.batch,
                        args.seq)

    def run(i):
        nonlocal params, opt
        batch = to_device(pipe.batch_at(i), "cuda")
        params, opt, met = step(params, opt, batch)
        return metrics_to_floats(met)

    for i in range(args.warmup):
        run(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(args.warmup, args.warmup + args.steps):
        run(i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.warmup + args.steps, total):
            run(i)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0

    dev_events = [e for e in prof.key_averages()
                  if _device_us(e) > 0 and getattr(e, "device_type", None)
                  is not None and "CUDA" in str(e.device_type)]
    if not dev_events:
        raise RuntimeError("the profiler recorded no device activity")
    busy_us = sum(_device_us(e) for e in dev_events)
    groups = {}
    for e in dev_events:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + _device_us(e) / 1e3 / args.steps
    top = sorted(dev_events, key=_device_us, reverse=True)[:args.top]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return {
        "arch": cfg.name, "full_size": args.full_size,
        "attn_impl": cfg.attn_impl, "remat": cfg.remat, "batch": args.batch,
        "seq": args.seq, "steps": args.steps, "card": card,
        "wall_ms_per_step": wall * 1e3 / args.steps,
        "profiled_wall_ms_per_step": profiled_wall * 1e3 / args.steps,
        "tokens_per_s": args.batch * args.seq * args.steps / wall,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_idle_share": 1.0 - (busy_us / 1e6) / wall,
        "device_ops_per_step": sum(e.count for e in dev_events) / args.steps,
        "device_ms_per_step_by_group": dict(sorted(groups.items(),
                                                   key=lambda kv: -kv[1])),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "top_device_ops": [
            {"name": e.key[:80], "ms_per_step": _device_us(e) / 1e3 / args.steps,
             "per_step": e.count / args.steps} for e in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-124m")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--attn-impl", default="xla_cv", choices=("xla", "xla_cv"))
    ap.add_argument("--remat", default=None, choices=REMATS,
                    help="default: the config's")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    print(json.dumps(profile(ap.parse_args())))


if __name__ == "__main__":
    main()
