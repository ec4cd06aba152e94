"""Serving entry point: single-tenant continuous batching, or the multi-tenant
SliceRuntime.

Single tenant:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --requests 16

Multi-tenant — pack several archs onto one modelled pod's slices, each with
its own offload plan, and drive them round-robin:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --tenants llama3-8b:2s.32c,gpt2-124m:1s.16c --hbm-budget 380000

``--hbm-budget BYTES`` pins the *first* tenant's plan budget below its
footprint so the offload path engages (with a 4096-byte spill granule, as
the reference does); on the card, parameters the plan spills live in pinned
host memory and are streamed through the ``stream_matmul`` kernel (an MoE
expert stack through ``grouped_matmul``).

MoE (granite-moe-1b-a400m, phi3.5-moe-42b-a6.6b) serves like any other
family; its expert products run through the ``grouped_matmul`` kernel on the
card, e.g. ``--arch granite-moe-1b-a400m --full-size --attn-impl pallas``, or
``--tenants granite-moe-1b-a400m:1s.16c,gpt2-124m:1s.16c``.

Runs on the CUDA device unless ``--device cpu`` is given. ``--full-size``
serves the published widths and depth in bf16 weights; the default is the
reduced same-family config. ``--attn-impl pallas`` routes causal prefill
through the hand-written flash-attention kernel (the config value keeps the
reference's name), ``xla`` through the eager chunked version.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import tenant_config
from repro_torch.models.model_zoo import build_model
from repro_torch.serving import Request, ServingEngine, SliceRuntime, TenantSpec


def run_single(args) -> None:
    cfg = tenant_config(args.arch, full_size=args.full_size,
                        attn_impl=args.attn_impl)
    model = build_model(cfg, args.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    params, _ = model.init(gen)

    engine = ServingEngine(model, params, slots=args.slots,
                           max_seq=args.max_seq, offload_kv=args.offload_kv)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=rng.integers(4, 17)).astype(np.int32),
                    args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    out = engine.run(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    total_tokens = sum(len(v) for v in out.values())
    print(f"arch={cfg.name} requests={len(out)} tokens={total_tokens} "
          f"ticks={engine.ticks} truncated={engine.stats.truncated} "
          f"rejected={engine.stats.rejected} "
          f"wall={wall:.2f}s tok/s={total_tokens / wall:.1f} "
          f"offload_kv={args.offload_kv}")


def run_multi(args) -> None:
    rt = SliceRuntime(device=args.device)

    specs = []
    names = set()
    for i, entry in enumerate(args.tenants.split(",")):
        arch, _, prof = entry.partition(":")
        cfg = tenant_config(arch, full_size=args.full_size,
                            attn_impl=args.attn_impl)
        budget = args.hbm_budget if i == 0 and args.hbm_budget else None
        name = arch if arch not in names else f"{arch}-{i}"
        names.add(name)
        specs.append(TenantSpec(
            name=name, cfg=cfg, profile=prof or None,
            slots=args.slots, max_seq=args.max_seq,
            hbm_budget=budget,
            spill_granule=4096 if budget else None))
    for spec in specs:
        t = rt.add_tenant(spec)
        print(f"tenant {t.name}: slice={t.alloc.profile.name} "
              f"rect={t.alloc.rect} offloaded={list(t.plan.offloaded)} "
              f"partial={[n for n, _ in t.plan.partial]}")

    rng = np.random.default_rng(0)
    for spec in specs:
        rt.submit(spec.name, [
            Request(i, rng.integers(0, spec.cfg.vocab_size,
                                    size=rng.integers(4, 13)).astype(np.int32),
                    args.max_new)
            for i in range(args.requests)])
    report = rt.run()
    for name, row in report["tenants"].items():
        print(f"{name}: profile={row['profile']} tokens={row['tokens_out']} "
              f"tok/s={row['tok_per_s']:.1f} completed={row['completed']} "
              f"truncated={row['truncated']}")
    print(f"pod_utilization={report['pod_utilization']:.2f} "
          f"throttle={report['modeled']['throttle']:.2f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--tenants", default=None,
                    help="comma list of arch[:profile] — multi-tenant mode")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--offload-kv", action="store_true")
    ap.add_argument("--hbm-budget", type=int, default=None,
                    help="pin tenant 0's plan budget (bytes) to force offload")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--attn-impl", default=None, choices=("xla", "pallas"),
                    help="override the config's attention implementation")
    args = ap.parse_args()
    if args.tenants:
        run_multi(args)
    else:
        run_single(args)


if __name__ == "__main__":
    main()
