"""Serving entry point: single-tenant continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --requests 16

Runs on the CUDA device unless ``--device cpu`` is given. ``--full-size``
serves the published widths and depth in bf16 weights; the default is the
reduced same-family config. ``--attn-impl pallas`` routes causal prefill
through the hand-written flash-attention kernel (the config value keeps the
reference's name), ``xla`` through the eager chunked version.

The multi-tenant mode (``--tenants``) belongs to the slice runtime, which is
not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model_zoo import build_model
from repro_torch.serving import Request, ServingEngine


def run_single(args) -> None:
    cfg = get_config(args.arch)
    if args.full_size:
        cfg = cfg.with_(remat="none", param_dtype="bfloat16")
    else:
        cfg = cfg.reduced()
    if args.attn_impl:
        cfg = cfg.with_(attn_impl=args.attn_impl)
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--tenants", default=None,
                    help="comma list of arch[:profile] — multi-tenant mode "
                         "(not ported yet)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--offload-kv", action="store_true")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--attn-impl", default=None, choices=("xla", "pallas"),
                    help="override the config's attention implementation")
    args = ap.parse_args()
    if args.tenants:
        sys.exit("--tenants needs the multi-tenant SliceRuntime, which the "
                 "port does not have yet (ROADMAP queue A item 7)")
    run_single(args)


if __name__ == "__main__":
    main()
