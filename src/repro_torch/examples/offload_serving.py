"""Fine-grained CPU offloading for serving — paper §VI-A, executed for real.

A (reduced) Llama-3 is served twice: the KV pool resident in device memory,
then wholly in host memory (pinned, on the CUDA device), where each tick
copies it over the host link. Outputs must match exactly. On the CPU
(``--device cpu``) both tiers are host RAM, so the wall-time difference means
nothing there; on the card it is the link's price.

    PYTHONPATH=src python -m repro_torch.examples.offload_serving [--device cpu]

The reference's example raises at its offloaded run on this JAX (a gather on
a host-memory cache leaf); the port's runs and shows identical tokens.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.offload import inventory_from_tree, plan_offload
from repro_torch.models.model_zoo import build_model
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("llama3-8b").reduced()
    model = build_model(cfg, args.device)
    params, _ = model.init(torch.Generator(device=model.device).manual_seed(0))

    # what would the planner offload if the KV pool overflowed the slice?
    cache = model.cache_shapes(4, 128)
    inv = inventory_from_tree({"kv": cache})
    total = sum(t.bytes for t in inv)
    plan = plan_offload(inv, hbm_budget=total // 2)
    print(f"KV pool {total / 1024:.0f} KiB, budget {total // 2 / 1024:.0f} KiB "
          f"-> offloaded {plan.host_bytes / 1024:.0f} KiB "
          f"(fits={plan.fits}, traffic/step={plan.host_traffic_per_step / 1024:.1f} KiB)")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(4)]

    results = {}
    for offload in (False, True):
        eng = ServingEngine(model, params, slots=2, max_seq=64,
                            offload_kv=offload)
        kinds = eng.pool.memory_kinds()
        t0 = time.time()
        out = eng.run([Request(i, p, 6) for i, p in enumerate(prompts)])
        dt = time.time() - t0
        results[offload] = out
        print(f"offload_kv={offload!s:5s} memory_kinds={sorted(kinds)} "
              f"host_bytes={eng.pool.host_bytes} wall={dt:.2f}s "
              f"tokens={sum(len(v) for v in out.values())}")

    assert results[False] == results[True], "offloading changed results!"
    print("outputs identical with and without KV offloading ✓")


if __name__ == "__main__":
    main()
