"""SliceRuntime demo — two tenants served concurrently on one pod.

The paper's system, live on the real engine: a (reduced) Llama-3 tenant on
a 2s.32c slice whose HBM budget is pinned *below* its footprint — so the
offload planner spills the embedding table whole and a cold tail of the KV
pool to the host tier (paper §VI-A) — next to a GPT-2 tenant on a 1s.16c
slice that fits outright. The runtime packs both rectangles with
``StaticPartitioner``, drives both engines round-robin, and reports
per-tenant tokens/sec, pod utilization, and the modeled power/throttling
account of §V-B (the reference's model of the modelled pod, not the GPU).

    PYTHONPATH=src python -m repro_torch.examples.slice_runtime_demo [--device cpu]

On the CUDA device (the default) the spilled table lives in pinned host
memory and only the rows a step needs cross the host link.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.serving import Request, SliceRuntime, TenantSpec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    rt = SliceRuntime(device=args.device)

    # tenant A: llama3 on 2s.32c with a pinned HBM budget below footprint
    # (reduced-scale stand-in for "KV pool slightly exceeds the slice")
    llm_cfg = get_config("llama3-8b").reduced().with_(remat="none")
    rt.add_tenant(TenantSpec(
        "llm-serve", llm_cfg, profile="2s.32c", slots=4, max_seq=64,
        hbm_budget=380_000, spill_granule=4096))

    # tenant B: gpt2 on its own 1s.16c slice, fits without offloading
    gpt_cfg = get_config("gpt2-124m").reduced().with_(remat="none")
    rt.add_tenant(TenantSpec(
        "gpt2-serve", gpt_cfg, profile="1s.16c", slots=4, max_seq=32))

    print("=== placement & plans ===")
    for t in rt.tenants.values():
        print(f"  {t.name:10s} -> {t.alloc.profile.name} rect={t.alloc.rect} "
              f"offloaded={list(t.plan.offloaded)} "
              f"partial={[n for n, _ in t.plan.partial]} "
              f"host_bytes={t.plan.host_bytes}")
        split = t.engine.pool.split_leaves
        if split:
            print(f"  {'':10s}    cold-tail split: {split} "
                  f"(hot prefix length per leaf)")

    rng = np.random.default_rng(0)
    rt.submit("llm-serve", [
        Request(i, rng.integers(0, llm_cfg.vocab_size, size=8).astype(np.int32), 8)
        for i in range(8)])
    rt.submit("gpt2-serve", [
        Request(i, rng.integers(0, gpt_cfg.vocab_size, size=6).astype(np.int32), 6)
        for i in range(8)])

    report = rt.run()

    print("\n=== per-tenant serving report ===")
    for name, row in report["tenants"].items():
        print(f"  {name:10s} {row['profile']:8s} tokens={row['tokens_out']:4d} "
              f"tok/s={row['tok_per_s']:7.1f} completed={row['completed']} "
              f"truncated={row['truncated']} "
              f"kv_host/dev={row['kv_host_bytes']}/{row['kv_device_bytes']}")

    print(f"\npod utilization: {report['pod_utilization'] * 100:.0f}% "
          f"({report['free_chips']} chips free)")
    m = report["modeled"]
    print(f"modeled co-run (synthetic power calib.): "
          f"throttle={m['throttle']:.2f} "
          f"energy={m['energy_J'] / 1e3:.1f}kJ")


if __name__ == "__main__":
    main()
