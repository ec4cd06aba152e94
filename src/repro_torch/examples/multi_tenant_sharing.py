"""Multi-tenant GPU-sharing scenario — the paper's §V/§VI story end-to-end.

Three tenants (LLM serving, SSM serving, MoE training) are placed on ONE pod:
reward-metric selection (α sweep), static partitioning, fine-grained offload
planning for the tenant that doesn't fit its slice, co-run throughput/energy
vs the serial baseline, and the power-cap throttling check.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_sharing

The reference's example on the port's pure-Python core (no tensors; the
modelled pod and its chips, not the card).
"""
from repro_torch.configs import get_config, get_shape
from repro_torch.core.cosched import corun_copies, mixed_tenancy
from repro_torch.core.hw import GiB, V5E_POD
from repro_torch.core.partitioner import StaticPartitioner
from repro_torch.core.reward import sweep
from repro_torch.core.slices import get_profile, profile_table
from repro_torch.core.workload import WorkloadEstimate


def main() -> None:
    print("=== slice profile table (paper Table II analogue) ===")
    for r in profile_table():
        print(f"  {r['profile']:10s} chips={r['chips']:4d} "
              f"hbm={r['hbm_gib']:6.0f}GiB host_bw={r['host_link_gbps']:5.0f}GB/s")

    tenants = {
        "llm-serve": WorkloadEstimate(get_config("llama3-8b"),
                                      get_shape("decode_32k")),
        "ssm-serve": WorkloadEstimate(get_config("mamba2-130m"),
                                      get_shape("decode_32k")),
        "moe-train": WorkloadEstimate(get_config("granite-moe-1b-a400m"),
                                      get_shape("train_4k")),
    }

    print("\n=== reward-driven placement (α = 0.1, ≤half-pod quota) ===")
    placement = {}
    for tag, wl in tenants.items():
        pts = [p for p in sweep(wl, alpha=0.1) if p.profile.n_chips <= 128]
        best = pts[0]
        placement[tag] = best.profile.name
        off = (f" +offload {best.plan.host_bytes / GiB:.0f}GiB->host"
               if best.plan and best.plan.host_bytes else "")
        print(f"  {tag:10s} footprint={wl.footprint_bytes() / GiB:6.0f}GiB "
              f"-> {best.profile.name}{off}  R={best.reward:.2f} "
              f"perf_rel={best.perf_rel:.2f}")

    print("\n=== packing the pod ===")
    part = StaticPartitioner()
    for tag, prof in placement.items():
        a = part.allocate(get_profile(prof), tag=tag)
        print(f"  {tag:10s} -> rect {a.rect}")
    part.validate()
    print(f"  pod utilization: {part.utilization() * 100:.0f}% "
          f"({part.free_chips()} chips free)")

    print("\n=== co-run economics ===")
    res = mixed_tenancy(tenants, placement)
    print(f"  makespan {res['makespan_s']:.2f}s  energy {res['energy_J'] / 1e6:.2f}MJ  "
          f"throttle_factor {res['throttle_factor']:.2f}")

    print("\n=== N-copies sharing table for the SSM tenant (Fig. 5/6) ===")
    for copies, prof in ((16, "1s.16c"), (4, "4s.64c"), (2, "8s.128c")):
        r = corun_copies(tenants["ssm-serve"], get_profile(prof), copies)
        if r:
            print(f"  {r.config:12s} tput_norm={r.throughput_norm:5.2f} "
                  f"energy_norm={r.energy_norm:4.2f} throttled={r.throttled}")


if __name__ == "__main__":
    main()
