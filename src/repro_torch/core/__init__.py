"""Core library of the port: the paper's contribution as composable modules.

- hw: chip / pod / host records of the *modelled* hardware families the
  planner and the performance model price (not the card the port runs on)
- slices: static slice profiles
- partitioner: StaticPartitioner over the modelled pod's chip grid
- offload: fine-grained host-offload planner and its placement on two tiers
- roofline: three-term roofline terms (``analyze`` waits for measured anchors)
- workload: analytic per-step estimates
- power: shared-power-cap throttling model
- reward: the paper's R-metric and config selector
- utilization: derived utilization metrics (paper IV)
- cosched: co-running throughput/energy simulator (paper V)
- perfmodel: the one performance engine (memoized scoring + progress-based
  PodSimulator) the serving runtime and the cluster scheduler go through
"""
from repro_torch.core.hw import V5E, V5E_POD, ChipSpec, PodSpec
from repro_torch.core.offload import OffloadPlan, TensorInfo, plan_offload
from repro_torch.core.partitioner import SliceAllocation, StaticPartitioner
from repro_torch.core.perfmodel import (Anchor, PerfModel, PerfScore,
                                        PodSimulator, get_model, load_anchors)
from repro_torch.core.reward import RewardPoint, select, sweep
from repro_torch.core.roofline import RooflineTerms, analyze, parse_collectives
from repro_torch.core.slices import PROFILES, SliceProfile, get_profile, profile_table
from repro_torch.core.workload import WorkloadEstimate

__all__ = [
    "V5E", "V5E_POD", "ChipSpec", "PodSpec",
    "OffloadPlan", "TensorInfo", "plan_offload",
    "SliceAllocation", "StaticPartitioner",
    "RewardPoint", "select", "sweep",
    "RooflineTerms", "analyze", "parse_collectives",
    "PROFILES", "SliceProfile", "get_profile", "profile_table",
    "WorkloadEstimate",
    "Anchor", "PerfModel", "PerfScore", "PodSimulator", "get_model",
    "load_anchors",
]
